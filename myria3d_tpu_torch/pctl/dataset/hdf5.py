"""Map-style dataset + cache builder over the HDF5 sample store.

Same capability as the reference's ``myria3d/pctl/dataset/hdf5.py`` (cache
LAS subtiles once, then serve per-split samples with phase-routed
transforms, resuming interrupted preparation), rebuilt from different
parts: the h5py choreography lives in ``HDF5SampleStore``
(``pctl/dataset/store.py``), the subtile cooking pipeline in
``TileSampleStream`` (``pctl/dataset/tile_stream.py``), and this module
only composes them.

Copied from ``myria3d_tpu/pctl/dataset/hdf5.py``; imports point at the port,
and the multi-host barrier is the process group's (``parallel/ddp.py``).
"""

from __future__ import annotations

import os
from numbers import Number
from typing import Callable, List, Optional

from myria3d_tpu_torch.pctl.dataset.store import (
    TILE_ABSENT,
    TILE_PARTIAL,
    HDF5SampleStore,
)
from myria3d_tpu_torch.pctl.dataset.tile_stream import TileSampleStream
from myria3d_tpu_torch.pctl.dataset.utils import (
    LAS_PATHS_BY_SPLIT_DICT_TYPE,
    pre_filter_below_n_points,
)
from myria3d_tpu_torch.pctl.points_pre_transform.lidar_hd import lidar_hd_pre_transform


def create_hdf5(
    las_paths_by_split_dict: dict,
    hdf5_file_path: str,
    epsg: Optional[str],
    tile_width: Number = 1000,
    subtile_width: Number = 50,
    pre_filter: Optional[Callable] = pre_filter_below_n_points,
    subtile_overlap_train: Number = 0,
    points_pre_transform: Callable = lidar_hd_pre_transform,
) -> None:
    """Build (or resume building) the HDF5 sample cache.

    Per split, per LAS tile: complete tiles are skipped, interrupted ones
    dropped and redone, then the tile's sample stream is ingested
    (reference resume semantics, ``hdf5.py:229-240,290-293``).
    """
    store = HDF5SampleStore(hdf5_file_path)
    for split, las_paths in las_paths_by_split_dict.items():
        for las_path in las_paths:
            basename = os.path.basename(las_path)
            status = store.tile_status(split, basename)
            if status == TILE_PARTIAL:
                store.drop_tile(split, basename)
            elif status != TILE_ABSENT:
                continue
            stream = TileSampleStream(
                las_path,
                epsg,
                tile_width,
                subtile_width,
                subtile_overlap_train if split == "train" else 0,
                points_pre_transform or (lambda pts: None),
                pre_filter=pre_filter,
            )
            store.ingest_tile(split, basename, stream)


class HDF5Dataset:
    """Map-style view over the store with phase-routed transforms.

    ``train_transform`` applies to samples under ``train/``;
    ``eval_transform`` to ``val/`` and ``test/``. ``pre_filter`` runs both
    before and after the transform (a transform may empty a sample).
    """

    def __init__(
        self,
        hdf5_file_path: str,
        epsg: Optional[str],
        las_paths_by_split_dict: Optional[LAS_PATHS_BY_SPLIT_DICT_TYPE],
        points_pre_transform: Callable = lidar_hd_pre_transform,
        tile_width: Number = 1000,
        subtile_width: Number = 50,
        subtile_overlap_train: Number = 0,
        pre_filter: Optional[Callable] = pre_filter_below_n_points,
        train_transform: Optional[Callable] = None,
        eval_transform: Optional[Callable] = None,
    ):
        self.pre_filter = pre_filter
        self.train_transform = train_transform
        self.eval_transform = eval_transform
        self.store = HDF5SampleStore(hdf5_file_path)

        if las_paths_by_split_dict:
            # Data parallel: only rank 0 builds the cache (reference rank
            # guard, ``myria3d/pctl/datamodule/hdf5.py:104``); the others
            # open it after a barrier.
            from myria3d_tpu_torch.parallel import ddp

            if ddp.is_rank_zero():
                create_hdf5(
                    las_paths_by_split_dict, hdf5_file_path, epsg,
                    tile_width, subtile_width, pre_filter,
                    subtile_overlap_train, points_pre_transform,
                )
            ddp.barrier()
        elif not _file_exists(hdf5_file_path):
            raise FileNotFoundError(
                f"No LAS paths given and no precomputed HDF5 at {hdf5_file_path}"
            )
        self.store.sample_paths()  # build/load the index eagerly

    # -- mapping interface ------------------------------------------------

    def __len__(self) -> int:
        return len(self.store.sample_paths())

    def __getitem__(self, idx: int) -> Optional[dict]:
        path = self.store.sample_paths()[idx]
        data = self.store.read(path)
        if self.pre_filter and self.pre_filter(data):
            return None
        transform = (
            self.train_transform
            if path.startswith("train/")
            else self.eval_transform
        )
        if transform:
            data = transform(data)
        if data is None or (self.pre_filter and self.pre_filter(data)):
            return None
        return data

    # -- per-split views ----------------------------------------------------

    @property
    def samples_hdf5_paths(self) -> List[str]:
        return self.store.sample_paths()

    def _split_view(self, split: str) -> "Subset":
        prefix = f"{split}/"
        indices = [
            i
            for i, p in enumerate(self.store.sample_paths())
            if p.startswith(prefix)
        ]
        return Subset(self, indices)

    @property
    def traindata(self) -> "Subset":
        return self._split_view("train")

    @property
    def valdata(self) -> "Subset":
        return self._split_view("val")

    @property
    def testdata(self) -> "Subset":
        return self._split_view("test")


class Subset:
    """View over a subset of dataset indices (torch.utils.data.Subset-lite)."""

    def __init__(self, dataset, indices: List[int]):
        self.dataset = dataset
        self.indices = indices

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]

    def __len__(self) -> int:
        return len(self.indices)


def _file_exists(path: str) -> bool:
    return os.path.isfile(path)
