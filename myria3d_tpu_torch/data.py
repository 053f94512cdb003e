"""Datamodule feeding fixed-shape padded batches to the train/eval loops.

Re-design of reference ``myria3d/pctl/datamodule/hdf5.py:24-189`` without
Lightning. Transform lists compose per phase into validity-guarded
pipelines (train = preparations + normalizations + augmentations;
eval/predict = preparations + normalizations), the HDF5 cache is built
lazily once, and every loader comes out of one padded-loader factory with
bucketed point counts.

Copied from ``myria3d_tpu/pctl/datamodule/hdf5.py``; imports point at the
port. Every loader is sharded over the ranks of the process group, as in
the JAX package over its processes (``pctl/loader.py``). The datamodule
builds no predict loader: a tile's batches have one builder,
``predict.tile_loader``.
"""

from __future__ import annotations

from numbers import Number
from typing import Callable, Dict, List, Optional

from myria3d_tpu_torch.pctl.batching import DEFAULT_BUCKETS, bucket_ladder
from myria3d_tpu_torch.pctl.dataset.hdf5 import HDF5Dataset
from myria3d_tpu_torch.pctl.dataset.utils import (
    get_las_paths_by_split_dict,
    pre_filter_below_n_points,
)
from myria3d_tpu_torch.pctl.loader import PaddedBatchLoader
from myria3d_tpu_torch.pctl.transforms.compose import CustomCompose

TRANSFORMS_LIST = List[Callable]


class HDF5LidarDataModule:
    """Datamodule to feed train and validation data to the model."""

    def __init__(
        self,
        data_dir: Optional[str],
        split_csv_path: Optional[str],
        hdf5_file_path: str,
        epsg: Optional[str],
        points_pre_transform: Optional[Callable] = None,
        pre_filter: Optional[Callable] = pre_filter_below_n_points,
        tile_width: Number = 1000,
        subtile_width: Number = 50,
        subtile_overlap_train: Number = 0,
        subtile_overlap_predict: Number = 0,
        batch_size: int = 12,
        num_workers: int = 1,
        prefetch_factor: int = 2,
        transforms: Optional[Dict[str, TRANSFORMS_LIST]] = None,
        padded_num_points: Optional[int] = None,
        bucketing: bool = True,
        num_features: Optional[int] = None,
        **kwargs,
    ):
        self.split_csv_path = split_csv_path
        self.data_dir = data_dir
        self.hdf5_file_path = hdf5_file_path
        self.epsg = epsg
        self._dataset: Optional[HDF5Dataset] = None
        self.las_paths_by_split_dict = None

        self.points_pre_transform = points_pre_transform
        self.pre_filter = pre_filter

        self.tile_width = tile_width
        self.subtile_width = subtile_width
        self.subtile_overlap_train = subtile_overlap_train
        self.subtile_overlap_predict = subtile_overlap_predict

        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        # known feature width (model d_in): lets the process-sharded loader
        # synthesize filler batches even when a rank's FIRST group is
        # entirely None-filtered (multi-host robustness). The train
        # pipeline sets this from the model hparams when absent.
        self.num_features = num_features

        # phase → ordered transform stages, composed lazily below
        t = transforms or {}
        self._stages: Dict[str, TRANSFORMS_LIST] = {
            "train": list(t.get("preparations_train_list", [])),
            "eval": list(t.get("preparations_eval_list", [])),
            "predict": list(t.get("preparations_predict_list", [])),
            "normalize": list(t.get("normalizations_list", [])),
            "augment": list(t.get("augmentations_list", [])),
        }

        self.buckets = self._build_buckets(bool(bucketing), padded_num_points)

    # ------------------------------------------------------------------
    # Transforms
    # ------------------------------------------------------------------

    def _pipeline(self, phase: str) -> CustomCompose:
        stages = self._stages[phase] + self._stages["normalize"]
        if phase == "train":
            stages = stages + self._stages["augment"]
        return CustomCompose(stages)

    @property
    def train_transform(self) -> CustomCompose:
        return self._pipeline("train")

    @property
    def eval_transform(self) -> CustomCompose:
        return self._pipeline("eval")

    # Legacy attribute views (kept for callers/tests poking the raw lists)
    @property
    def preparation_train_transform(self) -> TRANSFORMS_LIST:
        return self._stages["train"]

    @property
    def preparation_eval_transform(self) -> TRANSFORMS_LIST:
        return self._stages["eval"]

    @property
    def preparation_predict_transform(self) -> TRANSFORMS_LIST:
        return self._stages["predict"]

    @property
    def normalization_transform(self) -> TRANSFORMS_LIST:
        return self._stages["normalize"]

    @property
    def augmentation_transform(self) -> TRANSFORMS_LIST:
        return self._stages["augment"]

    # ------------------------------------------------------------------
    # Padded-shape buckets
    # ------------------------------------------------------------------

    def _build_buckets(self, bucketing: bool, padded_num_points: Optional[int]):
        cap = padded_num_points or self._infer_point_cap() or DEFAULT_BUCKETS[-1]
        return bucket_ladder(cap, bucketing)

    def _infer_point_cap(self) -> Optional[int]:
        """Use the MaximumNumNodes/FixedPoints transform cap as the pad cap."""
        for phase in ("train", "eval", "predict"):
            for tr in self._stages[phase]:
                num = getattr(tr, "num", None)
                if num is not None and type(tr).__name__ in (
                    "MaximumNumNodes",
                    "FixedPoints",
                ):
                    return int(num)
        return None

    # ------------------------------------------------------------------
    # Dataset lifecycle
    # ------------------------------------------------------------------

    def prepare_data(self, stage: Optional[str] = None) -> None:
        """Build the HDF5 cache (process-0 work in multi-host setups)."""
        if stage in ("fit", "test", None) and self.split_csv_path and self.data_dir:
            self.las_paths_by_split_dict = get_las_paths_by_split_dict(
                self.data_dir, self.split_csv_path
            )
        self.dataset  # noqa: B018 — triggers the build

    def setup(self, stage: Optional[str] = None) -> None:
        self.dataset  # noqa: B018

    @property
    def dataset(self) -> HDF5Dataset:
        if self._dataset is None:
            self._dataset = HDF5Dataset(
                self.hdf5_file_path,
                self.epsg,
                las_paths_by_split_dict=self.las_paths_by_split_dict,
                points_pre_transform=self.points_pre_transform,
                tile_width=self.tile_width,
                subtile_width=self.subtile_width,
                subtile_overlap_train=self.subtile_overlap_train,
                pre_filter=self.pre_filter,
                train_transform=self.train_transform,
                eval_transform=self.eval_transform,
            )
        return self._dataset

    # ------------------------------------------------------------------
    # Loaders — one factory, three phases
    # ------------------------------------------------------------------

    def _loader(
        self,
        data,
        shuffle: bool = False,
        num_workers: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> PaddedBatchLoader:
        return PaddedBatchLoader(
            data,
            batch_size=self.batch_size,
            shuffle=shuffle,
            num_workers=self.num_workers if num_workers is None else num_workers,
            prefetch_factor=self.prefetch_factor,
            buckets=self.buckets,
            seed=seed,
            num_features=self.num_features,
        )

    def train_dataloader(self, seed: Optional[int] = None) -> PaddedBatchLoader:
        return self._loader(self.dataset.traindata, shuffle=True, seed=seed)

    def val_dataloader(self) -> PaddedBatchLoader:
        return self._loader(self.dataset.valdata)

    def test_dataloader(self) -> PaddedBatchLoader:
        return self._loader(self.dataset.testdata, num_workers=1)

    def _visualize_graph(self, data: dict, color: Optional[str] = None) -> None:
        """Debug 3-D scatter of one sample (reference ``_visualize_graph``,
        ``pctl/datamodule/hdf5.py:191-228``). Needs matplotlib (optional)."""
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            import warnings

            warnings.warn("matplotlib not available; cannot visualize sample")
            return
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        pos = data["pos"]
        c = data["y"] if color == "y" and "y" in data else None
        ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], s=1, c=c)
        plt.show()
