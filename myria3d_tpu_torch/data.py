"""The fit path's datamodule: the JAX package's ``HDF5LidarDataModule`` with
single-process loaders.

``myria3d_tpu.pctl`` (HDF5 cache, datasets, transforms, padded batching)
has no JAX in it, with two exceptions that this subclass routes around:
``PaddedBatchLoader`` asks ``jax.process_index()`` for its shard unless it
is given one (``pctl/loader.py:92``), and ``HDF5Dataset`` imports JAX when
it builds the cache from LAS files (``pctl/dataset/hdf5.py:98``). Here every
loader is told ``process_index=0, process_count=1``, and the cache is built
with ``create_hdf5`` before the dataset opens it.
"""

from __future__ import annotations

from typing import Optional

from myria3d_tpu.pctl.datamodule.hdf5 import HDF5LidarDataModule as _HDF5LidarDataModule
from myria3d_tpu.pctl.dataset.hdf5 import HDF5Dataset, create_hdf5
from myria3d_tpu.pctl.loader import PaddedBatchLoader


class HDF5LidarDataModule(_HDF5LidarDataModule):
    """Train/val loaders over the HDF5 sample cache, one process."""

    @property
    def dataset(self) -> HDF5Dataset:
        if self._dataset is None:
            if self.las_paths_by_split_dict:
                create_hdf5(
                    self.las_paths_by_split_dict, self.hdf5_file_path, self.epsg,
                    self.tile_width, self.subtile_width, self.pre_filter,
                    self.subtile_overlap_train, self.points_pre_transform,
                )
            self._dataset = HDF5Dataset(
                self.hdf5_file_path, self.epsg, las_paths_by_split_dict=None,
                points_pre_transform=self.points_pre_transform,
                tile_width=self.tile_width, subtile_width=self.subtile_width,
                subtile_overlap_train=self.subtile_overlap_train,
                pre_filter=self.pre_filter, train_transform=self.train_transform,
                eval_transform=self.eval_transform,
            )
        return self._dataset

    def _loader(self, data, shuffle: bool = False, num_workers: Optional[int] = None,
                seed: Optional[int] = None) -> PaddedBatchLoader:
        return PaddedBatchLoader(
            data, batch_size=self.batch_size, shuffle=shuffle,
            num_workers=self.num_workers if num_workers is None else num_workers,
            prefetch_factor=self.prefetch_factor, buckets=self.buckets, seed=seed,
            num_features=self.num_features, process_index=0, process_count=1,
        )
