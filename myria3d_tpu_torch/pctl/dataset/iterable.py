"""Streaming inference dataset over a single LAS file.

Same role as the reference ``InferenceDataset``
(``myria3d/pctl/dataset/iterable.py:16-76``) — yield transformed subtile
samples from one tile's exhaustive mosaic, keeping
``idx_in_original_cloud`` for the final full-cloud interpolation — but
implemented as a thin alias over the shared ``TileSampleStream`` pipeline,
with the per-subtile cooking (feature engineering + GridSampling-heavy
transform) mapped over a small thread pool.

Copied from ``myria3d_tpu/pctl/dataset/iterable.py``; imports point at the port.
"""

from __future__ import annotations

from numbers import Number
from typing import Callable, Iterator, Optional

from myria3d_tpu_torch.pctl.dataset.tile_stream import TileSampleStream
from myria3d_tpu_torch.pctl.dataset.utils import pre_filter_below_n_points
from myria3d_tpu_torch.pctl.points_pre_transform.lidar_hd import lidar_hd_pre_transform


class InferenceDataset(TileSampleStream):
    """Iterable of cooked subtile samples from one LAS file."""

    def __init__(
        self,
        las_file: str,
        epsg: Optional[str],
        points_pre_transform: Callable = lidar_hd_pre_transform,
        pre_filter: Optional[Callable] = pre_filter_below_n_points,
        transform: Optional[Callable] = None,
        tile_width: Number = 1000,
        subtile_width: Number = 50,
        subtile_overlap: Number = 0,
        workers: int = 3,
        points=None,
        timings=None,
    ):
        super().__init__(
            las_file,
            epsg,
            tile_width,
            subtile_width,
            subtile_overlap,
            points_pre_transform,
            pre_filter=pre_filter,
            transform=transform,
            workers=workers,
            points=points,
            timings=timings,
        )

    # kept for callers that iterate explicitly (reference API)
    def get_iterator(self) -> Iterator[dict]:
        return iter(self)
