"""One pipeline from a LAS tile to cooked subtile samples.

The reference runs this loop twice with two different bodies — once in
``create_hdf5`` (``myria3d/pctl/dataset/hdf5.py:242-288``) and once in
its inference dataset's iterator (``myria3d/pctl/dataset/iterable.py:44-76``).
Here a single ``TileSampleStream`` owns the whole chain

    raw points → square subtiles → feature engineering
    (points_pre_transform) → pre_filter → [transform → pre_filter]

and both the offline HDF5 cache builder and predict's ``tile_loader``
iterate it. The per-subtile work (dominated by GridSampling in the
transform) can be mapped over a thread pool while preserving subtile order —
numpy/voxel code releases the GIL for its heavy parts, so inference prep
scales with host cores. The thread that feeds the pool only bins the tile
and hands out each subtile's indices; each worker builds its own subtile
from the tile's records (the Lidar HD features in one native call that
releases the GIL, where the records allow it).

Copied from ``myria3d_tpu/pctl/dataset/tile_stream.py``; imports point at the
port, and the subtiles are built in the pool. The JAX package's
pass-through subclass of it (``pctl/dataset/iterable.py``) has no copy:
predict's ``tile_loader`` builds this stream directly.
"""

from __future__ import annotations

import functools
import itertools
import queue
from concurrent.futures import ThreadPoolExecutor
from numbers import Number
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from myria3d_tpu_torch.pctl.dataset.utils import read_las_array_as_float32, subtile_indices
from myria3d_tpu_torch.utils.profiling import count, span


def _rows_form(pre_transform: Callable) -> Optional[Callable]:
    """The rows-taking form of ``pre_transform`` (its ``from_rows``), also
    through a ``functools.partial`` that binds no argument (as the
    configurations give the Lidar HD transform), or None."""
    while isinstance(pre_transform, functools.partial) and not (
        pre_transform.args or pre_transform.keywords
    ):
        pre_transform = pre_transform.func
    return getattr(pre_transform, "from_rows", None)


class TileSampleStream:
    """Iterable of cooked sample dicts from one LAS tile.

    Every yielded sample carries ``idx_in_original_cloud``; subtiles that
    die in ``pre_filter`` (before or after ``transform``) or whose
    ``transform`` returns None are dropped.
    """

    def __init__(
        self,
        las_path: str,
        epsg: Optional[str],
        tile_width: Number,
        subtile_width: Number,
        subtile_overlap: Number,
        points_pre_transform: Callable,
        pre_filter: Optional[Callable] = None,
        transform: Optional[Callable] = None,
        workers: int = 0,
        points: Optional[np.ndarray] = None,
        timings: Optional[dict] = None,
    ):
        self.las_path = las_path
        self.epsg = epsg
        self.tile_width = tile_width
        self.subtile_width = subtile_width
        self.subtile_overlap = subtile_overlap
        self.points_pre_transform = points_pre_transform
        self.pre_filter = pre_filter
        self.transform = transform
        self.workers = int(workers)
        self._points = points
        # receives the binning's and each subtile's cook seconds ("pctl.bin",
        # "pctl.cook") and the points cooked, in all and by ``from_rows``
        # ("cook_points", "cook_points_native")
        self.timings = timings

    # ------------------------------------------------------------------

    def _cook(self, item: Tuple[np.ndarray, np.ndarray]) -> Optional[dict]:
        """(the tile's points, a subtile's indices into them) → sample
        dict, or None when filtered out. A ``points_pre_transform`` with a
        rows-taking form (``from_rows(points, idx)``, None where it cannot
        take the records) builds the subtile from the tile's records in
        place; otherwise, or where it cannot, the subtile's rows are
        gathered and transformed."""
        points, idx = item
        with span("pctl.cook", self.timings):
            from_rows = _rows_form(self.points_pre_transform)
            data = from_rows(points, idx) if from_rows is not None else None
            if self.timings is not None:
                count(self.timings, "cook_points", len(idx))
                count(self.timings, "cook_points_native", 0 if data is None else len(idx))
            if data is None:
                data = self.points_pre_transform(np.take(points, idx))
            if data is None:
                return None
            data["idx_in_original_cloud"] = idx
            if self.pre_filter is not None and self.pre_filter(data):
                return None
            if self.transform is not None:
                data = self.transform(data)
                if data is None:
                    return None
                if self.pre_filter is not None and self.pre_filter(data):
                    return None
            return data

    def _subtiles(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(the tile's points, a subtile's indices) for every non-empty
        subtile. The tile is read (unless given) and binned at the first
        ``next()``, the binning in the span ``pctl.bin``."""
        points = self._points
        if points is None:
            points, _ = read_las_array_as_float32(self.las_path, self.epsg)
        with span("pctl.bin", self.timings):
            windows = subtile_indices(
                points, self.tile_width, self.subtile_width, self.subtile_overlap
            )
        for idx in windows:
            yield points, idx

    def __iter__(self) -> Iterator[dict]:
        if self.workers <= 0:
            for item in self._subtiles():
                sample = self._cook(item)
                if sample is not None:
                    yield sample
            return
        # Ordered thread-pool map with bounded in-flight work: keeps peak
        # memory at ~2x workers subtiles while later subtiles cook during
        # device compute upstream.
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            subtiles = self._subtiles()
            inflight: "queue.Queue" = queue.Queue()
            for item in itertools.islice(subtiles, 2 * self.workers):
                inflight.put(pool.submit(self._cook, item))
            while not inflight.empty():
                fut = inflight.get()
                nxt = next(subtiles, None)
                if nxt is not None:
                    inflight.put(pool.submit(self._cook, nxt))
                sample = fut.result()
                if sample is not None:
                    yield sample
