"""Tiling and LAS utilities for the host data layer.

Reimplements the reference's ``myria3d/pctl/dataset/utils.py`` semantics on
top of the self-contained LAS reader: mosaic of subtile centers (``:29-38``),
LAS read as float32 named array (``:41-62``), EPSG forcing/fallback logic
(``:76-102``), square subtile extraction (``:126-158``), split-CSV parsing
(``:165-183``).

The reference's scipy cKDTree Chebyshev ball query is replaced by a
vectorized sort-based bucketing: subtile extraction is a square crop in XY,
which a lexicographic binning computes in O(N log N) once per tile instead of
one KD-tree query per subtile.

Copied from ``myria3d_tpu/pctl/dataset/utils.py``; imports point at the port.
"""

from __future__ import annotations

import glob
import os
from numbers import Number
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from myria3d_tpu_torch.pctl.io.las import (
    LasHeader,
    has_srs,
    make_wkt_vlr_for_epsg,
    read_las,
    read_las_float32,
    read_las_header,
)

SPLIT_TYPE = str  # "train" | "val" | "test"
LAS_PATHS_BY_SPLIT_DICT_TYPE = Dict[str, List[str]]


def find_file_in_dir(data_dir: str, basename: str) -> str:
    """First file matching ``basename`` under ``data_dir`` (recursive)."""
    query = f"{data_dir}/**/{basename}"
    files = glob.glob(query, recursive=True)
    return files[0]


def get_mosaic_of_centers(
    tile_width: Number, subtile_width: Number, subtile_overlap: Number = 0
) -> List[np.ndarray]:
    """XY centers of the subtile mosaic covering a tile (reference ``utils.py:29-38``)."""
    if subtile_overlap < 0:
        raise ValueError("datamodule.subtile_overlap must be positive.")
    xy_range = np.arange(
        subtile_width / 2,
        tile_width + (subtile_width / 2) - subtile_overlap,
        step=subtile_width - subtile_overlap,
    )
    return [np.array([x, y]) for x in xy_range for y in xy_range]


def _enforce_epsg(header: LasHeader, epsg: Optional[str]) -> None:
    """The reference's EPSG contract (``utils.py:76-102``): an explicit
    ``epsg`` overrides the file SRS (like PDAL's override_srs); otherwise the
    file must carry one."""
    if epsg:
        code = str(epsg).split(":")[-1]
        if code.isdigit():
            header.vlrs = [
                v for v in header.vlrs if v.user_id != "LASF_Projection"
            ] + [make_wkt_vlr_for_epsg(int(code))]
    elif not has_srs(header):
        raise RuntimeError(
            "No EPSG provided, neither in the lidar file or as parameter"
        )


def read_las_array(las_path: str, epsg: Optional[str]) -> Tuple[np.ndarray, LasHeader]:
    """Read LAS as a named array (X/Y/Z float64), enforcing the EPSG
    contract. Returns (points, header)."""
    data = read_las(las_path)
    _enforce_epsg(data.header, epsg)
    return data.points, data.header


def read_las_array_as_float32(
    las_path: str, epsg: Optional[str]
) -> Tuple[np.ndarray, LasHeader]:
    """Read LAS as a named array with every dimension cast to float32
    (reference ``utils.py:57-62``) — single-pass cast straight from the
    packed records (``pctl/io/las.py::read_las_float32``)."""
    data = read_las_float32(las_path)
    _enforce_epsg(data.header, epsg)
    return data.points, data.header


def get_las_metadata(las_path: str) -> Dict:
    """Header metadata (count, bounds, srs) — replaces the reference's
    `pdal info --metadata` subprocess (``utils.py:105-120``)."""
    h = read_las_header(las_path)
    return {
        "count": h.point_count,
        "minx": h.mins[0], "miny": h.mins[1], "minz": h.mins[2],
        "maxx": h.maxs[0], "maxy": h.maxs[1], "maxz": h.maxs[2],
        "point_format": h.point_format,
        "version": ".".join(map(str, h.version)),
        "srs": has_srs(h),
    }


def _axis_window_membership(
    coord: np.ndarray, centers: np.ndarray, radius: float, stride: float
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Vectorized: which mosaic windows along one axis contain each point.

    Window k spans ``[centers[k] - radius, centers[k] + radius]`` (inclusive,
    like the reference's Chebyshev ball query). Candidate k come from integer
    division with ±1 slack, then each candidate is validated with the exact
    ``|coord - center| <= radius`` test so boundary behavior is bit-identical
    to the per-center scan.

    Returns (k_candidates (N, C) int64, valid (N, C) bool, C).
    """
    n_k = len(centers)
    first = centers[0]
    # smallest candidate k: floor() is <= the true ceil()-based k_min, so
    # starting there plus count slack +2 covers fp boundary cases
    k_lo = np.floor((coord - first - radius) / stride).astype(np.int64)
    c = int(np.floor(2 * radius / stride)) + 2
    ks = k_lo[:, None] + np.arange(c)[None, :]           # (N, C)
    in_range = (ks >= 0) & (ks < n_k)
    ks_safe = np.clip(ks, 0, n_k - 1)
    valid = in_range & (
        np.abs(coord[:, None] - centers[ks_safe]) <= radius
    )
    return ks_safe, valid, c


def subtile_indices(
    points: np.ndarray,
    tile_width: Number,
    subtile_width: Number,
    subtile_overlap: Number = 0,
) -> List[np.ndarray]:
    """Each non-empty square subtile's indices into ``points``, ascending,
    in x-major center order (views into one array, no copy).

    Semantics of reference ``utils.py:126-158``: centers from
    ``get_mosaic_of_centers`` relative to the cloud's XY min; a subtile is all
    points within Chebyshev radius ``subtile_width // 2`` of a center; empty
    subtiles are skipped.

    Unlike the reference's per-center cKDTree query (one full scan per
    center), membership is computed in a single pass: each point lists the
    few windows it falls in (1 with no overlap, 4 at overlap = width/2).
    The native counting sort reads X/Y from the records as they are (f32 or
    f64 fields); without it, one lexsort groups the (point, window) pairs.
    """
    if subtile_overlap < 0:
        raise ValueError("datamodule.subtile_overlap must be positive.")
    radius = subtile_width // 2
    stride = subtile_width - subtile_overlap
    centers_1d = np.arange(
        subtile_width / 2,
        tile_width + (subtile_width / 2) - subtile_overlap,
        step=stride,
    )
    n_k = len(centers_1d)

    from myria3d_tpu_torch.pctl.native import native_bin_windows_fields

    binned = native_bin_windows_fields(
        points, centers_1d, float(radius), float(stride)
    )
    if binned is not None:
        offsets, indices = binned
        return [indices[offsets[w]:offsets[w + 1]]
                for w in range(n_k * n_k) if offsets[w + 1] > offsets[w]]

    xy = np.stack([points["X"], points["Y"]], axis=1).astype(np.float64)
    xy_rel = xy - xy.min(axis=0)
    del xy
    # chunk the combo expansion so peak memory stays ~O(block * C^2)
    n = xy_rel.shape[0]
    block = 4_000_000
    win_parts: List[np.ndarray] = []
    pts_parts: List[np.ndarray] = []
    for s in range(0, n, block):
        sl = slice(s, min(s + block, n))
        kx, vx, cx = _axis_window_membership(
            xy_rel[sl, 0], centers_1d, radius, stride
        )
        ky, vy, cy = _axis_window_membership(
            xy_rel[sl, 1], centers_1d, radius, stride
        )
        nb = kx.shape[0]
        # (point, window-x, window-y) combos: flat window id, x-major to
        # match get_mosaic_of_centers order
        win = (kx[:, :, None] * n_k + ky[:, None, :]).reshape(nb, cx * cy)
        ok = (vx[:, :, None] & vy[:, None, :]).reshape(nb, cx * cy)
        point_idx = np.broadcast_to(
            np.arange(s, s + nb, dtype=np.int64)[:, None], win.shape
        )
        win_parts.append(win[ok])
        pts_parts.append(point_idx[ok])
    win_flat = np.concatenate(win_parts)
    pts_flat = np.concatenate(pts_parts)
    del win_parts, pts_parts
    if win_flat.size == 0:
        return []
    # group by window, points ascending within each window
    order = np.lexsort((pts_flat, win_flat))
    win_sorted = win_flat[order]
    pts_sorted = pts_flat[order]
    boundaries = np.flatnonzero(np.diff(win_sorted)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(win_sorted)]])
    return [pts_sorted[s:e] for s, e in zip(starts, ends)]


def split_cloud_into_samples(
    las_path: str,
    tile_width: Number,
    subtile_width: Number,
    epsg: Optional[str],
    subtile_overlap: Number = 0,
    points: Optional[np.ndarray] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (idx_in_original_cloud, sample_points) square subtiles
    (:func:`subtile_indices`), reading the tile as float32 records unless
    ``points`` is given."""
    if points is None:
        points, _ = read_las_array_as_float32(las_path, epsg)
    for sample_idx in subtile_indices(points, tile_width, subtile_width, subtile_overlap):
        yield sample_idx, np.take(points, sample_idx)


def pre_filter_below_n_points(data, min_num_nodes: int = 1) -> bool:
    """True → filter the sample out (reference ``utils.py:161-162``)."""
    return data["pos"].shape[0] < min_num_nodes


def get_las_paths_by_split_dict(
    data_dir: str, split_csv_path: str
) -> LAS_PATHS_BY_SPLIT_DICT_TYPE:
    """Parse the split CSV (basename, split) into per-split LAS path lists
    (reference ``utils.py:165-183``)."""
    import pandas as pd

    las_paths_by_split_dict: LAS_PATHS_BY_SPLIT_DICT_TYPE = {}
    split_df = pd.read_csv(split_csv_path)
    for phase in ["train", "val", "test"]:
        basenames = split_df[split_df.split == phase].basename.tolist()
        # files may live anywhere under data_dir (reference find_file_in_dir)
        las_paths_by_split_dict[phase] = [
            find_file_in_dir(data_dir, b) for b in basenames
        ]
    if not any(las_paths_by_split_dict.values()):
        raise FileNotFoundError(
            f"No basename found while parsing directory {data_dir} "
            f"using {split_csv_path} as split CSV."
        )
    return las_paths_by_split_dict
