"""A classified Lidar-HD-like tile with production GridSampling statistics.

``write_production_tile(path, n_points, extent)`` synthesizes the tile that
the whole-tile predict runs on (17.18 M points over 1000 m for a 1 km²
tile; a dense crop is the same function with more points over a smaller
extent). Copied from ``bench_e2e.py:29-96`` (``_ensure_tile``): the same
seed, site and return model, class mix and header (LAS 1.4, point format
8, an EPSG 2154 WKT VLR); it writes through the port's ``pctl/io/las.py``.
"""

from __future__ import annotations

import os
import time

import numpy as np

from myria3d_tpu_torch.pctl.io.las import LasHeader, make_wkt_vlr_for_epsg, write_las


def write_production_tile(path: str, n_points: int, extent: float) -> None:
    """Synthesize a classified tile with production GridSampling statistics.

    Spatially-uniform density (the toy generator's fixed-size blobs would
    concentrate >100k points in single subtiles at 1 km scale), emitted as
    ~17 pt/m² = ~4 overlapping flight strips sampling the same surface
    within scan/GPS noise (Lidar HD is >=10 pulses/m² with multi-strip
    overlap): each surface site is returned ~4x with ~2.5 cm jitter, so
    GridSampling(0.25) collapses the cloud to the reference-documented
    ~1/3 (reference docs/source/background/general_design.md:31,42 —
    ~30k raw -> ~12.5k sampled per 50 m subtile). A volumetrically-uniform
    cloud (``bench_e2e.py``'s first generation) defeats that collapse
    entirely and pushed every subtile into the 40k sampled bucket — ~3x
    the device work per raw point of the production distribution.

    An existing file at ``path`` is kept as it is."""
    if os.path.isfile(path):
        return
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    n = n_points
    returns_per_site = 4
    n_sites = -(-n // returns_per_site)
    pts = np.zeros(n, dtype=np.dtype([
        ("X", "<f8"), ("Y", "<f8"), ("Z", "<f8"),
        ("Intensity", "<u2"), ("ReturnNumber", "u1"),
        ("NumberOfReturns", "u1"), ("Classification", "u1"),
        ("GpsTime", "<f8"),
        ("Red", "<u2"), ("Green", "<u2"), ("Blue", "<u2"),
        ("Infrared", "<u2"),
    ]))
    x0, y0 = 862000.0, 6652000.0
    sx = rng.uniform(0, extent, n_sites)
    sy = rng.uniform(0, extent, n_sites)
    cls_s = rng.choice(
        np.array([2, 3, 4, 5, 6, 9, 17, 64, 65], np.uint8),
        n_sites,
        p=[0.45, 0.08, 0.08, 0.14, 0.15, 0.04, 0.015, 0.005, 0.04],
    )
    z_s = rng.uniform(0.0, 2.0, n_sites)
    z_s = np.where(np.isin(cls_s, [3, 4, 5]),
                   rng.uniform(0.5, 15.0, n_sites), z_s)
    z_s = np.where(cls_s == 6, rng.uniform(3.0, 12.0, n_sites), z_s)
    z_s = np.where(cls_s == 9, rng.uniform(-0.2, 0.0, n_sites), z_s)
    z_s = np.where(cls_s == 64, rng.uniform(0.0, 25.0, n_sites), z_s)
    rep = np.repeat(np.arange(n_sites), returns_per_site)[:n]
    pts["X"] = sx[rep] + x0 + rng.normal(0.0, 0.025, n)
    pts["Y"] = sy[rep] + y0 + rng.normal(0.0, 0.025, n)
    pts["Z"] = z_s[rep] + rng.normal(0.0, 0.025, n)
    cls = cls_s[rep]
    pts["Classification"] = cls
    pts["Intensity"] = rng.integers(0, 4000, n)
    nr = rng.integers(1, 4, n).astype(np.uint8)
    pts["NumberOfReturns"] = nr
    pts["ReturnNumber"] = np.minimum(rng.integers(1, 4, n), nr)
    rgb = rng.integers(5_000, 40_000, (n, 4))
    pts["Red"], pts["Green"] = rgb[:, 0], rgb[:, 1]
    pts["Blue"], pts["Infrared"] = rgb[:, 2], rgb[:, 3]
    header = LasHeader(
        version=(1, 4), point_format=8,
        scales=(0.01, 0.01, 0.01), offsets=(x0, y0, 0.0),
    )
    header.vlrs.append(make_wkt_vlr_for_epsg(2154))
    write_las(path, pts, header)
    print(f"# synthesized {n_points / 1e6:.1f} Mpt tile in "
          f"{time.perf_counter() - t0:.1f}s: {path}")
