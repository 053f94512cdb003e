"""Synthetic toy dataset generation for tests and debug experiments.

The reference ships a real 100 m × 100 m classified LAS tile and builds a
3-split toy HDF5 from it (reference ``myria3d/pctl/dataset/toy_dataset.py``).
That tile is a missing large blob here, so we *synthesize* an equivalent:
a classified scene with ground, vegetation (codes 3/4/5), buildings, water,
a bridge, high structures (64) and artefact points (65), RGB+NIR colors —
exercising the full class-remapping/drop/feature pipeline.

Copied from ``myria3d_tpu/pctl/dataset/toy_dataset.py``; imports point at the port.
"""

from __future__ import annotations

import os

import numpy as np

from myria3d_tpu_torch.pctl.dataset.hdf5 import HDF5Dataset
from myria3d_tpu_torch.pctl.io.las import LasHeader, make_wkt_vlr_for_epsg, write_las

TOY_EPSG = "2154"
TOY_LAS_DATA = "tests/data/toy_dataset_src/862000_6652000.classified_toy_dataset.100mx100m.las"
TOY_DATASET_HDF5_PATH = "tests/data/toy_dataset.hdf5"

_X0, _Y0 = 862000.0, 6652000.0


def write_synthetic_toy_las(
    path: str, n_points: int = 60_000, extent: float = 100.0, seed: int = 42
) -> str:
    """Write a synthetic classified 100 m × 100 m LAS tile with RGB+NIR."""
    rng = np.random.default_rng(seed)

    n_ground = int(n_points * 0.45)
    n_veg = int(n_points * 0.25)
    n_bld = int(n_points * 0.15)
    n_water = int(n_points * 0.06)
    n_bridge = int(n_points * 0.03)
    n_high = int(n_points * 0.02)
    n_art = n_points - (n_ground + n_veg + n_bld + n_water + n_bridge + n_high)

    parts = []

    def mk(n, xr, yr, zr, cls):
        x = rng.uniform(*xr, n)
        y = rng.uniform(*yr, n)
        z = rng.uniform(*zr, n)
        c = np.full(n, cls, dtype=np.uint8)
        return x, y, z, c

    # ground: gentle slope
    gx = rng.uniform(0, extent, n_ground)
    gy = rng.uniform(0, extent, n_ground)
    gz = 0.02 * gx + 0.01 * gy + rng.normal(0, 0.05, n_ground)
    parts.append((gx, gy, gz, np.full(n_ground, 2, dtype=np.uint8)))
    # vegetation: clusters with codes 3/4/5 (medium/high/veg) to exercise remap
    vx = rng.uniform(0, extent, n_veg)
    vy = rng.uniform(0, extent, n_veg)
    vz = rng.uniform(0.5, 15.0, n_veg)
    vcls = rng.choice([3, 4, 5], n_veg).astype(np.uint8)
    parts.append((vx, vy, vz, vcls))
    # buildings: two boxes
    parts.append(mk(n_bld // 2, (10, 30), (10, 30), (6, 9), 6))
    parts.append(mk(n_bld - n_bld // 2, (60, 85), (55, 75), (9, 12), 6))
    # water: a pond
    parts.append(mk(n_water, (40, 55), (80, 95), (-0.2, 0.0), 9))
    # bridge over the pond
    parts.append(mk(n_bridge, (40, 55), (86, 89), (2.0, 2.5), 17))
    # high structures (antenna 160 -> remapped to 64)
    parts.append(mk(n_high, (90, 92), (5, 7), (0, 25), 160))
    # artefacts (65): scattered noise
    parts.append(mk(n_art, (0, extent), (0, extent), (-5, 50), 65))

    x = np.concatenate([p[0] for p in parts]) + _X0
    y = np.concatenate([p[1] for p in parts]) + _Y0
    z = np.concatenate([p[2] for p in parts])
    cls = np.concatenate([p[3] for p in parts])
    n = len(x)

    pts = np.zeros(
        n,
        dtype=np.dtype(
            [
                ("X", "<f8"), ("Y", "<f8"), ("Z", "<f8"),
                ("Intensity", "<u2"), ("ReturnNumber", "u1"),
                ("NumberOfReturns", "u1"), ("Classification", "u1"),
                ("GpsTime", "<f8"),
                ("Red", "<u2"), ("Green", "<u2"), ("Blue", "<u2"),
                ("Infrared", "<u2"),
            ]
        ),
    )
    pts["X"], pts["Y"], pts["Z"] = x, y, z
    pts["Intensity"] = rng.integers(0, 4000, n)
    nr = rng.integers(1, 4, n)
    pts["NumberOfReturns"] = nr
    pts["ReturnNumber"] = np.minimum(rng.integers(1, 4, n), nr)
    pts["Classification"] = cls
    # colors: vegetation greenish + high NIR, buildings grey, water dark
    base = rng.integers(5_000, 40_000, (n, 4))
    veg_mask = np.isin(cls, [3, 4, 5])
    base[veg_mask, 1] += 15_000  # green
    base[veg_mask, 3] += 20_000  # infrared
    water_mask = cls == 9
    base[water_mask] //= 4
    base = np.clip(base, 0, 65280)
    pts["Red"], pts["Green"] = base[:, 0], base[:, 1]
    pts["Blue"], pts["Infrared"] = base[:, 2], base[:, 3]

    header = LasHeader(
        version=(1, 4),
        point_format=8,
        scales=(0.01, 0.01, 0.01),
        offsets=(_X0, _Y0, 0.0),
    )
    header.vlrs.append(make_wkt_vlr_for_epsg(int(TOY_EPSG)))
    write_las(path, pts, header)
    return path


def make_toy_dataset_from_test_file(
    hdf5_path: str = TOY_DATASET_HDF5_PATH, las_path: str = TOY_LAS_DATA
) -> str:
    """Prepare a 3-split toy HDF5 from one small LAS file (reference
    ``toy_dataset.py:16-56``: tile_width=110, subtile_width=50)."""
    if os.path.isfile(hdf5_path):
        os.remove(hdf5_path)
    if not os.path.isfile(las_path):
        os.makedirs(os.path.dirname(las_path) or ".", exist_ok=True)
        write_synthetic_toy_las(las_path)

    HDF5Dataset(
        hdf5_path,
        TOY_EPSG,
        las_paths_by_split_dict={
            "train": [las_path],
            "val": [las_path],
            "test": [las_path],
        },
        tile_width=110,
        subtile_width=50,
        train_transform=None,
        eval_transform=None,
        pre_filter=None,
    )
    return hdf5_path


if __name__ == "__main__":
    os.makedirs(os.path.dirname(TOY_LAS_DATA), exist_ok=True)
    write_synthetic_toy_las(TOY_LAS_DATA)
    make_toy_dataset_from_test_file()
    print(f"Toy LAS: {TOY_LAS_DATA}\nToy HDF5: {TOY_DATASET_HDF5_PATH}")
