"""Lidar HD feature engineering: LAS named array → training sample dict.

Reproduces reference ``myria3d/pctl/points_pre_transform/lidar_hd.py:9-89``
(normalizations, occlusion zeroing, composite color, NDVI, d_in=9 feature
stack) on plain numpy dicts — the TPU pipeline's sample is
``{"pos": (N,3) f32, "x": (N,F) f32, "y": (N,) i64, "x_features_names": [...]}``.

Copied from ``myria3d_tpu/pctl/points_pre_transform/lidar_hd.py``; imports point at the port.
"""

from __future__ import annotations

import numpy as np

COLORS_NORMALIZATION_MAX_VALUE = 255.0 * 256.0
RETURN_NUMBER_NORMALIZATION_MAX_VALUE = 7.0


def _columns_f32(points: np.ndarray):
    """(n, F) contiguous f32 matrix + name→column map when the record dtype
    is all-f32 packed (the ``read_las_array_as_float32`` contract), else
    None. One transposing copy replaces ~12 strided field extractions from
    the AoS records — the extraction pattern that dominated the per-subtile
    cook on 1-core hosts (docs/perf_notes.md round 5)."""
    dt = points.dtype
    names = dt.names or ()
    if not names or any(dt.fields[nm][0] != np.float32 for nm in names):
        return None, None
    if dt.itemsize != 4 * len(names):
        return None, None
    mat = np.ascontiguousarray(
        points.view(np.float32).reshape(points.shape[0], len(names)).T
    )
    return mat, {nm: i for i, nm in enumerate(names)}


def lidar_hd_pre_transform(points: np.ndarray) -> dict:
    """Turn a LAS named array (float32 fields) into a sample dict.

    Builds a composite (average) color channel and NDVI on the fly; zeroes
    colors of occluded points (ReturnNumber > 1); normalizes return counts by
    7 and colors by 255*256. Output features (when all colors present):
    Intensity, ReturnNumber, NumberOfReturns, Red, Green, Blue, Infrared,
    rgb_avg, ndvi → d_in = 9.
    """
    mat, col = _columns_f32(points)
    if mat is not None:
        return _pre_transform_columns(mat, col)
    pos = np.stack(
        [points["X"], points["Y"], points["Z"]], axis=1
    ).astype(np.float32)

    occluded_points = points["ReturnNumber"] > 1

    return_number = points["ReturnNumber"] / RETURN_NUMBER_NORMALIZATION_MAX_VALUE
    number_of_returns = points["NumberOfReturns"] / RETURN_NUMBER_NORMALIZATION_MAX_VALUE

    colors = {}
    for color in ["Red", "Green", "Blue", "Infrared"]:
        if color in (points.dtype.names or ()):
            channel = points[color].astype(np.float32)
            assert channel.size == 0 or channel.max() <= COLORS_NORMALIZATION_MAX_VALUE, (
                f"{color} max too high!"
            )
            channel = channel / COLORS_NORMALIZATION_MAX_VALUE
            channel[occluded_points] = 0.0
            colors[color] = channel
        else:
            colors[color] = np.zeros(points.shape[0], dtype=np.float32)

    rgb_avg = np.stack([colors["Red"], colors["Green"], colors["Blue"]], axis=1).mean(
        axis=1
    ).astype(np.float32)

    ndvi = (
        (colors["Infrared"] - colors["Red"])
        / (colors["Infrared"] + colors["Red"] + 1e-6)
    ).astype(np.float32)

    x_list = [points["Intensity"].astype(np.float32), return_number, number_of_returns]
    x_features_names = ["Intensity", "ReturnNumber", "NumberOfReturns"]
    for color in ["Red", "Green", "Blue", "Infrared"]:
        x_list.append(colors[color])
        x_features_names.append(color)
    x_list += [rgb_avg, ndvi]
    x_features_names += ["rgb_avg", "ndvi"]

    x = np.stack(x_list, axis=1).astype(np.float32)
    y = points["Classification"].astype(np.int64)

    return {
        "pos": pos,
        "x": x,
        "y": y,
        "x_features_names": list(x_features_names),
    }


_X_NAMES = [
    "Intensity", "ReturnNumber", "NumberOfReturns",
    "Red", "Green", "Blue", "Infrared", "rgb_avg", "ndvi",
]


def _pre_transform_columns(mat: np.ndarray, col: dict) -> dict:
    """Same math as the named-array path, on contiguous (F, n) columns:
    every op streams a cache-resident 1-D array, and ``x`` is assembled by
    row-writes into one preallocated (9, n) block (transposed at the end,
    matching ``np.stack``'s layout)."""
    n = mat.shape[1]
    pos = np.empty((n, 3), np.float32)
    pos[:, 0] = mat[col["X"]]
    pos[:, 1] = mat[col["Y"]]
    pos[:, 2] = mat[col["Z"]]

    rn = mat[col["ReturnNumber"]]
    occluded = rn > 1

    xb = np.empty((9, n), np.float32)
    xb[0] = mat[col["Intensity"]]
    np.divide(rn, np.float32(RETURN_NUMBER_NORMALIZATION_MAX_VALUE), out=xb[1])
    np.divide(mat[col["NumberOfReturns"]],
              np.float32(RETURN_NUMBER_NORMALIZATION_MAX_VALUE), out=xb[2])
    # true divisions, not reciprocal multiplies: 65280 and 7 are not powers
    # of two, and the named-array path divides — keep the features
    # bit-identical between the two paths (HDF5 stores them)
    for j, color in enumerate(("Red", "Green", "Blue", "Infrared")):
        if color in col:
            channel = mat[col[color]]
            assert channel.size == 0 or channel.max() <= COLORS_NORMALIZATION_MAX_VALUE, (
                f"{color} max too high!"
            )
            np.divide(channel, np.float32(COLORS_NORMALIZATION_MAX_VALUE),
                      out=xb[3 + j])
            xb[3 + j][occluded] = 0.0
        else:
            xb[3 + j] = 0.0
    # rgb_avg: (r+g)+b then /3 — the exact op sequence of
    # np.stack([...]).mean(axis=1) on f32 (umr_sum then true_divide)
    np.add(xb[3], xb[4], out=xb[7])
    np.add(xb[7], xb[5], out=xb[7])
    np.divide(xb[7], np.float32(3.0), out=xb[7])
    np.subtract(xb[6], xb[3], out=xb[8])
    denom = xb[6] + xb[3]
    denom += np.float32(1e-6)
    np.divide(xb[8], denom, out=xb[8])

    return {
        "pos": pos,
        "x": np.ascontiguousarray(xb.T),
        "y": mat[col["Classification"]].astype(np.int64),
        "x_features_names": list(_X_NAMES),
    }
