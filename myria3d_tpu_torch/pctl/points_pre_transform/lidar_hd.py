"""Lidar HD feature engineering: LAS named array → training sample dict.

Reproduces reference ``myria3d/pctl/points_pre_transform/lidar_hd.py:9-89``
(normalizations, occlusion zeroing, composite color, NDVI, d_in=9 feature
stack) on plain numpy dicts — the TPU pipeline's sample is
``{"pos": (N,3) f32, "x": (N,F) f32, "y": (N,) i64, "x_features_names": [...]}``.

Copied from ``myria3d_tpu/pctl/points_pre_transform/lidar_hd.py``; imports point at the port.
The copy's all-float32 column path is gone: ``lidar_hd_pre_transform_rows``,
the native rows-taking form, builds those records' features bit-equal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

COLORS_NORMALIZATION_MAX_VALUE = 255.0 * 256.0
RETURN_NUMBER_NORMALIZATION_MAX_VALUE = 7.0


def lidar_hd_pre_transform(points: np.ndarray) -> dict:
    """Turn a LAS named array (float32 fields) into a sample dict.

    Builds a composite (average) color channel and NDVI on the fly; zeroes
    colors of occluded points (ReturnNumber > 1); normalizes return counts by
    7 and colors by 255*256. Output features (when all colors present):
    Intensity, ReturnNumber, NumberOfReturns, Red, Green, Blue, Infrared,
    rgb_avg, ndvi → d_in = 9.
    """
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


def lidar_hd_pre_transform_rows(points: np.ndarray, idx: np.ndarray) -> Optional[dict]:
    """``lidar_hd_pre_transform(points[idx])``, bit for bit, built by one
    native call from the rows ``idx`` of the tile's records in place (no
    gather; the interpreter lock is released), or None where the native
    call cannot take the records (a missing field, a field type it does not
    read)."""
    from myria3d_tpu_torch.pctl.native import native_lidar_hd_rows

    built = native_lidar_hd_rows(points, idx)
    if built is None:
        return None
    pos, x, y, too_high = built
    for j, color in enumerate(("Red", "Green", "Blue", "Infrared")):
        assert not too_high >> j & 1, f"{color} max too high!"
    return {"pos": pos, "x": x, "y": y, "x_features_names": list(_X_NAMES)}


# the rows-taking form, which ``TileSampleStream`` builds its subtiles with
lidar_hd_pre_transform.from_rows = lidar_hd_pre_transform_rows
