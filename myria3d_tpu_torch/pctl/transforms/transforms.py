"""Host-side sample transforms on numpy dicts.

Numpy re-implementations of the reference transform library
(``myria3d/pctl/transforms/transforms.py``) plus the pyg transforms the
reference pulls from torch_geometric (GridSampling, Center, FixedPoints,
RandomFlip, RandomRotate). A *sample* is a dict with at least
``pos (N,3) f32``; optionally ``x (N,F) f32``, ``y (N,) i64``,
``x_features_names``, ``idx_in_original_cloud`` and ``copies``.

These run in the input pipeline (CPU workers), pre-padding — the device only
ever sees fixed-shape padded batches built by ``pctl.batching``.

Copied from ``myria3d_tpu/pctl/transforms/transforms.py``; imports point at the port.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

COMMON_CODE_FOR_ALL_ARTEFACTS = 65

# Keys that index per-point rows and must be subsampled together.
_SKIP_KEYS = ("copies", "idx_in_original_cloud", "x_features_names")


def subsample_data(data: dict, num_nodes: int, choice: np.ndarray) -> dict:
    """Index every per-point array by ``choice`` (bool mask or int indices),
    skipping copies / idx_in_original_cloud (reference ``transforms.py:30-45``)."""
    for key, item in list(data.items()):
        if key in _SKIP_KEYS:
            continue
        if isinstance(item, np.ndarray) and item.shape and item.shape[0] == num_nodes:
            data[key] = item[choice]
    return data


def num_nodes_of(data: dict) -> int:
    return int(data["pos"].shape[0])


class Transform:
    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.__class__.__name__}()"


class ToTensor(Transform):
    """No-op retained for config compatibility (arrays are already numpy)."""

    def __init__(self, keys: Optional[List[str]] = None):
        self.keys = keys or ["pos", "x", "y"]

    def __call__(self, data: dict) -> dict:
        return data


class MaximumNumNodes(Transform):
    """Random subsample down to at most ``num`` points (reference ``:48-61``)."""

    def __init__(self, num: int):
        self.num = num

    def __call__(self, data: dict) -> dict:
        num_nodes = num_nodes_of(data)
        if num_nodes <= self.num:
            return data
        choice = np.random.permutation(num_nodes)[: self.num]
        return subsample_data(data, num_nodes, choice)


class MinimumNumNodes(Transform):
    """Tile-with-repetition up to at least ``num`` points (reference ``:64-84``).

    Kept for strict reference parity; the TPU batching layer can alternatively
    satisfy the minimum via padding+masking (see ``pctl.batching``), which
    avoids duplicating real points.
    """

    def __init__(self, num: int):
        self.num = num

    def __call__(self, data: dict) -> dict:
        num_nodes = num_nodes_of(data)
        if num_nodes >= self.num:
            return data
        reps = math.ceil(self.num / num_nodes)
        choice = np.concatenate(
            [np.random.permutation(num_nodes) for _ in range(reps)]
        )[: self.num]
        return subsample_data(data, num_nodes, choice)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.__class__.__name__}({self.num})"


class FixedPoints(Transform):
    """Exactly ``num`` points by random choice, duplicating if needed
    (pyg ``FixedPoints(replace=False, allow_duplicates=True)`` as used in
    reference ``configs/.../fixed_num_points.yaml``)."""

    def __init__(self, num: int, replace: bool = False, allow_duplicates: bool = True):
        self.num = num
        self.replace = replace
        self.allow_duplicates = allow_duplicates

    def __call__(self, data: dict) -> dict:
        num_nodes = num_nodes_of(data)
        if self.replace:
            choice = np.random.randint(0, num_nodes, self.num)
        elif not self.allow_duplicates:
            choice = np.random.permutation(num_nodes)[: self.num]
        else:
            reps = math.ceil(self.num / max(num_nodes, 1))
            choice = np.concatenate(
                [np.random.permutation(num_nodes) for _ in range(reps)]
            )[: self.num]
        return subsample_data(data, num_nodes, choice)


class CopyFullPos:
    """Stash original positions for test/inference interpolation (reference ``:87-94``)."""

    def __call__(self, data: dict) -> dict:
        data.setdefault("copies", {})["pos_copy"] = data["pos"].copy()
        return data


class CopyFullPreparedTargets:
    """Stash full prepared targets for test-time full-cloud IoU (reference ``:97-104``)."""

    def __call__(self, data: dict) -> dict:
        data.setdefault("copies", {})["transformed_y_copy"] = data["y"].copy()
        return data


class CopySampledPos(Transform):
    """Stash (unnormalized) positions of subsampled points (reference ``:107-114``)."""

    def __call__(self, data: dict) -> dict:
        data.setdefault("copies", {})["pos_sampled_copy"] = data["pos"].copy()
        return data


class SortPointsByX(Transform):
    """Order points by their x coordinate — the locality layout behind the
    windowed Pallas kNN kernels (``ops/pallas_knn.py``, ``window=`` args).

    A 256-query tile of x-sorted points spans a thin x-slab; all its true
    kNN neighbors lie within a contiguous sorted-position window (measured
    ≥99.97 % capture at window 4608/40k — docs/perf_notes.md round 4), so
    the kernels scan ~9x fewer key chunks. Pure permutation: model outputs
    are identical up to float reordering, and the downstream scatter-merge
    is index-based, so output LAS files are unchanged.

    Both clouds are permuted consistently:
    - the sampled arrays (``pos``/``x``/``y`` + ``pos_sampled_copy``) by
      the current ``pos`` x;
    - the full-cloud stash (``pos_copy``/``transformed_y_copy``/
      ``idx_in_original_cloud``) by ``pos_copy`` x.

    Place LAST in the preparations list (after the Copy*Pos stashes);
    Center/NormalizePos after it are shared positive-affine maps, so the
    order survives them. No reference counterpart (reference kNN is
    order-independent torch_cluster).
    """

    def __call__(self, data: dict) -> dict:
        n = num_nodes_of(data)
        perm_s = np.argsort(data["pos"][:, 0], kind="stable")
        for key, item in list(data.items()):
            if key in _SKIP_KEYS:
                continue
            if isinstance(item, np.ndarray) and item.shape and item.shape[0] == n:
                data[key] = item[perm_s]
        copies = data.get("copies")
        if not copies:
            return data
        if (
            isinstance(copies.get("pos_sampled_copy"), np.ndarray)
            and copies["pos_sampled_copy"].shape[0] == n
        ):
            copies["pos_sampled_copy"] = copies["pos_sampled_copy"][perm_s]
        pos_copy = copies.get("pos_copy")
        if isinstance(pos_copy, np.ndarray) and pos_copy.ndim == 2:
            m = pos_copy.shape[0]
            perm_f = np.argsort(pos_copy[:, 0], kind="stable")
            copies["pos_copy"] = pos_copy[perm_f]
            if (
                isinstance(copies.get("transformed_y_copy"), np.ndarray)
                and copies["transformed_y_copy"].shape[0] == m
            ):
                copies["transformed_y_copy"] = copies["transformed_y_copy"][perm_f]
            idx = data.get("idx_in_original_cloud")
            if isinstance(idx, np.ndarray) and idx.shape[0] == m:
                data["idx_in_original_cloud"] = idx[perm_f]
        return data


class StandardizeRGBAndIntensity(Transform):
    """Standardize RGB-average and log(Intensity) per sample with 3σ clamping
    (reference ``:117-138``)."""

    def __call__(self, data: dict) -> dict:
        x = data["x"]
        names = data["x_features_names"]
        idx = names.index("Intensity")
        x[:, idx] = np.log(x[:, idx] + 1)
        x[:, idx] = self.standardize_channel(x[:, idx])
        idx = names.index("rgb_avg")
        x[:, idx] = self.standardize_channel(x[:, idx])
        return data

    @staticmethod
    def standardize_channel(channel_data: np.ndarray, clamp_sigma: int = 3) -> np.ndarray:
        mean = channel_data.mean()
        std = channel_data.std(ddof=1) + 1e-6
        if np.isnan(std):
            std = 1.0
        standard = (channel_data - mean) / std
        clamp = clamp_sigma * std
        return np.clip(standard, -clamp, clamp)


class NullifyLowestZ(Transform):
    """Set lowest z to 0 (reference ``:141-146``)."""

    def __call__(self, data: dict) -> dict:
        data["pos"][:, 2] = data["pos"][:, 2] - data["pos"][:, 2].min()
        return data


class NormalizePos(Transform):
    """Scale XY (and Z by the same factor) into [-1, 1] given the subtile
    width; expects XY centered on zero (reference ``:149-165``)."""

    def __init__(self, subtile_width: float = 50):
        self.scaling_factor = 1 / (subtile_width / 2)

    def __call__(self, data: dict) -> dict:
        data["pos"] = data["pos"] * self.scaling_factor
        return data


class Center(Transform):
    """Subtract the centroid from positions (pyg ``Center`` as composed in
    reference ``configs/.../points_budget.yaml``)."""

    def __call__(self, data: dict) -> dict:
        data["pos"] = data["pos"] - data["pos"].mean(axis=0, keepdims=True)
        return data


class GridSampling(Transform):
    """Voxel-grid pooling: pos/x mean per voxel, y majority vote
    (pyg ``GridSampling(0.25)`` as used in every reference transform list;
    semantics of torch_geometric.transforms.GridSampling).

    ``idx_in_original_cloud`` and ``copies`` are left untouched — they keep
    refering to the full (pre-sampling) subtile cloud.
    """

    def __init__(self, size: float):
        self.size = float(size)

    def __call__(self, data: dict) -> dict:
        pos = data["pos"]
        n = pos.shape[0]
        if n == 0:
            return data

        native = self._try_native(data)
        if native is not None:
            return native

        coords = np.floor((pos - pos.min(axis=0)) / self.size).astype(np.int64)
        # unique voxel ids; inverse maps point -> voxel slot
        _, inverse, counts = np.unique(
            coords, axis=0, return_inverse=True, return_counts=True
        )
        inverse = inverse.ravel()
        n_vox = len(counts)

        def voxel_mean(arr: np.ndarray) -> np.ndarray:
            if arr.ndim == 1:
                sums = np.zeros(n_vox, dtype=np.float64)
                np.add.at(sums, inverse, arr)
                return (sums / counts).astype(arr.dtype)
            sums = np.zeros((n_vox, arr.shape[1]), dtype=np.float64)
            np.add.at(sums, inverse, arr)
            return (sums / counts[:, None]).astype(arr.dtype)

        out = dict(data)
        out["pos"] = voxel_mean(pos)
        if "x" in data and isinstance(data["x"], np.ndarray):
            out["x"] = voxel_mean(data["x"])
        if "y" in data and isinstance(data["y"], np.ndarray) and data["y"].shape[:1] == (n,):
            y = data["y"].astype(np.int64)
            n_classes = int(y.max()) + 1 if len(y) else 1
            one_hot_counts = np.zeros((n_vox, n_classes), dtype=np.int64)
            np.add.at(one_hot_counts, (inverse, y), 1)
            out["y"] = one_hot_counts.argmax(axis=1)  # ties -> smallest code
        for key, item in data.items():
            if key in ("pos", "x", "y") or key in _SKIP_KEYS:
                continue
            if isinstance(item, np.ndarray) and item.shape and item.shape[0] == n:
                out[key] = voxel_mean(item.astype(np.float64)).astype(item.dtype)
        data.clear()
        data.update(out)
        return data

    def _try_native(self, data: dict) -> Optional[dict]:
        """C++ fast path (``pctl/native``) — same voxel order/semantics as
        the numpy implementation below; falls back on exotic inputs."""
        pos = data["pos"]
        n = pos.shape[0]
        x = data.get("x") if isinstance(data.get("x"), np.ndarray) else None
        y = data.get("y")
        has_y = (
            isinstance(y, np.ndarray) and y.shape[:1] == (n,)
            and y.size and y.min() >= 0 and y.max() < 256
        )
        extra = [
            key for key, item in data.items()
            if key not in ("pos", "x", "y") and key not in _SKIP_KEYS
            and isinstance(item, np.ndarray) and item.shape
            and item.shape[0] == n
        ]
        try:
            from myria3d_tpu_torch.pctl.native import native_grid_sample
        except Exception:
            return None
        res = native_grid_sample(pos, x, y if has_y else None, self.size)
        if res is None:
            return None
        out_pos, out_x, out_y, inverse = res
        out = dict(data)
        out["pos"] = out_pos.astype(pos.dtype)
        if x is not None and out_x is not None:
            out["x"] = out_x.astype(x.dtype)
        if has_y and out_y is not None:
            out["y"] = out_y.astype(y.dtype)
        n_vox = out_pos.shape[0]
        if extra:
            counts = np.bincount(inverse, minlength=n_vox).astype(np.float64)
            for key in extra:
                item = data[key]
                sums = np.zeros(
                    (n_vox,) + item.shape[1:], dtype=np.float64
                )
                np.add.at(sums, inverse, item.astype(np.float64))
                out[key] = (
                    sums / counts.reshape((-1,) + (1,) * (item.ndim - 1))
                ).astype(item.dtype)
        data.clear()
        data.update(out)
        return data


class TargetTransform(Transform):
    """Two-stage class-code remap (reference ``:168-232``):

    1. ``classification_preprocessing_dict`` maps raw codes to grouped codes;
    2. ``classification_dict`` maps grouped codes to consecutive indices,
       with code 65 (artefacts) preserved for later ``DropPointsByClass``.
    """

    def __init__(
        self,
        classification_preprocessing_dict: Dict[int, int],
        classification_dict: Dict[int, str],
    ):
        self.classification_dict = classification_dict
        self.classification_preprocessing_dict = classification_preprocessing_dict
        # Build a dense lookup table over the raw code space.
        mapper = {
            class_code: class_index
            for class_index, class_code in enumerate(classification_dict.keys())
        }
        mapper[COMMON_CODE_FOR_ALL_ARTEFACTS] = COMMON_CODE_FOR_ALL_ARTEFACTS
        max_code = max(
            [256]
            + list(classification_preprocessing_dict.keys())
            + list(classification_preprocessing_dict.values())
            + list(classification_dict.keys())
        )
        pre_lut = np.arange(max_code + 1, dtype=np.int64)
        for src, dst in classification_preprocessing_dict.items():
            pre_lut[src] = dst
        final_lut = np.full(max_code + 1, -1, dtype=np.int64)
        for src, dst in mapper.items():
            final_lut[src] = dst
        self._lut = final_lut[pre_lut]
        self._max_code = max_code

    def __call__(self, data: dict) -> dict:
        data["y"] = self.transform(data["y"])
        return data

    def transform(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y, dtype=np.int64)
        if len(y) and (y.max() > self._max_code or y.min() < 0):
            bad = np.unique(y[(y > self._max_code) | (y < 0)])
            raise ValueError(
                f"Unknown classification codes {bad.tolist()}; specify them in "
                "classification_dict or map them via classification_preprocessing_dict."
            )
        mapped = self._lut[y]
        if len(mapped) and (mapped < 0).any():
            bad = np.unique(y[mapped < 0])
            raise ValueError(
                f"Unknown classification codes {bad.tolist()}; specify them in "
                "classification_dict or map them via classification_preprocessing_dict."
            )
        return mapped


class DropPointsByClass(Transform):
    """Drop artefact points (code 65), including from idx_in_original_cloud
    (reference ``:235-248``). Returns the (possibly emptied) sample."""

    def __call__(self, data: dict) -> dict:
        y = data.get("y")
        if y is None:
            return data
        points_to_drop = y == COMMON_CODE_FOR_ALL_ARTEFACTS
        if points_to_drop.sum() > 0:
            points_to_keep = ~points_to_drop
            n = num_nodes_of(data)
            data = subsample_data(data, n, points_to_keep)
            if "idx_in_original_cloud" in data:
                data["idx_in_original_cloud"] = data["idx_in_original_cloud"][
                    points_to_keep
                ]
        return data


class RandomFlip(Transform):
    """Random flip along an axis with probability p (pyg ``RandomFlip``)."""

    def __init__(self, axis: int, p: float = 0.5):
        self.axis = axis
        self.p = p

    def __call__(self, data: dict) -> dict:
        if np.random.rand() < self.p:
            data["pos"][:, self.axis] = -data["pos"][:, self.axis]
        return data


class RandomRotate(Transform):
    """Random rotation within ±degrees around an axis (pyg ``RandomRotate``)."""

    def __init__(self, degrees: float, axis: int = 2):
        self.degrees = degrees
        self.axis = axis

    def __call__(self, data: dict) -> dict:
        angle = np.deg2rad(np.random.uniform(-self.degrees, self.degrees))
        c, s = np.cos(angle), np.sin(angle)
        if self.axis == 0:
            rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)
        elif self.axis == 1:
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)
        else:
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
        data["pos"] = data["pos"] @ rot.T
        return data
