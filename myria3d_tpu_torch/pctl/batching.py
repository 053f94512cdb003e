"""Fixed-shape padded batching — the central TPU representational choice.

The reference feeds ragged pyg ``Batch`` objects in flattened ``(B*N, C)``
format with ``batch``/``ptr`` index vectors (reference
``myria3d/models/model.py:67-79``). XLA requires static shapes, so here
irregular clouds become padded ``(B, N, C)`` tensors with boolean validity
masks:

- per-sample point counts are bucketed to a small ladder of padded sizes
  (multiples of 128, MXU/VPU-lane friendly) to bound the number of distinct
  compiled shapes while wasting little padding compute;
- the batch dimension is always exactly ``batch_size`` — missing samples
  (end of epoch, filtered-out Nones) become fully-masked rows, preserving a
  single compiled executable per bucket.

Pad semantics: ``y`` pads with the artefact/ignore code 65 so the masked CE
loss and metrics ignore them; ``pos``/``x`` pad with zeros and are excluded
from kNN by the mask (see ``myria3d_tpu_torch.ops.knn``).

Copied from ``myria3d_tpu/pctl/batching.py``; imports point at the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

IGNORE_INDEX = 65

# Padded point-count ladder: multiples of 128 with ~2x growth.
DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 24576, 32768, 40960)
# Ladder for full (un-subsampled) subtile clouds used at eval/predict time.
DEFAULT_FULL_BUCKETS = (
    1024, 4096, 8192, 16384, 24576, 32768, 49152, 65536, 98304, 131072
)


# Growth quantum above the ladder top: coarse (one extra XLA compile per
# step) but never truncates — dense Lidar HD 50 m subtiles can exceed the
# top entry and the reference interpolates every point.
_OVERFLOW_QUANTUM = 16384


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    """Smallest ladder size >= n; grows past the top entry in coarse
    quanta instead of truncating (silent truncation dropped points'
    predictions entirely — ADVICE r1)."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return top + -(-(n - top) // _OVERFLOW_QUANTUM) * _OVERFLOW_QUANTUM


@dataclasses.dataclass
class PointCloudBatch:
    """A fixed-shape padded batch.

    Device arrays (static shapes):
        pos:  (B, N, 3) float32 — normalized positions
        x:    (B, N, F) float32 — features
        y:    (B, N)    int32   — targets (pad = 65)
        mask: (B, N)    bool    — True for real points

    Host metadata (ragged, stays off-device):
        idx_in_original_cloud: per-sample int arrays into the source cloud
        copies: per-sample dicts (pos_copy / pos_sampled_copy / transformed_y_copy)
        num_valid: (B,) true point counts; 0 marks an all-pad filler sample
    """

    pos: np.ndarray
    x: np.ndarray
    y: np.ndarray
    mask: np.ndarray
    num_valid: np.ndarray
    idx_in_original_cloud: List[Optional[np.ndarray]]
    copies: List[Dict[str, np.ndarray]]

    @property
    def batch_size(self) -> int:
        return self.pos.shape[0]

    @property
    def num_points(self) -> int:
        return self.pos.shape[1]

    def device_arrays(self) -> Dict[str, np.ndarray]:
        return {"pos": self.pos, "x": self.x, "y": self.y, "mask": self.mask}


def collate_padded(
    samples: List[Optional[dict]],
    batch_size: int,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    num_features: Optional[int] = None,
) -> Optional[PointCloudBatch]:
    """Collate sample dicts into one fixed-shape ``PointCloudBatch``.

    None samples are dropped (reference ``GeometricNoneProofCollater``,
    ``pctl/dataloader/dataloader.py:21-32``); an all-None list returns None.
    The batch dim is padded to exactly ``batch_size`` with all-masked rows.
    """
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    if len(samples) > batch_size:
        raise ValueError(f"Got {len(samples)} samples for batch_size {batch_size}")

    max_n = max(int(s["pos"].shape[0]) for s in samples)
    n_pad = bucket_size(max_n, buckets)
    if num_features is None:
        num_features = int(samples[0]["x"].shape[1]) if "x" in samples[0] else 3

    B = batch_size
    pos = np.zeros((B, n_pad, 3), dtype=np.float32)
    x = np.zeros((B, n_pad, num_features), dtype=np.float32)
    y = np.full((B, n_pad), IGNORE_INDEX, dtype=np.int32)
    mask = np.zeros((B, n_pad), dtype=bool)
    num_valid = np.zeros(B, dtype=np.int32)
    idx_list: List[Optional[np.ndarray]] = [None] * B
    copies: List[Dict[str, np.ndarray]] = [{} for _ in range(B)]

    for i, s in enumerate(samples):
        n = min(int(s["pos"].shape[0]), n_pad)
        pos[i, :n] = s["pos"][:n]
        if "x" in s and s["x"] is not None:
            x[i, :n] = s["x"][:n]
        if "y" in s and s["y"] is not None:
            y[i, :n] = s["y"][:n]
        mask[i, :n] = True
        num_valid[i] = n
        idx_list[i] = s.get("idx_in_original_cloud")
        copies[i] = s.get("copies", {})

    return PointCloudBatch(
        pos=pos, x=x, y=y, mask=mask, num_valid=num_valid,
        idx_in_original_cloud=idx_list, copies=copies,
    )


def filler_batch(
    batch_size: int, n_pad: int, num_features: int
) -> PointCloudBatch:
    """An all-masked batch: zero positions/features, ignore-coded targets,
    False masks. Emitted by the process-sharded loader when a rank's index
    group collates to nothing (every sample filtered to None) so that rank
    still joins the global step — collectives across processes must see the
    same number of batches on every rank."""
    B, n = int(batch_size), int(n_pad)
    return PointCloudBatch(
        pos=np.zeros((B, n, 3), np.float32),
        x=np.zeros((B, n, int(num_features)), np.float32),
        y=np.full((B, n), IGNORE_INDEX, np.int32),
        mask=np.zeros((B, n), bool),
        num_valid=np.zeros(B, np.int32),
        idx_in_original_cloud=[None] * B,
        copies=[{} for _ in range(B)],
    )


def pad_full_cloud(
    copies: List[Dict[str, np.ndarray]],
    buckets: Sequence[int] = DEFAULT_FULL_BUCKETS,
) -> Optional[Dict[str, Any]]:
    """Pad per-sample full-cloud copies for device-side eval interpolation.

    Returns dict with ``full_pos (B, M, 3)``, ``full_mask (B, M)``, and when
    present ``full_y (B, M)`` — or None when no sample carries copies.
    """
    lengths = [
        c["pos_copy"].shape[0] if "pos_copy" in c else 0 for c in copies
    ]
    if max(lengths, default=0) == 0:
        return None
    m_pad = bucket_size(max(lengths), buckets)
    B = len(copies)
    full_pos = np.zeros((B, m_pad, 3), dtype=np.float32)
    full_mask = np.zeros((B, m_pad), dtype=bool)
    have_y = any("transformed_y_copy" in c for c in copies)
    full_y = np.full((B, m_pad), IGNORE_INDEX, dtype=np.int32) if have_y else None
    sampled_lengths = [
        c["pos_sampled_copy"].shape[0] if "pos_sampled_copy" in c else 0 for c in copies
    ]
    for i, c in enumerate(copies):
        n = min(lengths[i], m_pad)
        if n == 0:
            continue
        full_pos[i, :n] = c["pos_copy"][:n]
        full_mask[i, :n] = True
        if full_y is not None and "transformed_y_copy" in c:
            full_y[i, :n] = c["transformed_y_copy"][:n]
    out: Dict[str, Any] = {
        "full_pos": full_pos,
        "full_mask": full_mask,
        "full_lengths": np.asarray(lengths, dtype=np.int32),
        "sampled_lengths": np.asarray(sampled_lengths, dtype=np.int32),
    }
    if full_y is not None:
        out["full_y"] = full_y
    return out


def pad_sampled_pos(
    copies: List[Dict[str, np.ndarray]], n_pad: int
) -> Optional[np.ndarray]:
    """(B, N, 3) unnormalized positions of the sampled points (pos_sampled_copy),
    padded to the batch's point bucket — source side of eval interpolation."""
    if not any("pos_sampled_copy" in c for c in copies):
        return None
    B = len(copies)
    out = np.zeros((B, n_pad, 3), dtype=np.float32)
    for i, c in enumerate(copies):
        if "pos_sampled_copy" not in c:
            continue
        n = min(c["pos_sampled_copy"].shape[0], n_pad)
        out[i, :n] = c["pos_sampled_copy"][:n]
    return out
