"""Masked k-nearest-neighbours over fixed-shape padded batches.

Port of ``myria3d_tpu/ops/knn.py``: per-cloud centring, the pad-key 4th
coordinate (pad keys sit ``PAD_W = 1e4`` away on a w axis, so their
squared distance carries +1e8 and no mask enters the search), and the
finalize step (``k_eff < k`` padding, invalid slots clamped to index 0,
``neigh_valid``). The search itself is K1 (``ops.cuda_knn.knn_topk``):
exact within the window, full-scan otherwise.
"""

from __future__ import annotations

import torch

from myria3d_tpu_torch.ops.cuda_knn import PAD_W, knn_topk

PAD_D2 = PAD_W * PAD_W
VALID_THRESH = 0.25 * PAD_D2


def cloud_offset(key_pos: torch.Tensor, key_mask: torch.Tensor) -> torch.Tensor:
    """(B, 1, 3) mean of each cloud's valid keys.

    Georeferenced inputs (Lambert-93, |Y| ~ 6.6e6 m) leave no f32 mantissa
    for metre-scale differences; subtracting a shared per-cloud offset keeps
    true differences and every term small (``knn.py:129-141``).
    """
    cnt = key_mask.sum(dim=1).clamp(min=1).to(key_pos.dtype)
    total = torch.where(key_mask[..., None], key_pos, 0.0).sum(dim=1)
    return (total / cnt[:, None])[:, None, :]


def augment_keys(kpos: torch.Tensor, kvalid: torch.Tensor) -> torch.Tensor:
    """(..., Nk, 3) -> (..., Nk, 4) with w = 0 (valid) or PAD_W (pad)."""
    w = torch.where(kvalid, 0.0, PAD_W).to(kpos.dtype)[..., None]
    return torch.cat([kpos, w], dim=-1).contiguous()


def augment_queries(qpos: torch.Tensor) -> torch.Tensor:
    """(..., Nq, 3) -> (..., Nq, 4) with w = 0."""
    return torch.cat([qpos, torch.zeros_like(qpos[..., :1])], dim=-1).contiguous()


def centred_clouds(query_pos, key_pos, key_mask):
    """Centred, pad-augmented (queries, keys) for K1 and K3."""
    offset = cloud_offset(key_pos, key_mask)
    return augment_queries(query_pos - offset), augment_keys(key_pos - offset, key_mask)


def knn(query_pos: torch.Tensor, key_pos: torch.Tensor, key_mask: torch.Tensor,
        k: int, query_mask: torch.Tensor | None = None, window: int = 0):
    """Masked kNN from queries into keys, per cloud.

    ``window > 0`` requires both clouds x-sorted (valid prefix ascending in
    x, ``pctl.transforms.SortPointsByX``).

    Returns ``idx (B, Nq, k) int32``, ``d2 (B, Nq, k) float32`` ascending and
    ``neigh_valid (B, Nq, k) bool`` (False for slots on pad keys, slots past
    the key count, and invalid queries).
    """
    k_eff = min(k, key_pos.shape[1])
    q4, k4 = centred_clouds(query_pos, key_pos, key_mask)
    idx, d2 = knn_topk(q4, k4, k_eff, window=window, query_mask=query_mask)
    return _finalize(idx, d2, k, k_eff, query_mask)


def _finalize(idx, d2, k, k_eff, query_mask):
    if k_eff < k:
        pad = k - k_eff
        idx = torch.nn.functional.pad(idx, (0, pad))
        d2 = torch.nn.functional.pad(d2, (0, pad), value=PAD_D2)
    neigh_valid = d2 < VALID_THRESH
    if query_mask is not None:
        neigh_valid = neigh_valid & query_mask[..., None]
    idx = torch.where(neigh_valid, idx, 0)  # clamp pad slots to a safe index
    return idx, d2, neigh_valid


def knn_graph(pos: torch.Tensor, mask: torch.Tensor, k: int, window: int = 0):
    """Self-kNN graph with self-loops (reference ``knn_graph(loop=True)``):
    each valid point's K nearest valid points, itself included."""
    return knn(pos, pos, mask, k, query_mask=mask, window=window)


def ball_query(query_pos: torch.Tensor, key_pos: torch.Tensor, key_mask: torch.Tensor,
               k: int, radius: float, query_mask: torch.Tensor | None = None):
    """Up to ``k`` nearest valid keys within ``radius`` of each query
    (PointNet++ grouping, ``knn.py:217-233``): the K nearest inside the
    ball, not the CUDA convention's first K found in scan order. K1's
    full-scan search, then the radius filter on its ``(B, Nq, k)`` result;
    slots outside the ball are invalid and clamped to index 0. Returns
    ``idx``, ``d2`` and ``neigh_valid`` as :func:`knn`."""
    idx, d2, neigh_valid = knn(query_pos, key_pos, key_mask, k, query_mask)
    neigh_valid = neigh_valid & (d2 <= radius * radius)
    return torch.where(neigh_valid, idx, 0), d2, neigh_valid


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, ...) -> (B, ..., C) rows of each cloud."""
    b, _, c = x.shape
    flat = idx.reshape(b, -1, 1).expand(-1, -1, c).to(torch.int64)
    return torch.gather(x, 1, flat).view(*idx.shape, c)
