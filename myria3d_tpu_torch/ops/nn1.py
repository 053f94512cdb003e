"""Nearest-neighbour (k=1) search for the decoder's upsampling.

Port of ``myria3d_tpu/ops/pallas_nn1.py:36``: the per-cloud centring and
pad augmentation of ``ops.knn`` around K1 with K=1 (exact within the
window, full scan when the window covers the keys).
"""

from __future__ import annotations

import torch

from myria3d_tpu_torch.ops.cuda_knn import knn_topk
from myria3d_tpu_torch.ops.knn import centred_clouds


def nearest_neighbor(query_pos: torch.Tensor, key_pos: torch.Tensor,
                     key_mask: torch.Tensor, window: int = 0,
                     query_mask: torch.Tensor | None = None):
    """Per-cloud nearest key of every query: ``(idx (B, Nq) int32,
    d2 (B, Nq) float32)``. Queries of a cloud with no valid key get
    d2 >= the pad threshold (the caller masks them)."""
    q4, k4 = centred_clouds(query_pos, key_pos, key_mask)
    idx, d2 = knn_topk(q4, k4, 1, window=window, query_mask=query_mask)
    return idx[..., 0], d2[..., 0]
