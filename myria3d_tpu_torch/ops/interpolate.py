"""Masked kNN feature interpolation (inverse-squared-distance weighting).

Port of ``myria3d_tpu/ops/interpolate.py:27``: pyg ``knn_interpolate``
semantics, ``w = 1 / max(d2, 1e-16)``, ``y = sum(w x) / sum(w)``. Three
branches, as in the JAX package:

- ``k == 1`` (decoder upsampling): nearest key by K1, copy its row;
- ``fused_payload=True`` (the predict step's full-cloud k=10): K3;
- otherwise the two-op path: K1's neighbours, then the weighting in torch.

Queries whose slots all fell on pad keys give 0; rows outside ``tgt_mask``
are zeroed. The k=1 copy keeps the features' dtype; the weighted branches
return f32 (the decoders cast to their compute dtype; K3 takes f32 logits).
"""

from __future__ import annotations

import torch

from myria3d_tpu_torch.ops.cuda_interp import _interp_from_neighbors, knn_interp
from myria3d_tpu_torch.ops.knn import VALID_THRESH, centred_clouds, gather_rows, knn
from myria3d_tpu_torch.ops.nn1 import nearest_neighbor


def knn_interpolate(x: torch.Tensor, pos_src: torch.Tensor, src_mask: torch.Tensor,
                    pos_tgt: torch.Tensor, tgt_mask: torch.Tensor | None,
                    k: int = 3, fused_payload: bool = False,
                    window: int = 0) -> torch.Tensor:
    """Interpolate source features ``x (B, Ns, C)`` onto the target points:
    ``(B, Nt, C)``. ``window > 0`` requires x-sorted clouds."""
    if k == 1:
        idx1, d21 = nearest_neighbor(pos_tgt, pos_src, src_mask, window=window,
                                     query_mask=tgt_mask)
        valid1 = d21 < VALID_THRESH
        if tgt_mask is not None:
            valid1 = valid1 & tgt_mask
        out = gather_rows(x, torch.where(valid1, idx1, 0))
        return torch.where(valid1[..., None], out, 0.0)
    if fused_payload:
        q4, k4 = centred_clouds(pos_tgt, pos_src, src_mask)
        return knn_interp(x.contiguous(), q4, k4, min(k, pos_src.shape[1]),
                          window=window, query_mask=tgt_mask)
    idx, d2, neigh_valid = knn(pos_tgt, pos_src, src_mask, k,
                               query_mask=tgt_mask, window=window)
    return _interp_from_neighbors(x, idx, torch.where(neigh_valid, d2, VALID_THRESH),
                                  tgt_mask)
