"""K3: fused exact windowed k-NN + inverse-distance interpolation
(``csrc/interp.cu``) and its plain PyTorch version.

Replaces ``myria3d_tpu/ops/pallas_knn.py::knn_interpolate_pallas``
(kernels ``_interp_kernel_vpu_win_packed``, ``_interp_kernel_vpu_win``,
``_interp_kernel_vpu``): pyg ``knn_interpolate`` over the k nearest keys of
K1's windows, ``w = 1 / max(d2, 1e-16)`` on slots below the pad threshold,
``y = sum(w x) / max(sum(w), 1e-16)``. Queries whose slots all fell on pad
keys give 0; rows outside ``query_mask`` are zeroed. The payload is
gathered in f32 (the TPU kernel recombined in bf16).
"""

from __future__ import annotations

import torch

from myria3d_tpu_torch import _ext
from myria3d_tpu_torch.ops.cuda_knn import (
    TILE_Q,
    _check,
    _windows,
    knn_topk_plain,
    require_float4,
)
from myria3d_tpu_torch.ops.knn import VALID_THRESH


def idw_combine(feats, d2, valid, query_mask):
    """The pyg weighting of gathered neighbour rows ``feats (B, Nq, k, C)``:
    ``w = 1 / max(d2, 1e-16)`` on ``valid`` slots (0 elsewhere),
    ``sum(w x) / max(sum(w), 1e-16)``; rows outside ``query_mask`` zeroed."""
    w = torch.where(valid, 1.0 / d2.clamp(min=1e-16), 0.0)          # (B, Nq, k)
    num = (feats * w[..., None]).sum(dim=2)
    out = num / w.sum(dim=2, keepdim=True).clamp(min=1e-16)
    if query_mask is not None:
        out = torch.where(query_mask[..., None], out, 0.0)
    return out


def _interp_from_neighbors(x, idx, d2, query_mask):
    valid = d2 < VALID_THRESH
    b, _, c = x.shape
    rows = torch.where(valid, idx.to(torch.int64), 0).reshape(b, -1, 1)
    feats = torch.gather(x, 1, rows.expand(-1, -1, c)).view(*idx.shape, c)
    return idw_combine(feats, d2, valid, query_mask)


def knn_interp_plain(x: torch.Tensor, q4: torch.Tensor, k4: torch.Tensor, k: int,
                     window: int = 0, query_mask: torch.Tensor | None = None):
    """Plain PyTorch version of K3: K1's plain selection, then the pyg
    weighting over a gather of the payload rows."""
    idx, d2 = knn_topk_plain(q4, k4, k, window, query_mask)
    return _interp_from_neighbors(x, idx, d2, query_mask)


def knn_interp(x: torch.Tensor, q4: torch.Tensor, k4: torch.Tensor, k: int,
               window: int = 0, query_mask: torch.Tensor | None = None):
    """Interpolate the payload ``x (B, Nk, C)`` at the keys onto the
    queries: ``(B, Nq, C) float32``. ``q4``/``k4`` are centred and
    pad-augmented (``ops.knn.centred_clouds``). CPU tensors take
    :func:`knn_interp_plain`; CUDA tensors launch the kernel (or raise)."""
    if q4.device.type == "cpu":
        return knn_interp_plain(x, q4, k4, k, window, query_mask)
    _check(q4, k4, k)
    if x.dtype != torch.float32 or x.shape[:2] != k4.shape[:2]:
        raise ValueError("payload must be float32 (B, Nk, C)")
    qmask = None
    if query_mask is not None:
        qmask = query_mask.to(torch.uint8).contiguous()
        _ext.require_cuda("knn_interp", qmask)
    _ext.require_cuda("knn_interp", x, q4, k4)
    require_float4("knn_interp", q4, k4)
    b, nq, _ = q4.shape
    nk, c = x.shape[1], x.shape[2]
    out = torch.empty((b, nq, c), dtype=torch.float32, device=q4.device)
    if b * nq * c == 0:
        return out
    bases, win_len = _windows(q4, k4, window, query_mask)
    with torch.cuda.device(q4.device):
        code = _ext.lib().m3d_knn_interp(
            x.data_ptr(), q4.data_ptr(), k4.data_ptr(),
            None if bases is None else bases.data_ptr(),
            None if qmask is None else qmask.data_ptr(),
            b, nq, nk, -(-nq // TILE_Q), win_len, k, c,
            out.data_ptr(), _ext.stream_of(q4),
        )
    _ext.check(code, "m3d_knn_interp")
    knn_interp.launches += 1
    return out


knn_interp.launches = 0
