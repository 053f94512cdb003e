"""K9: one eval-mode Point Transformer vector-attention layer
(``csrc/vector_attention.cu``) and its plain PyTorch version.

Replaces no TPU kernel (the JAX package has no Point Transformer): it takes
the place of the torch composition of ``VectorAttention.forward``
(``models/modules/point_transformer.py``) at eval on the card. From ``q``,
``k``, ``v`` (B, N, C), the stage graph's ``idx`` and ``valid`` (B, N, K)
and offsets ``rel`` (B, N, K, 3), and the layer's parameters
(:class:`LayerParams`), it gathers the neighbours' k and v rows, builds the
position encoding and the weight MLP in shared memory, takes the masked
softmax over the K slots and writes only ``y`` (B, N, C). A query with no
valid slot gives 0.

The kernel repeats the torch composition's float32 operations in their
order (the Linears' sums, each eval BatchNorm's four steps, the softmax's
and the slot sum's orders: ``csrc/vector_attention.cu``), so it gives the
composition's values. Its BatchNorm constants are the running mean, ``inv
= rsqrt(running_var + eps)`` as ``MaskedBatchNorm`` computes it, the weight
and the bias; they are not folded into the Linears, which would move the
net's float16 logits off the reference's. :func:`pack` lays the parameters
out as the kernel reads them (``va::Params``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from myria3d_tpu_torch import _ext
from myria3d_tpu_torch.ops.knn import gather_rows

NEG = -1e30
# the kernel's instantiations: (C, N = C / s) -> the most slots K a query
WIDTHS = {(32, 4): 8, (64, 8): 16, (128, 16): 16, (256, 32): 16, (512, 64): 16}


class LayerParams(NamedTuple):
    """A layer's Linears and its eval BatchNorms' constants: each ``bn*`` is
    (4, width): running mean, rsqrt(running var + eps), weight and bias."""
    wp0: torch.Tensor    # (3, 3): linear_p[0]
    bp0: torch.Tensor
    bn0: torch.Tensor    # (4, 3)
    wp1: torch.Tensor    # (C, 3): linear_p[1]
    bp1: torch.Tensor
    bn1: torch.Tensor    # (4, C)
    w0: torch.Tensor     # (N, C): linear_w[0]
    b0: torch.Tensor
    bn2: torch.Tensor    # (4, N)
    w1: torch.Tensor     # (N, N): linear_w[1]
    b1: torch.Tensor


def layer_params(linear_p, linear_w, norms) -> LayerParams:
    """:class:`LayerParams` from a layer's ``linear_p``, ``linear_w`` and
    ``norms`` (``MaskedBatchNorm``s of widths 3, C and N)."""
    def bn(m):
        return torch.stack([m.running_mean, torch.rsqrt(m.running_var + m.eps), m.weight,
                            m.bias])

    (lp0, lp1), (lw0, lw1) = linear_p, linear_w
    return LayerParams(lp0.weight, lp0.bias, bn(norms[0]), lp1.weight, lp1.bias, bn(norms[1]),
                       lw0.weight, lw0.bias, bn(norms[2]), lw1.weight, lw1.bias)


def pack(p: LayerParams) -> torch.Tensor:
    """The kernel's flat float32 parameters: Linears' weights transposed
    but the first, each followed by its bias, and each BatchNorm's four."""
    parts = (p.wp0, p.bp0, p.bn0, p.wp1.T, p.bp1, p.bn1, p.w0.T, p.b0, p.bn2, p.w1.T, p.b1)
    return torch.cat([t.detach().float().reshape(-1) for t in parts]).contiguous()


def _bn(x, c):
    return (x - c[0]) * c[1] * c[2] + c[3]


def vector_attention_plain(q, k, v, idx, valid, rel, p: LayerParams) -> torch.Tensor:
    """Plain PyTorch version of K9: the layer's torch composition on
    :class:`LayerParams`."""
    r = F.linear(F.relu(_bn(F.linear(rel, p.wp0, p.bp0), p.bn0)), p.wp1, p.bp1)
    t = F.relu(_bn(gather_rows(k, idx) - q[:, :, None, :] + r, p.bn1))
    w = F.linear(F.relu(_bn(F.linear(t, p.w0, p.b0), p.bn2)), p.w1, p.b1)
    w = torch.where(valid[..., None], w, NEG).softmax(dim=2)
    w = torch.where(valid[..., None], w, 0.0)   # a query with no valid slot
    vr = gather_rows(v, idx) + r
    b, n, kk, c = vr.shape
    nw = w.shape[-1]
    return (vr.view(b, n, kk, c // nw, nw) * w.unsqueeze(3)).sum(dim=2).reshape(b, n, c)


def vector_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
                     valid: torch.Tensor, rel: torch.Tensor, p: LayerParams,
                     packed: torch.Tensor | None = None) -> torch.Tensor:
    """The layer's output ``y (B, N, C)`` float32.

    ``q``, ``k``, ``v`` (B, N, C) float32; ``idx`` (B, N, K) int32 indices
    into each cloud, ``valid`` (B, N, K) bool, ``rel`` (B, N, K, 3) float32;
    ``p`` the layer's parameters and ``packed`` their :func:`pack` where the
    caller keeps it. CPU tensors take :func:`vector_attention_plain`; CUDA
    tensors launch the kernel (or raise).
    """
    if q.device.type == "cpu":
        return vector_attention_plain(q, k, v, idx, valid, rel, p)
    b, n, c = q.shape
    kk = idx.shape[-1]
    nw = p.w1.shape[0]
    if kk > WIDTHS.get((c, nw), 0):
        raise ValueError(f"vector_attention: no instantiation in M3D_K9_WIDTHS "
                         f"(csrc/vector_attention.cu) runs (C, C/s) = ({c}, {nw}) with K={kk}; "
                         f"(C, C/s): most K are {WIDTHS}")
    if k.shape != q.shape or v.shape != q.shape or valid.shape != idx.shape \
            or rel.shape != (*idx.shape, 3) or idx.shape[:2] != (b, n):
        raise ValueError("vector_attention: q, k, v, idx, valid and rel shapes disagree")
    if any(t.dtype != torch.float32 for t in (q, k, v, rel)) or idx.dtype != torch.int32 \
            or valid.dtype != torch.bool:
        raise ValueError("vector_attention: q, k, v, rel float32, idx int32, valid bool")
    prm = _ext.aligned(pack(p) if packed is None else packed)   # read in 16-byte pieces
    q, k, v, idx, valid, rel = (t.contiguous() for t in (q, k, v, idx, valid, rel))
    _ext.require_cuda("vector_attention", q, k, v, idx, valid, rel, prm)
    y = torch.empty_like(q)
    if b * n == 0:
        return y
    with torch.cuda.device(q.device):
        code = _ext.lib().m3d_vector_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(), valid.data_ptr(),
            rel.data_ptr(), prm.data_ptr(), b, n, kk, c, nw, y.data_ptr(), _ext.stream_of(q))
    _ext.check(code, "m3d_vector_attention")
    vector_attention.launches += 1
    return y


vector_attention.launches = 0   # K9's launches
