"""K2: fused eval-mode LocalFeatureAggregation (``csrc/lfa.cu``) and its
plain PyTorch version.

Replaces ``myria3d_tpu/ops/pallas_lfa.py::lfa_attention_pallas``
(kernel ``_lfa_kernel``): gather ``pos_j``/``x_j``, build the LocSE
geometry ``[pos_i, pos_j, diff, |diff|]``, apply the encoder affine (Linear
and eval BatchNorm folded, ``A rel + c``) and LeakyReLU(0.2), concatenate
with ``x_j``, apply the bias-free attention matrix, take the masked softmax
over the K slots and the weighted sum. The output is the pooled
``(B, N, C)`` before the post-attention MLP. Neighbours are gathered by
direct f32 loads; no window is involved, so any neighbour graph works. The
attention product runs on the tensor cores in 3xTF32 (``csrc/lfa_tile.cuh``);
invalid slots reach the kernel as index -1.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from myria3d_tpu_torch import _ext
from myria3d_tpu_torch.ops.knn import gather_rows
from myria3d_tpu_torch.ops.masked import masked_softmax

MAX_K = 16
WIDTHS = (8, 16, 32, 64, 128, 256)   # the kernel's instantiations of C
_INFO_FIELDS = ("points_per_tile", "bands", "smem_bytes", "blocks_per_sm", "sms")


def read_launch_info(fn, c: int) -> dict:
    """What an info entry point (``m3d_lfa_info``, ``m3d_lfa_bwd_info``)
    reports at width ``c`` on the current CUDA device: points per tile,
    d(att_w) bands, dynamic shared memory bytes, blocks per SM and the
    device's SMs."""
    info = (ctypes.c_int * len(_INFO_FIELDS))()
    _ext.check(fn(c, ctypes.addressof(info)), fn.__name__)
    return dict(zip(_INFO_FIELDS, info))


def launch_info(c: int) -> dict:
    """K2's launch resources at width ``c`` (:func:`read_launch_info`)."""
    return read_launch_info(_ext.lib().m3d_lfa_info, c)


def idx_with_invalid(idx: torch.Tensor, neigh_valid: torch.Tensor) -> torch.Tensor:
    """The kernels' neighbour indices: int32, -1 at invalid slots."""
    return torch.where(neigh_valid, idx.to(torch.int32), -1).contiguous()


def lfa_attention_plain(x, pos, idx, neigh_valid, enc_a, enc_c, att_w):
    """Plain PyTorch version of K2 (channels-last edge tensors)."""
    pos_j = gather_rows(pos, idx)                                   # (B, N, K, 3)
    pos_i = pos[:, :, None, :].expand_as(pos_j)
    diff = pos_j - pos_i
    dist = (diff * diff).sum(dim=-1, keepdim=True).clamp(min=0.0).sqrt()
    rel = torch.cat([pos_i, pos_j, diff, dist], dim=-1)             # (B, N, K, 10)
    enc = F.leaky_relu(rel @ enc_a.T + enc_c, 0.2)
    lf = torch.cat([gather_rows(x, idx), enc], dim=-1)              # (B, N, K, C)
    att = lf @ att_w
    scores = masked_softmax(att, neigh_valid[..., None], dim=2)
    return (scores * lf).sum(dim=2)


def lfa_attention(x: torch.Tensor, pos: torch.Tensor, idx: torch.Tensor,
                  neigh_valid: torch.Tensor, enc_a: torch.Tensor,
                  enc_c: torch.Tensor, att_w: torch.Tensor,
                  idx_marked: torch.Tensor | None = None) -> torch.Tensor:
    """Attention-pooled LFA features ``(B, N, C)``, ``C = 2 * C_in``.

    ``x (B, N, C_in)``, ``pos (B, N, 3)``, ``idx (B, N, K)`` indices into
    each cloud, ``neigh_valid (B, N, K)``, ``enc_a (C_in, 10)``,
    ``enc_c (C_in,)``, ``att_w (C, C)`` with ``att = lf @ att_w``;
    ``idx_marked`` is ``idx_with_invalid(idx, neigh_valid)`` where the
    caller has it already. CPU tensors take :func:`lfa_attention_plain`;
    CUDA tensors launch the kernel (or raise).
    """
    if x.device.type == "cpu":
        return lfa_attention_plain(x, pos, idx, neigh_valid, enc_a, enc_c, att_w)
    b, n, c_in = x.shape
    k = idx.shape[-1]
    c = 2 * c_in
    if not (1 <= k <= MAX_K and c in WIDTHS):
        raise ValueError(f"lfa_attention: needs K <= {MAX_K} and 2*C_in in {WIDTHS}")
    if enc_a.shape != (c_in, 10) or enc_c.shape != (c_in,) or att_w.shape != (c, c):
        raise ValueError("lfa_attention: affine shapes do not match C_in")
    if any(t.dtype != torch.float32 for t in (x, pos, enc_a, enc_c, att_w)):
        raise ValueError("lfa_attention: float tensors must be float32")
    idx32 = idx_with_invalid(idx, neigh_valid) if idx_marked is None else idx_marked
    pos, enc_a, enc_c = (t.contiguous() for t in (pos, enc_a, enc_c))
    x, att_w = _ext.aligned(x), _ext.aligned(att_w)   # read in 16-byte pieces
    _ext.require_cuda("lfa_attention", x, pos, idx32, enc_a, enc_c, att_w)
    out = torch.empty((b, n, c), dtype=torch.float32, device=x.device)
    if b * n == 0:
        return out
    with torch.cuda.device(x.device):
        code = _ext.lib().m3d_lfa(
            x.data_ptr(), pos.data_ptr(), idx32.data_ptr(), enc_a.data_ptr(),
            enc_c.data_ptr(), att_w.data_ptr(), b, n, k, c_in, out.data_ptr(),
            _ext.stream_of(x),
        )
    _ext.check(code, "m3d_lfa")
    lfa_attention.launches += 1
    return out


lfa_attention.launches = 0
