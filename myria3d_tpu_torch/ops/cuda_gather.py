"""K4: neighbour gather whose backward is a deterministic scatter-add
kernel (``csrc/gather_bwd.cu``), and its plain PyTorch version.

Replaces ``myria3d_tpu/ops/pallas_gather.py::gather_neighbors_windowed``
(VJP kernel ``_scatter_kernel``). The forward is the direct row gather of
``payload (B, N, P)`` at ``idx (B, Nq, K)`` with ZEROS on invalid slots
(``pallas_gather.py:166-173``): downstream LFA math masks those slots
anyway, and the backward consistently drops their cotangents. The port
keeps channels last: ``(B, Nq, K, P)``.

The backward sums every slot's cotangent into the payload row it read. The
TPU kernel needed the query tile's sorted-key window to turn that scatter
into one-hot matmuls; the port needs no window. Instead the valid slots
are grouped by key once per neighbour graph (:func:`inverse_map`, a CSR
inverse of ``idx``) and the kernel sums each key's cotangents in ascending
slot order: no atomics on the sums, so gradients are bit-identical from
run to run, like K1-K3's outputs. The same inverse map serves every gather
of a block and the ``dx`` scatter of K6 (``gather_bwd.launches`` counts
both). On CUDA the map is built by the kernels of the same source (count,
fill, ordering of each range); :func:`inverse_map_plain` is a stable sort by key, and
the two give the same ``offsets`` and the same ``perm`` over every range.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from myria3d_tpu_torch import _ext
from myria3d_tpu_torch.ops.knn import gather_rows


class InverseMap(NamedTuple):
    """CSR inverse of a neighbour graph: ``perm`` lists the flat slot ids
    ``(b * Nq + i) * K + k`` grouped by key ``b * N + idx``, ascending
    within a key; key ``q`` owns ``perm[offsets[q]:offsets[q + 1]]``. The
    invalid slots are in no range: what ``perm`` holds from
    ``offsets[-1]`` on is unspecified."""

    perm: torch.Tensor     # (B * Nq * K,) int32
    offsets: torch.Tensor  # (B * N + 1,) int32


def inverse_map_plain(idx: torch.Tensor, neigh_valid: torch.Tensor, n_keys: int) -> InverseMap:
    """Plain PyTorch version of :func:`inverse_map`: a stable sort of the
    slots by key, the invalid ones last."""
    b = idx.shape[0]
    total = b * n_keys
    key = idx.long() + torch.arange(b, device=idx.device)[:, None, None] * n_keys
    key = torch.where(neigh_valid, key, total).reshape(-1)
    sorted_key, perm = torch.sort(key, stable=True)
    offsets = torch.searchsorted(sorted_key, torch.arange(total + 1, device=idx.device))
    return InverseMap(perm.to(torch.int32), offsets.to(torch.int32))


def inverse_map(idx: torch.Tensor, neigh_valid: torch.Tensor, n_keys: int) -> InverseMap:
    """The :class:`InverseMap` of ``idx (B, Nq, K)`` into ``n_keys`` keys per
    cloud; invalid slots are left out. CPU tensors take
    :func:`inverse_map_plain`; CUDA tensors launch the kernels (or raise).
    Valid slots must hold indices in ``[0, n_keys)``: the kernels leave any
    other out of the map, the plain version files it under a wrong key."""
    if idx.device.type == "cpu":
        return inverse_map_plain(idx, neigh_valid, n_keys)
    b = idx.shape[0]
    slots = idx[0].numel() if b else 0
    if b * max(slots, n_keys) >= 2**31 - 2:
        raise ValueError("inverse_map: slot and key ids must fit int32")
    idx32 = idx.to(torch.int32).contiguous()
    nv8 = neigh_valid.contiguous().view(torch.uint8)
    _ext.require_cuda("inverse_map", idx32, nv8)
    dev = idx.device
    # work[q + 2] counts key q; summed, work[q + 1] is q's first place, which
    # the fill moves to q + 1's: work[:-1] ends as the offsets
    work = torch.zeros(b * n_keys + 2, dtype=torch.int32, device=dev)
    perm = torch.empty(b * slots, dtype=torch.int32, device=dev)
    if b * slots == 0:
        return InverseMap(perm, work[:-1])
    unordered = torch.empty_like(perm)
    with torch.cuda.device(dev):
        lib, stream = _ext.lib(), _ext.stream_of(idx32)
        graph = (idx32.data_ptr(), nv8.data_ptr(), b, slots, n_keys, work.data_ptr())
        _ext.check(lib.m3d_inverse_map_count(*graph, stream), "m3d_inverse_map_count")
        work[2:].cumsum_(0)
        _ext.check(lib.m3d_inverse_map_fill(*graph, unordered.data_ptr(), perm.data_ptr(), stream),
                   "m3d_inverse_map_fill")
    inverse_map.launches += 1
    return InverseMap(perm, work[:-1])


inverse_map.launches = 0


def gather_neighbors_plain(payload: torch.Tensor, idx: torch.Tensor,
                           neigh_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4's op: the gather with zeros on invalid
    slots; its autograd backward is torch's scatter-add."""
    return torch.where(neigh_valid[..., None], gather_rows(payload, idx), 0.0)


def gather_bwd_plain(dout: torch.Tensor, idx: torch.Tensor, neigh_valid: torch.Tensor,
                     n_keys: int) -> torch.Tensor:
    """Plain PyTorch version of K4: ``dout (B, Nq, K, P)`` summed into
    ``(B, n_keys, P)`` rows at ``idx``, invalid slots dropped; 16-bit
    cotangents are summed in f32 and the sums cast back, as K4 does."""
    b, _, _, p = dout.shape
    out = torch.zeros((b, n_keys, p), dtype=torch.float32, device=dout.device)
    src = torch.where(neigh_valid[..., None], dout.float(), 0.0).reshape(b, -1, p)
    out.scatter_add_(1, idx.reshape(b, -1, 1).long().expand(-1, -1, p), src)
    return out.to(dout.dtype)


def gather_bwd(dout: torch.Tensor, idx: torch.Tensor, neigh_valid: torch.Tensor,
               inv: InverseMap | None, n_keys: int) -> torch.Tensor:
    """K4: ``(B, n_keys, P)`` sum of the slot cotangents ``dout (B, Nq, K,
    P)`` into the rows they were gathered from. CPU tensors take
    :func:`gather_bwd_plain`; CUDA tensors launch the kernel (or raise).

    The kernel's boundary is f32: 16-bit cotangents (a bfloat16 or float16
    payload's) are upcast, summed in f32 and the sums cast back to their
    dtype, finer than a scatter-add in the 16-bit dtype."""
    if dout.device.type == "cpu":
        return gather_bwd_plain(dout, idx, neigh_valid, n_keys)
    if inv is None:
        raise ValueError("gather_bwd: CUDA tensors need the inverse map")
    if dout.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError("gather_bwd: cotangents must be float32, bfloat16 or float16")
    b, p = dout.shape[0], dout.shape[-1]
    out = torch.empty((b, n_keys, p), dtype=torch.float32, device=dout.device)
    _launch_scatter(dout.float().contiguous(), inv, b * n_keys, p, out)
    return out.to(dout.dtype)


gather_bwd.launches = 0


def _launch_scatter(src: torch.Tensor, inv: InverseMap, n_keys: int, p: int,
                    out: torch.Tensor) -> None:
    """K4's kernel on slot-major rows ``src (..., P)`` into ``out (n_keys,
    P)``: :func:`gather_bwd`, and the ``dx`` scatter of K6."""
    _ext.require_cuda("gather_bwd", src, inv.perm, inv.offsets, out)
    if inv.offsets.numel() != n_keys + 1:
        raise ValueError("gather_bwd: the inverse map was built for another key count")
    if n_keys * p == 0:
        return
    with torch.cuda.device(src.device):
        code = _ext.lib().m3d_gather_bwd(
            src.data_ptr(), inv.perm.data_ptr(), inv.offsets.data_ptr(),
            n_keys, p, out.data_ptr(), _ext.stream_of(src),
        )
    _ext.check(code, "m3d_gather_bwd")
    gather_bwd.launches += 1


class _GatherNeighbors(torch.autograd.Function):
    @staticmethod
    def forward(ctx, payload, idx, neigh_valid, inv):
        ctx.save_for_backward(idx, neigh_valid)
        ctx.inv = inv
        ctx.n_keys = payload.shape[1]
        return gather_neighbors_plain(payload, idx, neigh_valid)

    @staticmethod
    def backward(ctx, dout):
        idx, neigh_valid = ctx.saved_tensors
        return gather_bwd(dout, idx, neigh_valid, ctx.inv, ctx.n_keys), None, None, None


def gather_neighbors(payload: torch.Tensor, idx: torch.Tensor, neigh_valid: torch.Tensor,
                     inv: InverseMap | None = None) -> torch.Tensor:
    """``(B, Nq, K, P)`` rows of ``payload (B, N, P)`` at ``idx (B, Nq, K)``,
    zero on invalid slots, differentiable w.r.t. ``payload``. On CUDA the
    backward is K4 over ``inv`` (``inverse_map(idx, neigh_valid, N)``); a
    CPU payload takes :func:`gather_neighbors_plain` and autograd."""
    if payload.device.type == "cpu":
        return gather_neighbors_plain(payload, idx, neigh_valid)
    if inv is None:
        inv = inverse_map(idx, neigh_valid, payload.shape[1])
    return _GatherNeighbors.apply(payload, idx, neigh_valid, inv)
