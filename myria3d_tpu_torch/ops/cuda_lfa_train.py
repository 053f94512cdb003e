"""K5 + K6: the fused train-mode LocalFeatureAggregation (``csrc/lfa_train.cu``)
and the plain PyTorch versions of both kernels.

Port of ``myria3d_tpu/ops/pallas_lfa_train.py`` (``lfa_train_pallas``,
kernels ``_relstats_kernel`` and ``_lfa_bwd_kernel``). The LocSE encoder
``e = W_e rel + b_e`` is the only BatchNorm inside the LFA, and ``rel``
(the 10-channel geometry) depends on no parameter, so its masked batch
moments follow from the per-cloud second moments of ``[rel; 1]`` over the
valid slots (K5): ``mu = W_e r_bar + b_e``, ``var_c = w_c^T Cov(rel) w_c``.
With them the train-mode Linear -> BN chain folds to the affine that the
eval kernel K2 (``ops/cuda_lfa.py``) consumes, ``enc_a = gamma sigma^-1
W_e``, ``enc_c = gamma sigma^-1 (b_e - mu) + beta``, so the forward is K2.
The backward is K6 (recompute, then ``dx``, ``d(att_w)``, ``dgamma``,
``dbeta`` and the BN cross terms ``S1``, ``S2``, ``M1``); the chain rule
through the moments finishes here as ``_lfa_train_bwd`` does
(``pallas_lfa_train.py:468-579``): ``d_b_e = 0`` (a bias right before BN)
and ``pos`` gets no gradient. No ``(B, N, K, C)`` edge tensor is kept for
the backward.

Differences from the JAX kernels: positions and features are gathered by
direct f32 loads, not from the TPU's bf16 payload table, so the fused
route computes the same f32 function as the unfused one up to the raw
second-moment variance (``Cov = Srr / n - r_bar r_bar^T``, which the JAX
package also uses and which cancels when positions sit far from the
origin; the training transforms centre each cloud). The JAX package
computes the rel statistics in every LFA; they depend on the graph alone,
so here the two LFAs of a block share one K5 call (``lfa_train(...,
stats=...)``), as they share the inverse map and the marked indices, with
the same results bit for bit.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from myria3d_tpu_torch import _ext
from myria3d_tpu_torch.models.modules.nn import BN_EPS, LRELU_SLOPE
from myria3d_tpu_torch.ops.cuda_gather import InverseMap, _launch_scatter, gather_bwd_plain, inverse_map
from myria3d_tpu_torch.ops.cuda_lfa import WIDTHS, idx_with_invalid, lfa_attention, read_launch_info
from myria3d_tpu_torch.ops.knn import gather_rows
from myria3d_tpu_torch.ops.masked import masked_softmax

MAX_K = 16
N_SUMS = 14          # dgamma, dbeta, S1, S2, M1[10] per encoder channel
_RS_MIN_CHUNK_SLOTS = 1024            # the least a K5 block sums (8 slots a thread)
_RS_BLOCKS_PER_SM = 4                 # K5 blocks resident on an SM


def locse(pos: torch.Tensor, pos_j: torch.Tensor) -> torch.Tensor:
    """LocSE geometry ``(B, N, K, 10) = [pos_i, pos_j, pos_j - pos_i, |.|]``."""
    pos_i = pos[:, :, None, :].expand_as(pos_j)
    diff = pos_j - pos_i
    dist = (diff * diff).sum(dim=-1, keepdim=True).clamp(min=0.0).sqrt()
    return torch.cat([pos_i, pos_j, diff, dist], dim=-1)


def _check(name, pos, idx, *floats):
    if idx.shape[-1] > MAX_K:
        raise ValueError(f"{name}: needs K <= {MAX_K}")
    if any(t.dtype != torch.float32 for t in (pos, *floats)):
        raise ValueError(f"{name}: float tensors must be float32")


def _reduce_chunks(part: torch.Tensor) -> torch.Tensor:
    """``part (rows, n_chunks, E)`` (float32 or float64) summed over chunks in
    order, in float64: ``(rows, E)`` float32."""
    rows, n_chunks, e = part.shape
    out = torch.empty((rows, e), dtype=torch.float32, device=part.device)
    with torch.cuda.device(part.device):
        code = _ext.lib().m3d_reduce_chunks(part.data_ptr(), int(part.dtype == torch.float64),
                                            rows, n_chunks, e, out.data_ptr(),
                                            _ext.stream_of(part))
    _ext.check(code, "m3d_reduce_chunks")
    return out


# ---------------------------------------------------------------------------
# K5: rel statistics
# ---------------------------------------------------------------------------

def rel_stats_plain(pos: torch.Tensor, idx: torch.Tensor, neigh_valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: ``(B, 16, 16)`` per-cloud sums of
    ``z z^T``, ``z = [rel; 1]`` over the valid slots (row and column 10
    hold the sums of rel and the count; the rest is zero)."""
    rel = locse(pos, gather_rows(pos, idx))
    z = torch.cat([rel, torch.ones_like(rel[..., :1])], dim=-1)
    z = torch.where(neigh_valid[..., None], z, 0.0).reshape(pos.shape[0], -1, 11)
    out = torch.zeros((pos.shape[0], 16, 16), dtype=torch.float32, device=pos.device)
    out[:, :11, :11] = z.transpose(1, 2) @ z
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    """The device's SMs, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_tickets: dict = {}   # (device index, stream) -> K5's per-cloud tickets, zero between calls


def _rel_stats_tickets(device_index: int, stream: int, b: int) -> torch.Tensor:
    """K5's per-cloud arrival counters for the calls of one stream of a
    device: zeroed when they are made, and left at zero by every launch.
    Calls on one stream follow one another, so they can share them; calls
    on two streams may overlap, so each stream has its own."""
    t = _tickets.get((device_index, stream))
    if t is None or t.numel() < b:
        t = _tickets[device_index, stream] = torch.zeros(
            max(b, 64), dtype=torch.int32, device=torch.device("cuda", device_index))
    return t


def rel_stats(pos: torch.Tensor, idx: torch.Tensor, neigh_valid: torch.Tensor,
              idx_marked: torch.Tensor | None = None) -> torch.Tensor:
    """K5: per-cloud masked second moments of ``[rel; 1]``, ``(B, 16, 16)``.
    CPU tensors take :func:`rel_stats_plain`; CUDA tensors launch the
    kernel (or raise). ``idx_marked`` is ``idx_with_invalid(idx,
    neigh_valid)`` where the caller has it already (the train block does):
    the call is then one launch and two allocations, copies nothing from
    the host and never waits for the stream."""
    if pos.device.type == "cpu":
        return rel_stats_plain(pos, idx, neigh_valid)
    _check("rel_stats", pos, idx)
    b, n, k = idx.shape
    if n * k >= 2**31 - 1024:
        raise ValueError("rel_stats: a cloud's slots must fit int32")
    pos = pos.contiguous()
    if idx_marked is None:
        idx_marked = idx_with_invalid(idx, neigh_valid)
    _ext.require_cuda("rel_stats", pos, idx_marked)
    if idx_marked.dtype != torch.int32 or idx_marked.shape != idx.shape:
        raise ValueError("rel_stats: idx_marked must be idx's int32 copy")
    dev = pos.device
    if b * n * k == 0:
        return torch.zeros((b, 16, 16), dtype=torch.float32, device=dev)
    # chunks of a cloud's slots: enough blocks to fill the card's SMs at
    # every stage, none below the least chunk
    slots = n * k
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    blocks = _sm_count(index) * _RS_BLOCKS_PER_SM
    n_chunks = max(1, min(-(-blocks // b), slots // _RS_MIN_CHUNK_SLOTS))
    chunk_slots = -(-slots // n_chunks)
    n_chunks = -(-slots // chunk_slots)
    part = torch.empty((b, n_chunks, 66), dtype=torch.float32, device=dev)
    out = torch.empty((b, 16, 16), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = _ext.stream_of(pos)
        tickets = _rel_stats_tickets(index, stream, b)
        code = _ext.lib().m3d_relstats(pos.data_ptr(), idx_marked.data_ptr(), b, n, k, n_chunks,
                                       chunk_slots, part.data_ptr(), tickets.data_ptr(),
                                       out.data_ptr(), stream)
    _ext.check(code, "m3d_relstats")
    rel_stats.launches += 1
    return out


rel_stats.launches = 0


def moments(stats: torch.Tensor, w_e: torch.Tensor, b_e: torch.Tensor):
    """Masked batch moments of ``e = w_e rel + b_e`` (``w_e (C_in, 10)``)
    from the summed rel statistics (``pallas_lfa_train.py:416-427``):
    ``(mu, var_biased, n, sum_rel, srr)``."""
    s = stats.sum(dim=0)
    n = s[10, 10].clamp(min=1.0)
    sum_rel, srr = s[10, :10], s[:10, :10]
    r_bar = sum_rel / n
    mu = w_e @ r_bar + b_e
    cov = srr / n - torch.outer(r_bar, r_bar)
    var = torch.einsum("ci,ij,cj->c", w_e, cov, w_e).clamp(min=0.0)
    return mu, var, n, sum_rel, srr


# ---------------------------------------------------------------------------
# K6: the fused backward
# ---------------------------------------------------------------------------

def lfa_train_bwd_plain(x, pos, idx, neigh_valid, a_hat, c_hat, gamma, beta, att_w, gout):
    """Plain PyTorch version of K6 over ``(B, N, K, C)`` edge tensors:
    ``(dx (B, N, C_in), d_att_w (C, C), sums (C_in, 14))`` with the sums
    ``[dgamma, dbeta, S1, S2, M1 (10)]`` per encoder channel."""
    c_in = x.shape[-1]
    valid = neigh_valid[..., None]
    rel = locse(pos, gather_rows(pos, idx))
    ehat = rel @ a_hat.T + c_hat
    u = gamma * ehat + beta
    lf = torch.where(valid, torch.cat([gather_rows(x, idx), F.leaky_relu(u, LRELU_SLOPE)], -1), 0.0)
    s = masked_softmax(lf @ att_w, valid, dim=2)
    pooled = (s * lf).sum(dim=2, keepdim=True)
    g = gout[:, :, None, :]
    d_att = s * (g * lf - g * pooled)
    d_lf = g * s + d_att @ att_w.T
    d_att_w = torch.einsum("bnki,bnko->io", lf, d_att)
    dx = gather_bwd_plain(d_lf[..., :c_in], idx, neigh_valid, x.shape[1])
    du = torch.where(valid, d_lf[..., c_in:] * torch.where(u >= 0.0, 1.0, LRELU_SLOPE), 0.0)
    de = gamma * du
    dims = (0, 1, 2)
    sums = torch.stack([(du * ehat).sum(dims), du.sum(dims), de.sum(dims),
                        (de * ehat).sum(dims)], dim=1)
    m1 = torch.einsum("bnkc,bnkr->cr", de, rel)
    return dx, d_att_w, torch.cat([sums, m1], dim=1)


def bwd_launch_info(c: int) -> dict:
    """K6's launch resources at width ``c`` on the current CUDA device, as
    :func:`ops.cuda_lfa.launch_info` reads K2's (read once per device on
    the C side)."""
    return read_launch_info(_ext.lib().m3d_lfa_bwd_info, c)


def lfa_train_bwd(x, pos, idx, neigh_valid, inv: InverseMap | None, a_hat, c_hat, gamma,
                  beta, att_w, gout, idx_marked: torch.Tensor | None = None):
    """K6: the fused LFA backward, see :func:`lfa_train_bwd_plain` for the
    outputs. ``a_hat (C_in, 10)``, ``c_hat`` are the BN-normalized encoder
    affine (``ehat = a_hat rel + c_hat``), ``att_w (C, C)`` with ``att = lf
    att_w``, ``gout (B, N, C)`` the pooled output's cotangent; ``inv`` the
    graph's inverse map (:func:`ops.cuda_gather.inverse_map`) for the
    ``dx`` scatter (K4's kernel); ``idx_marked`` is ``idx_with_invalid(idx,
    neigh_valid)`` where the caller has it already. CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return lfa_train_bwd_plain(x, pos, idx, neigh_valid, a_hat, c_hat, gamma, beta,
                                   att_w, gout)
    b, n, c_in = x.shape
    k = idx.shape[-1]
    c = 2 * c_in
    if c not in WIDTHS:
        raise ValueError(f"lfa_train_bwd: needs 2*C_in in {WIDTHS}")
    _check("lfa_train_bwd", pos, idx, x, a_hat, c_hat, gamma, beta, att_w, gout)
    if inv is None:
        raise ValueError("lfa_train_bwd: CUDA tensors need the inverse map")
    if idx_marked is None:
        idx_marked = idx_with_invalid(idx, neigh_valid)
    args = [_ext.aligned(x), pos.contiguous(), idx_marked] + [
        t.contiguous() for t in (a_hat, c_hat, gamma, beta)] + [
        _ext.aligned(att_w), gout.contiguous()]
    _ext.require_cuda("lfa_train_bwd", *args)
    dev = x.device
    if b * n == 0:
        return (torch.zeros((b, n, c_in), device=dev), torch.zeros((c, c), device=dev),
                torch.zeros((c_in, N_SUMS), device=dev))
    dx = torch.empty((b, n, c_in), dtype=torch.float32, device=dev)   # the scatter writes it all
    with torch.cuda.device(dev):
        info = bwd_launch_info(c)
        # one chunk of tiles per resident block (blocks per SM x SMs), each
        # band of d(att_w) columns over the same chunks
        tiles = -(-b * n // info["points_per_tile"])
        n_chunks = max(1, min(tiles, info["blocks_per_sm"] * info["sms"]))
        dxj = torch.empty((b, n, k, c_in), dtype=torch.float32, device=dev)
        dw_part = torch.empty((1, n_chunks, c * c), dtype=torch.float32, device=dev)
        sc_part = torch.empty((1, n_chunks, c_in * N_SUMS), dtype=torch.float64, device=dev)
        code = _ext.lib().m3d_lfa_bwd(
            *(t.data_ptr() for t in args), b, n, k, c_in, n_chunks,
            dxj.data_ptr(), dw_part.data_ptr(), sc_part.data_ptr(), _ext.stream_of(x),
        )
    _ext.check(code, "m3d_lfa_bwd")
    d_att_w = _reduce_chunks(dw_part).view(c, c)
    sums = _reduce_chunks(sc_part).view(c_in, N_SUMS)
    _launch_scatter(dxj, inv, b * n, c_in, dx)
    lfa_train_bwd.launches += 1
    return dx, d_att_w, sums


lfa_train_bwd.launches = 0


class _LFATrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pos, idx, neigh_valid, w_e, b_e, gamma, beta, att_weight, inv, stats,
                idx_marked):
        if stats is None:
            stats = rel_stats(pos, idx, neigh_valid, idx_marked)
        mu, var, n, sum_rel, srr = moments(stats, w_e, b_e)
        inv_sigma = torch.rsqrt(var + BN_EPS)
        a_hat = inv_sigma[:, None] * w_e
        c_hat = inv_sigma * (b_e - mu)
        att_w = att_weight.T.contiguous()
        pooled = lfa_attention(x, pos, idx, neigh_valid, (gamma[:, None] * a_hat).contiguous(),
                               (gamma * c_hat + beta).contiguous(), att_w, idx_marked)
        ctx.save_for_backward(x, pos, idx, neigh_valid, w_e, b_e, gamma, beta, att_w,
                              mu, n, inv_sigma, a_hat, c_hat, sum_rel, srr)
        ctx.inv, ctx.idx_marked = inv, idx_marked
        ctx.mark_non_differentiable(mu, var, n)
        return pooled, mu, var, n

    @staticmethod
    def backward(ctx, g_pooled, *_):
        (x, pos, idx, neigh_valid, w_e, b_e, gamma, beta, att_w,
         mu, n, inv_sigma, a_hat, c_hat, sum_rel, srr) = ctx.saved_tensors
        dx, d_att_w, sums = lfa_train_bwd(x, pos, idx, neigh_valid, ctx.inv, a_hat, c_hat,
                                          gamma, beta, att_w, g_pooled.contiguous(),
                                          ctx.idx_marked)
        d_gamma, d_beta, s1, s2, m1 = sums[:, 0], sums[:, 1], sums[:, 2], sums[:, 3], sums[:, 4:]
        # sum over slots of ehat_c rel_j, from the rel statistics
        e_rel = inv_sigma[:, None] * (w_e @ srr + (b_e - mu)[:, None] * sum_rel[None, :])
        d_w = inv_sigma[:, None] * (m1 - s1[:, None] * sum_rel[None, :] / n
                                    - s2[:, None] * e_rel / n)
        return (dx, None, None, None, d_w, torch.zeros_like(b_e), d_gamma, d_beta,
                d_att_w.T, None, None, None)


def lfa_train(x: torch.Tensor, pos: torch.Tensor, idx: torch.Tensor, neigh_valid: torch.Tensor,
              w_e: torch.Tensor, b_e: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              att_weight: torch.Tensor, inv: InverseMap | None = None,
              stats: torch.Tensor | None = None, idx_marked: torch.Tensor | None = None):
    """Train-mode fused LFA: ``(pooled (B, N, C), mu, var_biased, n)`` with
    batch-moment BN on the encoder and a hand-written backward w.r.t.
    ``x``, ``w_e (C_in, 10)``, ``b_e``, ``gamma``, ``beta`` and ``att_weight
    (C, C)`` (``att = lf @ att_weight.T``). ``(mu, var_biased, n)`` feed the
    encoder BN's running-stat update and carry no gradient.

    What depends on the graph alone may come from the caller, who shares it
    between the LFAs of a block: ``inv`` (:func:`ops.cuda_gather.inverse_map`),
    ``stats`` (:func:`rel_stats` of ``pos``, ``idx``, ``neigh_valid``) and
    ``idx_marked`` (:func:`ops.cuda_lfa.idx_with_invalid`). Each is built
    here when it is not given."""
    if x.device.type == "cuda":
        if inv is None:
            inv = inverse_map(idx, neigh_valid, x.shape[1])
        if idx_marked is None:
            idx_marked = idx_with_invalid(idx, neigh_valid)
    return _LFATrain.apply(x.contiguous(), pos.contiguous(), idx, neigh_valid, w_e, b_e,
                           gamma, beta, att_weight, inv, stats, idx_marked)
