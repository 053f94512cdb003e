"""The numerical contract of the fused LFA kernels' attention product
(``csrc/lfa_tile.cuh``), emulated on the CPU.

K2 and K6 run ``att = lf @ att_w`` on the tensor cores in 3xTF32: each f32
operand v splits into ``hi = tf32(v)`` and ``lo = tf32(v - hi)`` (round to
nearest, ties away from zero, 10 explicit mantissa bits: ``cvt.rna.tf32``),
and ``hi*hi``, ``hi*lo`` and ``lo*hi`` accumulate in f32, each in its own
accumulator, 8 products (one mma k-step) at a time. Through the masked
softmax and pooling of ``lfa_attention_plain``, that product stays within
K2's tolerance (1e-4 of the output's scale) of float64 at C = 8, 64 and
256; a single TF32 pass (``hi*hi`` only) does not, which is why the kernels
pay for three.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention_plain
from myria3d_tpu_torch.ops.knn import gather_rows
from myria3d_tpu_torch.ops.masked import masked_softmax

torch.set_num_threads(1)
K2_TOL = 1e-4
WIDTHS = [8, 64, 256]


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32, to nearest with ties away from zero: add half
    a unit of the 10th mantissa bit to the magnitude, clear the 13 bits
    below it."""
    bits = t.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def emulated_product(lf: torch.Tensor, w: torch.Tensor, passes: int) -> torch.Tensor:
    """``lf @ w`` (float32) as the kernels' mma.sync k-steps compute it:
    per chain, the exact sum of 8 products added to an f32 accumulator;
    3 passes: chains hi*hi, hi*lo, lo*hi, folded as big + (hi*lo + lo*hi);
    1 pass: hi*hi alone."""
    lf_hi, w_hi = tf32(lf), tf32(w)
    lf_lo, w_lo = tf32(lf - lf_hi), tf32(w - w_hi)
    pairs = [(lf_hi, w_hi), (lf_hi, w_lo), (lf_lo, w_hi)][:passes]
    chains = []
    for a, b in pairs:
        acc = torch.zeros(lf.shape[:-1] + (w.shape[1],), dtype=torch.float32)
        for k0 in range(0, lf.shape[-1], 8):
            step = a[..., k0:k0 + 8].double() @ b[k0:k0 + 8].double()
            acc = acc + step.float()
        chains.append(acc)
    return chains[0] if passes == 1 else chains[0] + (chains[1] + chains[2])


def _inputs(c: int, seed: int):
    """A (2, 48)-point batch of K=16 neighbourhoods, some slots and one
    point's every slot invalid, at width C = c: features in [-2, 2) and
    attention weights of std 2 / sqrt(C), so the softmax is as peaked as a
    trained layer's can be."""
    rng = np.random.default_rng(seed)
    b, n, k, c_in = 2, 48, 16, c // 2
    pos = rng.uniform(0, 5, (b, n, 3)).astype(np.float32)
    x = rng.uniform(-2, 2, (b, n, c_in)).astype(np.float32)
    idx = rng.integers(0, n, (b, n, k))
    nv = rng.random((b, n, k)) > 0.2
    nv[0, 5] = False
    enc_a = (rng.standard_normal((c_in, 10)) * 0.3).astype(np.float32)
    enc_c = (rng.standard_normal(c_in) * 0.3).astype(np.float32)
    att_w = (rng.standard_normal((c, c)) * 2 / np.sqrt(c)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, pos, idx, nv, enc_a, enc_c, att_w))


def _edge_features(x, pos, idx, enc_a, enc_c):
    """``lf (B, N, K, C)`` as ``lfa_attention_plain`` builds it."""
    pos_j = gather_rows(pos, idx)
    pos_i = pos[:, :, None, :].expand_as(pos_j)
    diff = pos_j - pos_i
    dist = (diff * diff).sum(dim=-1, keepdim=True).clamp(min=0.0).sqrt()
    rel = torch.cat([pos_i, pos_j, diff, dist], dim=-1)
    return torch.cat([gather_rows(x, idx), F.leaky_relu(rel @ enc_a.T + enc_c, 0.2)], dim=-1)


def _pooled(lf, att, nv):
    return (masked_softmax(att, nv[..., None], dim=2) * lf).sum(dim=2)


def _scaled_err(c: int, passes: int) -> float:
    x, pos, idx, nv, enc_a, enc_c, att_w = _inputs(c, seed=c)
    want = lfa_attention_plain(*(t.double() if t.is_floating_point() else t
                                 for t in (x, pos, idx, nv, enc_a, enc_c, att_w)))
    lf = _edge_features(x, pos, idx, enc_a, enc_c)
    got = _pooled(lf, emulated_product(lf, att_w, passes), nv)
    return float((got.double() - want).abs().max() / want.abs().max())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    vals = torch.tensor([one + 2**-11, one + 2**-12, -(one + 2**-11), one + 3 * 2**-11,
                         1.5, 2**-20], dtype=torch.float32)
    want = torch.tensor([one + 2**-10, one, -(one + 2**-10), one + 2 * 2**-10, 1.5, 2**-20])
    assert torch.equal(tf32(vals), want)
    # 10 explicit mantissa bits: the low 13 bits are clear
    r = tf32(torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32)))
    assert (r.view(torch.int32) & 0x1FFF == 0).all()


def test_the_emulation_is_the_plain_function():
    """With the exact product, the emulation's softmax and pooling are
    ``lfa_attention_plain``'s."""
    x, pos, idx, nv, enc_a, enc_c, att_w = _inputs(64, seed=1)
    lf = _edge_features(x, pos, idx, enc_a, enc_c)
    torch.testing.assert_close(_pooled(lf, lf @ att_w, nv),
                               lfa_attention_plain(x, pos, idx, nv, enc_a, enc_c, att_w),
                               rtol=0, atol=0)


@pytest.mark.parametrize("c", WIDTHS)
def test_three_tf32_passes_meet_the_k2_tolerance(c):
    assert _scaled_err(c, passes=3) <= K2_TOL


@pytest.mark.parametrize("c", WIDTHS)
def test_one_tf32_pass_misses_it(c):
    assert _scaled_err(c, passes=1) > K2_TOL
