"""K7's plain version (``knn_topk(..., variant="mxu")`` on the CPU) held
against the JAX package's MXU kernel ``_knn_kernel``
(``knn_topk_pallas(variant="mxu")`` in interpret mode, one bin per key so
its selection is exact, as ``tests/myria3d_tpu/ops/test_pallas_knn.py``
runs it) and against K1's plain version on a centred 50 m subtile.

Tolerances: against the Pallas kernel, equal index sets and d2 within 1e-5
absolute on unit-cube clouds (both rank the same expanded score in f32;
the sums run in other orders). Against K1, the expanded form's d2 carries a
rounding error below 16 eps (|q|^2 + max |k|^2) (a few ulps of each of
|k|^2, 2 q.k, their sum and |q|^2): the index sets agree wherever the gap
between the k-th and (k+1)-th distances exceeds twice that bound, and d2
agrees within it there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myria3d_tpu.ops.knn import _augment_keys, _augment_queries
from myria3d_tpu.ops.pallas_knn import knn_topk_pallas
from myria3d_tpu_torch.ops.cuda_knn import (
    BINS,
    PAD_W,
    expanded_scores,
    knn_topk,
    knn_topk_mxu,
    knn_topk_plain,
    mxu_scan_len,
)
from myria3d_tpu_torch.ops.knn import centred_clouds

torch.set_num_threads(1)
EPS = float(np.finfo(np.float32).eps)


def _clouds(rng, b, nq, nk, n_valid, scale=1.0):
    q = rng.uniform(-scale, scale, (b, nq, 3)).astype(np.float32)
    k = rng.uniform(-scale, scale, (b, nk, 3)).astype(np.float32)
    valid = np.arange(nk)[None] < np.asarray(n_valid)[:, None]
    return q, k, valid


# the last case: Nk no multiple of the bins and fewer valid keys than k, so
# pad keys and the padding rows fill the list
@pytest.mark.parametrize("k,nq,nk,n_valid", [(8, 16, 128, (128, 100)), (16, 24, 96, (96, 40)),
                                             (1, 16, 128, (128, 3)), (10, 8, 64, (64, 64)),
                                             (16, 16, 100, (100, 9))])
def test_k7_plain_matches_the_mxu_pallas_kernel(k, nq, nk, n_valid):
    rng = np.random.default_rng(k)
    q, kp, valid = _clouds(rng, 2, nq, nk, n_valid)
    q4 = _augment_queries(jnp.asarray(q))
    k4 = _augment_keys(jnp.asarray(kp), jnp.asarray(valid))
    want_idx, want_d2 = knn_topk_pallas(q4, k4, k, tile_q=8, bins=128, interpret=True,
                                        variant="mxu")
    idx, d2 = knn_topk(torch.from_numpy(np.array(q4)), torch.from_numpy(np.array(k4)), k,
                       variant="mxu")
    assert idx.dtype == torch.int32 and idx.shape == d2.shape == (2, nq, k)
    np.testing.assert_allclose(d2.numpy(), np.asarray(want_d2), rtol=0, atol=1e-5)
    assert (np.sort(idx.numpy(), -1) == np.sort(np.asarray(want_idx), -1)).all()
    assert (np.diff(d2.numpy(), axis=-1) >= 0).all()


def test_k7_on_a_centred_50m_subtile_agrees_with_k1():
    """Scores are negative for near keys (d2 - |q|^2 < 0 on a centred
    subtile): the ranking must still be ascending in d2."""
    rng = np.random.default_rng(7)
    q, kp, valid = _clouds(rng, 2, 700, 900, (900, 650), scale=25.0)
    q[..., 2] /= 5
    kp[..., 2] /= 5
    q4, k4 = centred_clouds(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(valid))
    idx7, d7 = knn_topk_plain(q4, k4, 16, variant="mxu")
    idx1, d1 = knn_topk_plain(q4, k4, 17)
    kmax = torch.where(k4[..., 3:] == 0, k4[..., :3], 0.0).square().sum(-1).amax(1)
    tol = 16 * EPS * (q4[..., :3].square().sum(-1) + kmax[:, None])
    clear = (d1[..., 16] - d1[..., 15]) > 2 * tol
    assert clear.float().mean() > 0.9
    same = (idx7.sort(-1).values == idx1[..., :16].sort(-1).values).all(-1)
    assert same[clear].all()
    assert ((d7 - d1[..., :16]).abs() <= tol[..., None])[clear].all()
    assert (idx7 < torch.from_numpy(valid.sum(1))[:, None, None]).all()   # no pad key


def _sq_norms(k4):
    """|k|^2 of each key in the plain version's association."""
    kn = k4[..., 0] * k4[..., 0]
    for c in range(1, 4):
        kn = kn + k4[..., c] * k4[..., c]
    return kn


def _subtile_clouds(nq, nk, n_valid, seed):
    """Centred 50 m subtiles whose key clouds have ``n_valid`` valid keys
    each: pad keys keep their positions, so they sit farther or nearer
    than the virtual pad rows (at the valid keys' centroid)."""
    rng = np.random.default_rng(seed)
    q, kp, valid = _clouds(rng, 2, nq, nk, n_valid, scale=25.0)
    return centred_clouds(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(valid))


# fewer valid keys than k (virtual rows enter the list), Nk a multiple of
# 512 (no virtual row), Nk + k past the padded count, k = 1 with no valid
# key in the second cloud
@pytest.mark.parametrize("k,nk,n_valid,rows_enter", [
    (16, 700, (5, 700), True), (32, 1100, (20, 3), True), (16, 1024, (1024, 7), False),
    (32, 1000, (1000, 990), False), (1, 300, (300, 0), False)])
def test_k7_scans_the_keys_and_k_virtual_rows(k, nk, n_valid, rows_enter):
    """K7 scans ``mxu_scan_len`` positions; its plain version scans the
    whole padded count. Every position the plain version selects lies
    before the cut, so the k best of the positions before it are the same
    k in the same order: the cut scan equals the full one."""
    q4, k4 = _subtile_clouds(300, nk, n_valid, k)
    nk_pad = -(-nk // BINS) * BINS
    n_scan = mxu_scan_len(nk, k)
    assert n_scan == min(nk_pad, nk + k)
    idx, _ = knn_topk_plain(q4, k4, k, variant="mxu")
    assert int(idx.max()) < n_scan
    # where they enter, the virtual rows beat some pad keys: the cut keeps them
    assert bool((idx >= nk).any()) == rows_enter
    # a virtual row (0, 0, 0, PAD_W) as a real key changes nothing
    rows = torch.zeros((2, nk_pad - nk, 4))
    rows[..., 3] = PAD_W
    idx_full, _ = knn_topk_plain(q4, torch.cat([k4, rows], dim=1), k, variant="mxu")
    assert torch.equal(idx, idx_full)


def test_dropping_the_query_w_product_is_exact():
    """K7 scores ``kn + (-2q).k`` without the w product: with the query's
    w = +-0 it is +-0, and the plain scores (every pad key, the virtual
    row and zero coordinates among the keys) stay bit-equal without it."""
    q4, k4 = _subtile_clouds(200, 600, (400, 600), 3)
    k4 = torch.cat([k4, torch.tensor([[[0.0, 0.0, 0.0, PAD_W]] * 2, [[0.0, 0.0, 0.0, 0.0]] * 2])
                    .transpose(0, 1)], dim=1)
    q4[0, :50] = 0.0
    q4[1, :, 3] = -0.0
    kn = _sq_norms(k4)
    q2 = q4 * -2.0
    got = expanded_scores(q2, k4, kn)
    c = q2[..., 0, None] * k4[:, None, :, 0]
    for d in range(1, 3):
        c = c + q2[..., d, None] * k4[:, None, :, d]
    want = kn[:, None, :] + c
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the plain version reads the query's w as 0, as the kernel does
    idx, _ = knn_topk_plain(q4, k4, 16, variant="mxu")
    q4[..., 3] = 3.0
    assert torch.equal(knn_topk_plain(q4, k4, 16, variant="mxu")[0], idx)


def test_k7_filter_bound_stays_within_its_slack_of_the_score():
    """K7's scan filters pairs on ``kn (1 - 2^-19) + (-2q).k`` (a product
    and 3 FMAs, ``Expanded::bound`` in ``csrc/topk.cuh``) and scores only
    those within ``2^-19 |q|^2`` of the K-th best: that is exact when the
    bound never exceeds the score by that slack. Emulated here (an FMA as
    one rounding of the float64 result) on a subtile with pad keys, the
    virtual row and a query at the origin, against the plain scores."""
    q4, k4 = _subtile_clouds(300, 800, (500, 800), 11)
    q4[0, 0] = 0.0
    k4 = torch.cat([k4, torch.tensor([[0.0, 0.0, 0.0, PAD_W]]).expand(2, 1, 4)], dim=1)
    kn = _sq_norms(k4)
    q2 = q4 * -2.0
    score = expanded_scores(q2, k4, kn).double()
    r = (kn * (1.0 - 2.0**-19))[:, None, :]
    for c in range(3):
        r = (q2[..., c, None].double() * k4[:, None, :, c].double() + r.double()).float()
    slack = 2.0**-21 * (q2[..., :3].double() ** 2).sum(-1, keepdim=True) + 2.0**-120
    assert (r.double() <= score + slack).all()


@pytest.mark.parametrize("kwargs", [{"window": 512}, {"variant": "tensor"}])
def test_variant_arguments_are_checked(kwargs):
    q4 = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError):
        knn_topk(q4, q4, 2, **{"variant": "mxu", **kwargs})
    with pytest.raises(ValueError):
        knn_topk_plain(q4, q4, 2, **{"variant": "mxu", **kwargs})


def test_cpu_tensors_take_the_plain_version():
    before = (knn_topk.launches, knn_topk_mxu.launches)
    q4 = torch.rand((1, 8, 4)) * torch.tensor([1.0, 1.0, 1.0, 0.0])
    knn_topk(q4, q4, 2, variant="mxu")
    assert (knn_topk.launches, knn_topk_mxu.launches) == before
