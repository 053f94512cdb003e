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
from myria3d_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_mxu, knn_topk_plain
from myria3d_tpu_torch.ops.knn import centred_clouds

torch.set_num_threads(1)
EPS = float(np.finfo(np.float32).eps)


def _clouds(rng, b, nq, nk, n_valid, scale=1.0):
    q = rng.uniform(-scale, scale, (b, nq, 3)).astype(np.float32)
    k = rng.uniform(-scale, scale, (b, nk, 3)).astype(np.float32)
    valid = np.arange(nk)[None] < np.asarray(n_valid)[:, None]
    return q, k, valid


@pytest.mark.parametrize("k,nq,nk,n_valid", [(8, 16, 128, (128, 100)), (16, 24, 96, (96, 40)),
                                             (1, 16, 128, (128, 3)), (10, 8, 64, (64, 64))])
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
