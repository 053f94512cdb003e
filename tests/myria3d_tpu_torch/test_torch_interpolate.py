"""k-NN interpolation of the PyTorch port held against the JAX package.

- the two-op branch and the fused branch (K3's plain version on the CPU)
  within 1e-5 of JAX's two-op ``knn_interpolate`` run on its own search
  kernel (interpret mode, exact selection; both f32, only summation order
  differs — see the ``jax_search_on_its_kernel`` fixture);
- the fused branch within 2e-2 of ``knn_interpolate_pallas`` in interpret
  mode, whose payload recombine is bf16 (``test_pallas_knn.py:150``);
- the k=1 branch equal to JAX's;
- all-pad key sets give 0 and rows outside the target mask are zeroed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myria3d_tpu.ops.interpolate import knn_interpolate as jax_knn_interpolate
from myria3d_tpu.ops.pallas_knn import knn_interpolate_pallas
from myria3d_tpu_torch.ops import cuda_interp
from myria3d_tpu_torch.ops.interpolate import knn_interpolate

torch.set_num_threads(1)


def _data(seed, b=2, ns=1024, nt=1536, c=7, src_valid=(1024, 600), tgt_valid=(1536, 1000)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, ns, c)).astype(np.float32) * 3
    ps = rng.uniform(0, 50, (b, ns, 3)).astype(np.float32)
    pt = rng.uniform(0, 50, (b, nt, 3)).astype(np.float32)
    sm = np.arange(ns)[None] < np.asarray(src_valid)[:, None]
    tm = np.arange(nt)[None] < np.asarray(tgt_valid)[:, None]
    return x, ps, sm, pt, tm


def _both(args, k, fused_payload=False):
    """(port, JAX two-op) outputs."""
    jax_out = np.asarray(jax_knn_interpolate(*map(jnp.asarray, args), k=k))
    got = knn_interpolate(*map(torch.from_numpy, args), k=k, fused_payload=fused_payload)
    return got.numpy(), jax_out


@pytest.mark.parametrize("fused", [False, True])
def test_interpolation_matches_jax_two_op(fused, jax_search_on_its_kernel):
    jax_search_on_its_kernel()
    got, want = _both(_data(1), k=10, fused_payload=fused)
    assert got.shape == want.shape == (2, 1536, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[1, 1000:] == 0).all()          # outside the target mask


def test_k1_branch_matches_jax(jax_search_on_its_kernel):
    jax_search_on_its_kernel()
    got, want = _both(_data(2, c=32), k=1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fused_matches_pallas_interpret():
    """bf16 recombine on the JAX side: the same 2e-2 envelope the JAX
    package holds its own kernel to against the f32 oracle."""
    x, ps, sm, pt, _ = _data(3, b=1, ns=200, nt=24, src_valid=(150,), tgt_valid=(24,))
    want = np.asarray(knn_interpolate_pallas(
        jnp.asarray(x), jnp.asarray(ps), jnp.asarray(sm), jnp.asarray(pt),
        k=10, tile_q=8, bins=256, interpret=True))
    got = knn_interpolate(torch.from_numpy(x), torch.from_numpy(ps), torch.from_numpy(sm),
                          torch.from_numpy(pt), None, k=10, fused_payload=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-2)


def test_all_pad_keys_give_zero():
    x, ps, _, pt, tm = _data(4, b=1, src_valid=(0,), tgt_valid=(1536,))
    sm = np.zeros((1, 1024), bool)
    for fused in (False, True):
        out = knn_interpolate(torch.from_numpy(x), torch.from_numpy(ps), torch.from_numpy(sm),
                              torch.from_numpy(pt), torch.from_numpy(tm), k=10,
                              fused_payload=fused)
        assert (out == 0).all()


def _x_sorted(rng, b, n):
    p = rng.uniform(0, 50, (b, n, 3)).astype(np.float32)
    return np.take_along_axis(p, np.argsort(p[..., :1], axis=1), axis=1)


def test_fused_plain_uses_windows_on_sorted_clouds():
    """With a window on x-sorted clouds, the fused and the two-op branches
    weight the same window neighbours, which here are the exact ones."""
    rng = np.random.default_rng(5)
    ps, pt = _x_sorted(rng, 1, 4096), _x_sorted(rng, 1, 2048)
    x = rng.normal(size=(1, 4096, 7)).astype(np.float32)
    sm, tm = np.ones((1, 4096), bool), np.ones((1, 2048), bool)
    args = [torch.from_numpy(a) for a in (x, ps, sm, pt, tm)]
    win = knn_interpolate(*args, k=10, fused_payload=True, window=2048)
    full = knn_interpolate(*args, k=10, fused_payload=True)
    two_op = knn_interpolate(*args, k=10, window=2048)
    torch.testing.assert_close(win, full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(win, two_op, rtol=1e-5, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(cuda_interp, "knn_interp_plain",
                        lambda *a, **k: calls.append(1) or torch.zeros(1))
    q4 = torch.zeros((1, 8, 4))
    cuda_interp.knn_interp(torch.zeros((1, 8, 3)), q4, q4, 2)
    assert calls and cuda_interp.knn_interp.launches == 0
