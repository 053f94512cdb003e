"""Fixtures for the PyTorch port's tests."""

import jax
import jax.numpy as jnp
import pytest
import torch

from myria3d_tpu.ops import pallas_knn


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def jax_search_on_its_kernel(monkeypatch):
    """A function that routes the JAX package's neighbour searches through
    its own Pallas kernel in interpret mode, with one bin per key (exact
    selection), from the moment it is called to the end of the test.

    On the CPU the JAX package otherwise ranks by the norm expansion
    |q|^2 + |k|^2 - 2 q.k, whose rounding (~1e-7 of |q|^2) moves the
    inverse-distance weights of near neighbours by up to 1e-3; the kernel
    sums squared differences in the port's order, so the two sides then
    weight the same neighbours by the same distances. JAX caches are
    cleared so no trace made without the patch is reused.
    """
    orig = pallas_knn.knn_topk_pallas

    def exact_interpret(q4, k4, k, **kw):
        kw.update(interpret=True, bins=-(-k4.shape[1] // 128) * 128, tile_q=128)
        return orig(q4, k4, k, **kw)

    yield lambda: route_jax_searches(monkeypatch, exact_interpret)
    jax.clear_caches()


def route_jax_searches(mp, search) -> None:
    """Send the JAX package's neighbour searches to ``search`` (in place
    of ``knn_topk_pallas``), through ``mp`` (a ``pytest.MonkeyPatch``)."""
    mp.setattr(pallas_knn, "knn_pallas_available", lambda k, nk: True)
    mp.setattr(pallas_knn, "knn_topk_pallas", search)
    jax.clear_caches()


def jax_exact_scan(q4, k4, k, chunk=512, **_):
    """What ``knn_topk_pallas`` returns in interpret mode with one bin per
    key (``jax_search_on_its_kernel``), as an XLA scan of chunks of queries:
    the squared distance summed in the kernel's order (w², then dx², dy²,
    dz²), the k smallest, ties to the lower key index. Bit-equal to the
    interpreted kernel (``test_torch_tile.py``) and far cheaper at a
    tile's sizes; the window is ignored, as it is there."""
    b, nq, _ = q4.shape
    nq_pad = -(-nq // chunk) * chunk
    qc = jnp.pad(q4, ((0, 0), (0, nq_pad - nq), (0, 0))).reshape(b, nq_pad // chunk, chunk, 4)
    kw = k4[:, None, :, 3]

    def scan(q):                                        # (B, chunk, 4)
        s = jnp.broadcast_to(kw * kw, (b, chunk, k4.shape[1]))
        for c in range(3):
            d = q[:, :, None, c] - k4[:, None, :, c]
            s = s + d * d
        neg, idx = jax.lax.top_k(-s, k)
        return idx.astype(jnp.int32), jnp.maximum(-neg, 0.0)

    idx, d2 = jax.lax.map(scan, jnp.swapaxes(qc, 0, 1))
    idx = jnp.swapaxes(idx, 0, 1).reshape(b, nq_pad, k)[:, :nq]
    d2 = jnp.swapaxes(d2, 0, 1).reshape(b, nq_pad, k)[:, :nq]
    return idx, d2
