"""Fixtures for the PyTorch port's tests."""

import jax
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

    def enable():
        monkeypatch.setattr(pallas_knn, "knn_pallas_available", lambda k, nk: True)
        monkeypatch.setattr(pallas_knn, "knn_topk_pallas", exact_interpret)
        jax.clear_caches()

    yield enable
    jax.clear_caches()
