"""Masked softmax and random decimation of the PyTorch port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myria3d_tpu.ops.masked import masked_softmax as jax_masked_softmax
from myria3d_tpu_torch.ops.masked import masked_softmax
from myria3d_tpu_torch.ops.sampling import random_decimation

torch.set_num_threads(1)


def test_masked_softmax_matches_jax_and_zeroes_empty_segments():
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(3, 5, 16, 8)).astype(np.float32) * 4
    valid = rng.uniform(size=(3, 5, 16, 1)) < 0.6
    valid[1, 2] = False                                   # all-invalid segment
    got = masked_softmax(torch.from_numpy(scores), torch.from_numpy(valid), dim=2).numpy()
    want = np.asarray(jax_masked_softmax(jnp.asarray(scores), jnp.asarray(valid), axis=2))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.isfinite(got).all()
    assert (got[1, 2] == 0).all()
    np.testing.assert_allclose(got.sum(2)[valid.any(2)[..., 0]], 1.0, rtol=1e-6)


@pytest.mark.parametrize("decimation", [1, 4])
def test_decimation_ascending_and_kept_counts(decimation):
    mask = torch.zeros((4, 1024), dtype=torch.bool)
    for b, n in enumerate((1024, 700, 3, 0)):
        mask[b, :n] = True
    gen = torch.Generator().manual_seed(0)
    idx, new_mask = random_decimation(mask, decimation, gen)
    n_out = 1024 // decimation
    assert idx.shape == new_mask.shape == (4, n_out)
    kept = new_mask.sum(1).tolist()
    assert kept == [1024 // decimation, 700 // decimation, 1 if decimation > 3 else 3, 0]
    for b in range(4):
        sel = idx[b][new_mask[b]]
        assert (sel[1:] > sel[:-1]).all()                 # strictly ascending
        assert mask[b][sel].all()                         # valid points only
        assert (idx[b][~new_mask[b]] == 0).all()


def test_decimation_uniform_and_seeded():
    mask = torch.ones((1, 4096), dtype=torch.bool)
    a, _ = random_decimation(mask, 4, torch.Generator().manual_seed(7))
    b, _ = random_decimation(mask, 4, torch.Generator().manual_seed(7))
    c, _ = random_decimation(mask, 4, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # a uniform subset: each quarter of the cloud keeps about a quarter
    counts = torch.bincount(a[0] // 1024, minlength=4)
    assert (counts - 256).abs().max() < 64


def test_decimation_rejects_zero():
    with pytest.raises(ValueError):
        random_decimation(torch.ones((1, 8), dtype=torch.bool), 0)
