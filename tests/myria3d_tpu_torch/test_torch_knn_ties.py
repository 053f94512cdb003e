"""The tie rule of K1 and K3 held against the JAX package on clouds with
duplicate points and keys at equal distances.

K1 and K3 scan a window's keys in any order (centre-out from each warp's
queries) and admit a candidate by the lexicographic (d2, index) rule, so
their result is the one of their plain versions: the k smallest int64
keys ``d2 bits << 32 | index``, ties to the lower key index. Here those
plain versions meet the JAX package wherever its own contract is exact:
the classic unpacked search run in interpret mode with one bin per key (a
full scan: exact for every k, ties to the lower index by its min-index
extraction), and the windowed classic search at k=1 (binning never loses
the minimum). Points lie on a quarter-metre grid, so every difference,
square and partial sum is exact in f32 and both sides rank the same bits:
indices and d2 are equal. The interpolation weights the same neighbours:
within 1e-5 (only the summation order of the weighted payload differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myria3d_tpu.ops import pallas_knn
from myria3d_tpu.ops.interpolate import knn_interpolate as jax_knn_interpolate
from myria3d_tpu_torch.ops.cuda_knn import knn_topk_plain
from myria3d_tpu_torch.ops.interpolate import knn_interpolate

torch.set_num_threads(1)


def _grid(rng, b, n, sort=False):
    """(b, n, 3) quarter-metre grid points (x, y in [-4, 4), z in [-1, 1))
    with the first eighth repeated as exact duplicates mid-cloud."""
    p = np.stack([rng.integers(-16, 16, (b, n)), rng.integers(-16, 16, (b, n)),
                  rng.integers(-4, 4, (b, n))], axis=-1).astype(np.float32) / 4
    p[:, n // 2:n // 2 + n // 8] = p[:, :n // 8]
    if sort:
        p = np.take_along_axis(p, np.argsort(p[..., :1], axis=1, kind="stable"), axis=1)
    return p


def _layout(q, kp, n_pad_keys):
    """Queries and keys in the kernels' layout: w = 0, the last
    ``n_pad_keys`` keys of the second cloud pad keys (w = 1e4)."""
    w = np.zeros(kp.shape[:2] + (1,), np.float32)
    w[1, kp.shape[1] - n_pad_keys:] = 1e4
    return (np.concatenate([q, np.zeros_like(q[..., :1])], axis=-1),
            np.concatenate([kp, w], axis=-1))


@pytest.mark.parametrize("k", [1, 10, 16, 32])
def test_full_scan_ties_match_jax(k):
    rng = np.random.default_rng(k)
    q4, k4 = _layout(_grid(rng, 2, 768), _grid(rng, 2, 1024), 100)
    idx, d2 = knn_topk_plain(torch.from_numpy(q4), torch.from_numpy(k4), k)
    ji, jd = pallas_knn.knn_topk_pallas(jnp.asarray(q4), jnp.asarray(k4), k, interpret=True,
                                        bins=1024, tile_q=128, packed=False)
    # the grid gives the selections real ties: equal d2 inside the lists
    assert k == 1 or (d2[..., 1:] == d2[..., :-1]).sum() > 1000
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_windowed_k1_ties_match_jax():
    rng = np.random.default_rng(5)
    q4, k4 = _layout(_grid(rng, 2, 2048, sort=True), _grid(rng, 2, 2048, sort=True), 0)
    qm = np.ones((2, 2048), bool)
    qm[1, 1800:] = False
    idx, d2 = knn_topk_plain(torch.from_numpy(q4), torch.from_numpy(k4), 1, window=1024,
                             query_mask=torch.from_numpy(qm))
    ji, jd = pallas_knn.knn_topk_pallas(jnp.asarray(q4), jnp.asarray(k4), 1, interpret=True,
                                        window=1024, query_mask=jnp.asarray(qm),
                                        packed=False)
    valid = qm[..., None]
    np.testing.assert_array_equal(d2.numpy()[valid], np.asarray(jd)[valid])
    np.testing.assert_array_equal(idx.numpy()[valid], np.asarray(ji)[valid])


def _symmetric_keys(rng, n):
    """Grid keys and their mirror images through the origin, so each
    cloud's valid mean, the centring offset, is exactly 0 on both sides."""
    half = _grid(rng, 2, n // 2)
    return np.concatenate([half, -half], axis=1)


@pytest.mark.parametrize("fused", [False, True])
def test_interpolation_ties_match_jax(fused, jax_search_on_its_kernel):
    """K3's plain version (``fused``) and the two-op branch against JAX's
    two-op interpolation on its own exact search."""
    jax_search_on_its_kernel()
    rng = np.random.default_rng(9)
    ps, pt = _symmetric_keys(rng, 1024), _grid(rng, 2, 1536)
    x = rng.normal(size=(2, 1024, 7)).astype(np.float32) * 3
    sm = np.ones((2, 1024), bool)
    tm = np.ones((2, 1536), bool)
    tm[1, 1200:] = False
    args = (x, ps, sm, pt, tm)
    want = np.asarray(jax_knn_interpolate(*map(jnp.asarray, args), k=10))
    got = knn_interpolate(*map(torch.from_numpy, args), k=10, fused_payload=fused).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[1, 1200:] == 0).all()
