"""Neighbour search of the PyTorch port (K1's plain version on the CPU)
held against the JAX package: ``ops.knn.knn``/``knn_graph`` on the CPU,
``nearest_neighbor_pallas`` and the windowed ``knn_topk_pallas`` in
interpret mode, ``_window_bases`` and ``stage_window``.

Tolerances: the JAX CPU path ranks by the expansion |q|^2 + |k|^2 - 2 q.k,
the port by summed squared differences, so d2 agree to atol 1e-6 plus
rtol 1e-5 on unit-scale clouds, and indices agree wherever two candidates
are not within that tolerance of each other. The Pallas kernels sum
squared differences in the port's order, so there d2 agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myria3d_tpu.ops.knn import knn as jax_knn, knn_graph as jax_knn_graph
from myria3d_tpu.ops import pallas_knn
from myria3d_tpu.ops.pallas_nn1 import nearest_neighbor_pallas
from myria3d_tpu_torch.ops import cuda_knn
from myria3d_tpu_torch.ops.knn import centred_clouds, knn, knn_graph
from myria3d_tpu_torch.ops.nn1 import nearest_neighbor

torch.set_num_threads(1)

ATOL, RTOL = 1e-6, 1e-5


def assert_same_neighbors(idx_a, d2_a, idx_b, d2_b, valid):
    """d2 close on valid slots; indices equal on valid slots except where a
    slot's distance is within tolerance of a neighbouring slot's or of the
    last slot's (a tie either side may legitimately order)."""
    d2_a, d2_b = np.asarray(d2_a, np.float64), np.asarray(d2_b, np.float64)
    np.testing.assert_allclose(d2_a[valid], d2_b[valid], atol=ATOL, rtol=RTOL)
    tol = ATOL + RTOL * np.abs(d2_b)
    tied = np.zeros(d2_b.shape, bool)
    gap = np.abs(np.diff(d2_b, axis=-1)) <= tol[..., 1:]
    tied[..., 1:] |= gap
    tied[..., :-1] |= gap
    tied |= np.abs(d2_b - d2_b[..., -1:]) <= tol     # ties with slot K+1
    mism = (np.asarray(idx_a) != np.asarray(idx_b)) & valid & ~tied
    assert not mism.any(), f"{mism.sum()} index mismatches outside ties"


def _cloud(rng, b, n, n_valid=None, scale=1.0):
    pos = rng.uniform(-scale, scale, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    for i, nv in enumerate(n_valid or []):
        mask[i, nv:] = False
    return pos, mask


@pytest.mark.parametrize("k,n_valid", [(16, None), (16, [1536, 700]), (10, [1536, 9])])
def test_knn_graph_matches_jax(k, n_valid):
    rng = np.random.default_rng(k + len(n_valid or []))
    pos, mask = _cloud(rng, 2, 1536, n_valid)
    ji, jd, jv = jax_knn_graph(jnp.asarray(pos), jnp.asarray(mask), k, exact=True)
    ti, td, tv = knn_graph(torch.from_numpy(pos), torch.from_numpy(mask), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert_same_neighbors(ti.numpy(), td.numpy(), np.asarray(ji), np.asarray(jd), np.asarray(jv))
    # invalid slots are clamped to index 0 on both sides
    assert (ti.numpy()[~tv.numpy()] == 0).all()


def test_knn_cross_with_query_mask_and_few_keys():
    """Queries into a smaller key set with a query mask; the second case
    has fewer keys than k (k_eff padding with invalid slots)."""
    rng = np.random.default_rng(3)
    q, qmask = _cloud(rng, 2, 1024, [1024, 600])
    for nk, k in ((768, 10), (6, 10)):
        kp, kmask = _cloud(rng, 2, nk, [nk, max(1, nk - 100)])
        args = (q, kp, kmask)
        ji, jd, jv = jax_knn(*map(jnp.asarray, args), k, query_mask=jnp.asarray(qmask),
                              exact=True)
        ti, td, tv = knn(*map(torch.from_numpy, args), k, query_mask=torch.from_numpy(qmask))
        assert ti.shape == (2, 1024, k) and ti.dtype == torch.int32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert_same_neighbors(ti.numpy(), td.numpy(), np.asarray(ji), np.asarray(jd),
                              np.asarray(jv))


def test_nearest_neighbor_matches_jax_full_scan():
    rng = np.random.default_rng(4)
    q, qmask = _cloud(rng, 2, 768, [768, 500])
    kp, kmask = _cloud(rng, 2, 192, [192, 50])
    ji, jd = nearest_neighbor_pallas(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(kmask),
                                     interpret=True, query_mask=jnp.asarray(qmask))
    ti, td = nearest_neighbor(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(kmask), query_mask=torch.from_numpy(qmask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


def test_nearest_neighbor_exact_at_georeferenced_scale():
    """Per-cloud centring keeps f32 ranking exact at Lambert-93 magnitudes
    (float64 brute-force oracle)."""
    rng = np.random.default_rng(7)
    base = np.array([650_000.0, 6_600_000.0, 120.0])
    kp = (base + rng.uniform(0, 50, (2, 640, 3))).astype(np.float32)
    q = (base + rng.uniform(0, 50, (2, 64, 3))).astype(np.float32)
    valid = np.ones((2, 640), bool)
    valid[0, 600:] = False
    idx, d2 = nearest_neighbor(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(valid))
    for b in range(2):
        ref = ((q[b].astype(np.float64)[:, None] - kp[b].astype(np.float64)[None]) ** 2).sum(-1)
        ref[:, ~valid[b]] = np.inf
        np.testing.assert_array_equal(idx[b].numpy(), ref.argmin(1))
        np.testing.assert_allclose(d2[b].numpy(), ref.min(1), rtol=1e-3, atol=1e-2)


def _sorted_cloud(rng, b, n, n_valid=None):
    pos = np.stack([rng.uniform(0, 50, (b, n)), rng.uniform(0, 50, (b, n)),
                    rng.uniform(0, 3, (b, n))], axis=-1).astype(np.float32)
    pos = np.take_along_axis(pos, np.argsort(pos[..., :1], axis=1), axis=1)
    mask = np.ones((b, n), bool)
    for i, nv in enumerate(n_valid or []):
        mask[i, nv:] = False
        pos[i, nv:] = pos[i, 0]          # decimated-stage pad artefact
    return pos, mask


@pytest.mark.parametrize("use_qmask", [False, True])
def test_window_bases_match_jax(use_qmask):
    rng = np.random.default_rng(11)
    q, qmask = _sorted_cloud(rng, 2, 4096 - 100, [3996, 2500])
    kp, kmask = _sorted_cloud(rng, 2, 4096, [4096, 3000])
    q4, k4 = centred_clouds(*map(torch.from_numpy, (q, kp, kmask)))
    w_chunks = cuda_knn.window_chunks(cuda_knn.stage_window(4608, 4096), 4096)
    qm = torch.from_numpy(qmask) if use_qmask else None
    got = cuda_knn.window_bases(q4, k4, w_chunks, qm)
    # the JAX side pads queries to the tile and keys to the bin multiple
    q4p = pallas_knn._pad_axis(jnp.asarray(q4.numpy()), 1, 256)
    want = pallas_knn._window_bases(q4p, jnp.asarray(k4.numpy()), 256, w_chunks, 512,
                                    jnp.asarray(qmask) if use_qmask else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and len(set(got.flatten().tolist())) > 2


@pytest.mark.parametrize("n_keys", [48, 192, 768, 1536, 3072, 4096, 12288, 40960])
def test_stage_window_matches_jax(n_keys):
    for window in (0, 1024, 4608):
        assert cuda_knn.stage_window(window, n_keys) == pallas_knn.stage_window(window, n_keys)
        nk_pad = -(-n_keys // 512) * 512
        assert cuda_knn.window_chunks(window, nk_pad) == pallas_knn._window_chunks(
            window, nk_pad, 512)


def test_windowed_k1_matches_jax_interpret():
    """k=1 within the window: JAX's classic-extraction kernel is exact
    there (binning never loses the minimum), so both sides agree."""
    rng = np.random.default_rng(12)
    q, qmask = _sorted_cloud(rng, 2, 2048, [2048, 1700])
    kp, kmask = _sorted_cloud(rng, 2, 2048, [2048, 1500])
    q4, k4 = centred_clouds(*map(torch.from_numpy, (q, kp, kmask)))
    ti, td = cuda_knn.knn_topk_plain(q4, k4, 1, window=1024, query_mask=torch.from_numpy(qmask))
    ji, jd = pallas_knn.knn_topk_pallas(jnp.asarray(q4.numpy()), jnp.asarray(k4.numpy()), 1,
                                        interpret=True, window=1024,
                                        query_mask=jnp.asarray(qmask), packed=False)
    valid = qmask[..., None]
    np.testing.assert_array_equal(ti.numpy()[valid], np.asarray(ji)[valid])
    np.testing.assert_allclose(td.numpy()[valid], np.asarray(jd)[valid], rtol=1e-6, atol=1e-6)


def test_windowed_k16_exact_in_window():
    """K=16 windowed selection equals a numpy exact top-K over each query
    tile's window (ties to the lower key index)."""
    rng = np.random.default_rng(13)
    pos, mask = _sorted_cloud(rng, 1, 4096, [3900])
    q4, k4 = centred_clouds(*map(torch.from_numpy, (pos, pos, mask)))
    window = cuda_knn.stage_window(4608, 4096)
    idx, d2 = cuda_knn.knn_topk_plain(q4, k4, 16, window=window, query_mask=torch.from_numpy(mask))
    w_chunks = cuda_knn.window_chunks(window, 4096)
    bases = cuda_knn.window_bases(q4, k4, w_chunks, torch.from_numpy(mask)).numpy()[0]
    q, k = q4.numpy()[0].astype(np.float32), k4.numpy()[0].astype(np.float32)
    for qi in range(0, 4096, 37):
        lo = bases[qi // 256] * 512
        kw = k[lo:lo + w_chunks * 512]
        ref = kw[:, 3] * kw[:, 3]
        for c in range(3):
            ref = ref + (q[qi, c] - kw[:, c]) * (q[qi, c] - kw[:, c])
        order = np.argsort(ref, kind="stable")[:16]
        np.testing.assert_array_equal(idx[0, qi].numpy(), lo + order)
        np.testing.assert_array_equal(d2[0, qi].numpy(), ref[order])
    # the window really cut the scan, and the graph is still the exact one
    full_idx, _ = cuda_knn.knn_topk_plain(q4, k4, 16)
    assert w_chunks * 512 < 4096
    assert (idx.numpy() == full_idx.numpy())[0, :3900].mean() > 0.999


def test_wrapper_rejects_out_of_range_k():
    q4 = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError):
        cuda_knn.knn_topk(q4, q4, 9)
    with pytest.raises(ValueError):
        cuda_knn.knn_topk(torch.zeros((1, 64, 4)), torch.zeros((1, 64, 4)), 33)
