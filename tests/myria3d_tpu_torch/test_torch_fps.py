"""Masked farthest-point sampling (K8's plain version, ``ops/cuda_fps.py``)
and the ball query (``ops/knn.py``) of the port held against the JAX
package (``myria3d_tpu/ops/fps.py``, ``myria3d_tpu/ops/knn.py:217``).

FPS is exact on both sides: the plain version sums the squared differences
in the association of JAX's CPU sum, ``(dx*dx + dy*dy) + dz*dz``, and both
break argmax ties to the lower index, so indices and masks are equal. The
ball query is held with JAX's searches on its own kernel (the
``jax_search_on_its_kernel`` fixture): K1's plain version and the Pallas
kernel then rank the same squared differences, so ``idx`` and
``neigh_valid`` are equal. K8 itself is held to this plain version on the
card (``test_torch_cuda_kernels.py``, ``chip_smoke.py`` phase 16a).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myria3d_tpu.ops.fps import farthest_point_sampling as jax_fps
from myria3d_tpu.ops.knn import ball_query as jax_ball_query
from myria3d_tpu_torch.ops import cuda_fps
from myria3d_tpu_torch.ops.cuda_fps import farthest_point_sampling_plain
from myria3d_tpu_torch.ops.fps import farthest_point_sampling
from myria3d_tpu_torch.ops.knn import ball_query

torch.set_num_threads(1)


def _clouds(seed, b=3, n=1024, m=256, scale=1.0, grid=None):
    """Cloud 0 with a few leading pads, cloud 1 with fewer valid points
    than ``m``, cloud 2 all pads (garbage coordinates on every pad)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (b, n, 3)) * scale
    if grid is not None:          # duplicates and exact distance ties
        pos = np.round(pos / grid) * grid
    pos = pos.astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[0, :5] = False
    mask[1, m // 2:] = False
    mask[2] = False
    pos[~mask] = rng.uniform(-1e3, 1e3, (int((~mask).sum()), 3))
    return pos, mask


@pytest.mark.parametrize("case", [dict(seed=0), dict(seed=1, scale=250.0),
                                  dict(seed=2, grid=0.25), dict(seed=3, n=200, m=64)])
def test_plain_fps_matches_jax(case):
    m = case.pop("m", 256)
    pos, mask = _clouds(**case, m=m)
    want_idx, want_mask = jax_fps(jnp.asarray(pos), jnp.asarray(mask), m)
    idx, new_mask = farthest_point_sampling_plain(torch.from_numpy(pos), torch.from_numpy(mask), m)
    assert idx.dtype == torch.int32 and new_mask.dtype == torch.bool
    np.testing.assert_array_equal(new_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert new_mask.sum(1).tolist() == [m, m // 2, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_fps_matches_jax_on_a_mask_that_is_no_prefix(seed):
    """Valid points scattered over the slots (about 70 %, the first slot a
    pad), clouds with fewer valid points than m and none at all."""
    rng = np.random.default_rng(seed)
    b, n, m = 4, 900, 200
    pos = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    mask = rng.random((b, n)) < 0.7
    mask[:, 0] = False
    mask[2] = False
    mask[2, rng.choice(n, m // 3, replace=False)] = True
    mask[3] = False
    pos[~mask] = rng.uniform(-1e3, 1e3, (int((~mask).sum()), 3))
    want_idx, want_mask = jax_fps(jnp.asarray(pos), jnp.asarray(mask), m)
    idx, new_mask = farthest_point_sampling_plain(torch.from_numpy(pos), torch.from_numpy(mask), m)
    np.testing.assert_array_equal(new_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert new_mask.sum(1).tolist() == [m, m, m // 3, 0]
    assert mask[np.arange(b)[:, None], idx.numpy()][new_mask.numpy()].all()


def test_plain_fps_matches_jax_on_duplicate_points():
    """Every point repeated (and a cloud of one position): after the
    distinct points run out, every round ties at 0 and the lower index
    wins on both sides."""
    rng = np.random.default_rng(3)
    b, n, m = 3, 600, 400
    base = rng.uniform(-1, 1, (b, n // 4, 3)).astype(np.float32)
    pos = np.repeat(base, 4, axis=1)[:, rng.permutation(n)]
    pos[2] = 0.25
    mask = np.ones((b, n), bool)
    mask[1, ::3] = False
    want_idx, want_mask = jax_fps(jnp.asarray(pos), jnp.asarray(mask), m)
    idx, new_mask = farthest_point_sampling_plain(torch.from_numpy(pos), torch.from_numpy(mask), m)
    np.testing.assert_array_equal(new_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_fps_wrapper_takes_the_plain_version_on_the_cpu():
    pos, mask = _clouds(4, n=300, m=75)
    # a non-contiguous view: the op makes it contiguous
    pos_t = torch.from_numpy(np.ascontiguousarray(pos.transpose(0, 2, 1))).transpose(1, 2)
    before = cuda_fps.fps.launches
    idx, new_mask = farthest_point_sampling(pos_t, torch.from_numpy(mask), 75)
    want = farthest_point_sampling_plain(torch.from_numpy(pos), torch.from_numpy(mask), 75)
    assert torch.equal(idx, want[0]) and torch.equal(new_mask, want[1])
    assert cuda_fps.fps.launches == before


# phase 16a's shapes on the H100's 132 SMs: (B, n) -> (threads, points a
# thread, cluster size, skip), the fastest measured route at each of those
# whose clusters all fit on the card at once (scripts/tune_fps.py, PERF.md)
H100_SMS = 132
PHASE_16A_ROUTES = {
    (16, 12288): (256, 12, 4, True), (48, 12288): (256, 12, 4, True),
    (16, 3072): (128, 6, 4, False), (48, 3072): (128, 6, 4, False),
    (16, 768): (128, 6, 1, False), (48, 768): (128, 6, 1, False),
    (16, 192): (32, 6, 1, False), (48, 192): (32, 6, 1, False),
    (16, 40960): (512, 14, 6, True),
}
# cudaOccupancyMaxActiveClusters of those routes on the H100 (chip_smoke.py
# phase 2); clusters of seven or eight 512-thread CTAs fit only 15 at once
H100_CLUSTERS_AT_ONCE = {(256, 12, 4): 62, (128, 6, 4): 186, (128, 6, 1): 792, (32, 6, 1): 1056,
                         (512, 14, 6): 17, (512, 12, 7): 15, (512, 12, 8): 15}


@pytest.mark.parametrize("b,n", sorted(PHASE_16A_ROUTES))
def test_route_rule_at_the_phase_16a_shapes(b, n):
    assert tuple(cuda_fps.route(b, n, H100_SMS)) == PHASE_16A_ROUTES[(b, n)]


@pytest.mark.parametrize("b,n", sorted(PHASE_16A_ROUTES))
def test_route_rule_keeps_every_cluster_resident_at_the_phase_16a_shapes(b, n):
    """No cloud of a phase 16a batch waits for a second wave: the batch's
    clusters are at most what the H100 holds at once of the route."""
    rt = cuda_fps.route(b, n, H100_SMS)
    assert b <= H100_CLUSTERS_AT_ONCE[(rt.threads, rt.pt, rt.cluster)], (b, n, rt)


@pytest.mark.parametrize("b", [1, 4, 16, 48, 200])
@pytest.mark.parametrize("sms", [16, 132])
def test_route_rule_holds_every_cloud_size(b, sms):
    """Every n up to MAX_N gets a route the kernel takes: threads a multiple
    of 32 up to 512, an instantiated count of points a thread, a portable
    cluster (1 to 8 CTAs) that holds the cloud, shared memory within the
    H100's 227 KB a CTA; more SMs never give fewer CTAs a cloud."""
    for n in list(range(1, 200)) + list(range(200, cuda_fps.MAX_N + 1, 97)) + [cuda_fps.MAX_N]:
        rt = cuda_fps.route(b, n, sms)
        assert rt.threads % 32 == 0 and 32 <= rt.threads <= cuda_fps.MAX_THREADS, (n, rt)
        assert rt.pt in cuda_fps.PTS and 1 <= rt.cluster <= cuda_fps.MAX_CLUSTER, (n, rt)
        assert rt.threads * rt.pt * rt.cluster >= n, (n, rt)
        slots = rt.cluster * rt.threads // 32
        assert rt.threads * rt.pt * 16 + 2 * slots * 24 + 16 <= 232448, (n, rt)
        assert rt.skip == (n > cuda_fps.LARGE)
        assert cuda_fps.route(b, n, 4 * sms).cluster >= rt.cluster
        if rt.cluster > 1 and b * rt.cluster > cuda_fps.CTAS_PER_SM * sms:
            assert (rt.cluster // 2) * cuda_fps.CTA_POINTS_MOST < n, (n, rt)


def test_route_rule_refuses_clouds_past_the_kernel():
    with pytest.raises(ValueError, match="exceed"):
        cuda_fps.route(1, cuda_fps.MAX_N + 1, H100_SMS)


@pytest.mark.parametrize("bad", ["dtype", "mask", "m"])
def test_fps_rejects_what_the_kernel_does_not_take(bad):
    pos, mask = torch.zeros((2, 8, 3)), torch.ones((2, 8), dtype=torch.bool)
    if bad == "dtype":
        pos = pos.double()
    elif bad == "mask":
        mask = mask[:, :4]
    with pytest.raises(ValueError):
        cuda_fps.fps(pos, mask, 0 if bad == "m" else 4)


@pytest.mark.parametrize("n,k,radius", [(1280, 32, 0.2), (256, 32, 0.4), (48, 32, 0.8)])
def test_ball_query_matches_jax(jax_search_on_its_kernel, n, k, radius):
    """Centroids from FPS, keys the cloud, as a set abstraction queries
    them; with 48 keys the key count is below the 1024 at which the JAX
    package leaves its Pallas kernel (the fixture keeps it on the kernel,
    which is exact in both cases)."""
    pos, mask = _clouds(5, n=n, m=n // 4)
    sel, sel_mask = farthest_point_sampling_plain(torch.from_numpy(pos), torch.from_numpy(mask),
                                                  n // 4)
    centres = torch.from_numpy(pos)[torch.arange(3)[:, None], sel.long()]
    jax_search_on_its_kernel()
    want_idx, want_d2, want_nv = jax_ball_query(
        jnp.asarray(centres.numpy()), jnp.asarray(pos), jnp.asarray(mask), k, radius,
        query_mask=jnp.asarray(sel_mask.numpy()))
    idx, d2, nv = ball_query(centres, torch.from_numpy(pos), torch.from_numpy(mask), k, radius,
                             query_mask=sel_mask)
    np.testing.assert_array_equal(nv.numpy(), np.asarray(want_nv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    v = nv.numpy()
    np.testing.assert_allclose(d2.numpy()[v], np.asarray(want_d2)[v], rtol=1e-6, atol=1e-7)
    # every valid centroid finds itself (d2 = 0); the radius filter bites
    assert v[sel_mask.numpy()][:, 0].all() and 0 < v.mean() < 1
