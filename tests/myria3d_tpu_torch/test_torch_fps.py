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


def test_fps_wrapper_takes_the_plain_version_on_the_cpu():
    pos, mask = _clouds(4, n=300, m=75)
    # a non-contiguous view: the op makes it contiguous
    pos_t = torch.from_numpy(np.ascontiguousarray(pos.transpose(0, 2, 1))).transpose(1, 2)
    before = cuda_fps.fps.launches
    idx, new_mask = farthest_point_sampling(pos_t, torch.from_numpy(mask), 75)
    want = farthest_point_sampling_plain(torch.from_numpy(pos), torch.from_numpy(mask), 75)
    assert torch.equal(idx, want[0]) and torch.equal(new_mask, want[1])
    assert cuda_fps.fps.launches == before


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
