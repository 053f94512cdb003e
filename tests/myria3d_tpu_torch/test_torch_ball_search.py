"""K1's PointNet++ routes on the CPU: the ball route (lists that start at
the radius, its queries walked in x order) and the 4-slot list for k in
[2, 4], held against the port's generic searches and the JAX
package's ``ball_query`` (its search on its own Pallas kernel in interpret
mode, ``jax_search_on_its_kernel``).

The ball route keeps the K nearest valid keys inside the ball, ties to the
lower index; the generic route keeps the K nearest keys and filters them by
the radius afterwards. Both keep the same valid slots in the same order, so
``idx`` and ``neigh_valid`` are compared bit for bit. The clouds lie on a
1/8 grid, symmetric about the origin, so the per-cloud centring offset is
exactly 0 and every squared distance is exact: many keys sit exactly on the
sphere (``d2 == f32(r * r)``, which the ball admits) and at equal distances.
"""

import copy
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myria3d_tpu.ops.knn import ball_query as jax_ball_query
from myria3d_tpu_torch import _ext
from myria3d_tpu_torch.models.model import build_net
from myria3d_tpu_torch.models.modules import pointnet2
from myria3d_tpu_torch.ops import cuda_knn
from myria3d_tpu_torch.ops.cuda_knn import (
    BALL_MAX_R2,
    ball_walk,
    knn_topk,
    knn_topk_plain,
    launch,
    list_size,
    x_order,
)
from myria3d_tpu_torch.ops.knn import ball_neighbours, ball_query, ball_r2, centred_clouds

torch.set_num_threads(1)


def _grid_clouds(seed, n_half=300, nq=200):
    """Three clouds of 2 * n_half keys on the 1/8 grid of [-1, 1]^3, each
    key beside its negation (the valid keys' mean is exactly 0), and nq
    grid queries: cloud 0 whole, cloud 1 with its last 100 keys padding
    (a symmetric pair each) and a fifth of its queries masked, cloud 2 with
    no valid key and no valid query."""
    rng = np.random.default_rng(seed)
    half = rng.integers(-8, 9, (3, n_half, 3)).astype(np.float32) / 8
    keys = np.concatenate([half, -half], axis=1)
    key_mask = np.ones((3, 2 * n_half), bool)
    key_mask[1, n_half - 50:n_half] = key_mask[1, -50:] = False
    keys[1, n_half - 50:n_half] = keys[1, -50:] = 7.0    # pads sit anywhere
    key_mask[2] = False
    queries = rng.integers(-8, 9, (3, nq, 3)).astype(np.float32) / 8
    query_mask = np.ones((3, nq), bool)
    query_mask[1] = rng.uniform(size=nq) < 0.8
    query_mask[2] = False
    return queries, keys, key_mask, query_mask


@pytest.mark.parametrize("k,radius,fewer,more", [
    (32, 0.25, True, False), (32, 0.5, True, True), (32, 1.0, False, True),
    (3, 0.5, False, True), (16, 0.375, True, True)])
def test_ball_route_matches_ball_query_and_jax(jax_search_on_its_kernel, k, radius, fewer,
                                               more):
    """The plain ball route, ``ball_neighbours`` and the generic
    ``ball_query`` agree bit for bit, and so does the JAX package's
    ``ball_query``: queries with fewer keys in the ball than k (``fewer``),
    with k or more (``more``), or both."""
    q, kp, km, qm = _grid_clouds(int(radius * 8) + k)
    t = [torch.from_numpy(a) for a in (q, kp, km, qm)]
    idx, nv = ball_neighbours(t[0], t[1], t[2], k, radius, query_mask=t[3])
    gidx, gd2, gnv = ball_query(t[0], t[1], t[2], k, radius, query_mask=t[3])
    assert torch.equal(idx, gidx) and torch.equal(nv, gnv)
    q4, k4 = centred_clouds(t[0], t[1], t[2])
    assert torch.equal(q4[..., :3], t[0])                       # the offset is exactly 0
    pidx, pd2 = knn_topk_plain(q4, k4, k, query_mask=t[3], r2=ball_r2(radius))
    assert torch.equal(pidx >= 0, nv) and torch.equal(torch.where(nv, pidx, 0), idx)
    assert torch.equal(torch.where(nv, pd2, float("inf")), torch.where(nv, gd2, float("inf")))
    assert bool((pd2[~nv] == float("inf")).all())
    jax_search_on_its_kernel()
    jidx, _, jnv = jax_ball_query(*(jnp.asarray(a) for a in (q, kp, km)), k, radius,
                                  query_mask=jnp.asarray(qm))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    counts = nv[0].sum(dim=1)
    assert (bool((counts < k).any()), bool((counts == k).any())) == (fewer, more)
    assert not bool(nv[2].any()) and not bool(nv[1][~t[3][1]].any())


def test_the_sphere_and_its_ties_are_inside_the_ball():
    """Keys exactly at d2 == f32(r * r) enter the ball; of equal distances
    the lower index comes first; a key just outside never enters."""
    q4 = torch.zeros((1, 1, 4))
    pts = [(0.5, 0, 0), (0, 0.5, 0), (0.5, 0.125, 0), (0, 0, -0.5), (0.25, 0, 0), (-0.5, 0, 0)]
    k4 = torch.tensor([[[*p, 0.0] for p in pts]], dtype=torch.float32)
    idx, d2 = knn_topk(q4, k4, 6, r2=ball_r2(0.5))
    assert idx.tolist() == [[[4, 0, 1, 3, 5, -1]]]
    assert d2.tolist() == [[[0.0625, 0.25, 0.25, 0.25, 0.25, float("inf")]]]


@pytest.mark.parametrize("radius", [0.05, 0.1, 0.3, 0.7, 1e5])
def test_ball_r2_is_the_bound_the_radius_filter_compares_with(radius):
    """``ball_r2`` is ``radius * radius`` rounded to f32, which is what
    ``d2 <= radius * radius`` compares a float32 d2 with (0.3 and 0.7 round
    up), and never reaches the d2 at which a key reads as padding."""
    r2 = ball_r2(radius)
    f = torch.tensor(r2, dtype=torch.float32)
    near = torch.stack([torch.nextafter(f, torch.tensor(0.0)), f,
                        torch.nextafter(f, torch.tensor(float("inf")))])
    if radius < 1e3:
        assert torch.equal(near <= radius * radius, near <= r2)
        assert torch.equal(near <= r2, torch.tensor([True, True, False]))
    else:
        assert r2 == BALL_MAX_R2 < 0.25 * cuda_knn.PAD_W ** 2


@pytest.mark.parametrize("k", [2, 3, 4])
def test_small_list_is_the_generic_lists_first_k(k):
    """k in [2, 4] takes the 4-slot list; its k nearest, ties included, are
    the generic list's first k."""
    q, kp, km, qm = _grid_clouds(11)
    q4, k4 = centred_clouds(*(torch.from_numpy(a) for a in (q, kp, km)))
    assert list_size(k) == 4
    idx, d2 = knn_topk(q4, k4, k, query_mask=torch.from_numpy(qm))
    gidx, gd2 = knn_topk_plain(q4, k4, 32)
    assert torch.equal(idx, gidx[..., :k]) and torch.equal(d2, gd2[..., :k])


def test_list_sizes():
    assert [list_size(k) for k in (1, 2, 3, 4, 5, 10, 15, 16, 17, 32)] == [
        1, 4, 4, 4, 32, 32, 32, 16, 32, 32]


def test_x_order_is_stable_with_masked_queries_last():
    q4 = torch.tensor([[[0.5, 0, 0, 0], [-1, 0, 0, 0], [0.5, 1, 0, 0], [-3, 0, 0, 0],
                        [0.25, 0, 0, 0]]])
    mask = torch.tensor([[True, True, True, False, True]])
    assert x_order(q4).tolist() == [[3, 1, 4, 0, 2]]
    assert x_order(q4, mask).tolist() == [[1, 4, 0, 2, 3]]
    assert x_order(q4).dtype == torch.int32
    # the ball route walks in x order where the queries fill more than one tile
    for nq, walks in ((cuda_knn.TILE_Q, False), (cuda_knn.TILE_Q + 1, True)):
        q = torch.rand((2, nq, 4))
        got = ball_walk(q)
        assert (got is not None) == walks
        if walks:
            assert torch.equal(got, x_order(q))


@pytest.mark.parametrize("k,radius", [(3, None), (16, None), (32, 0.5), (3, 0.5)])
def test_shuffled_query_rows_give_the_same_rows_shuffled(k, radius):
    """A query's neighbours do not depend on where its row lies (the ball
    route walks its queries in x order, the kNN route in row order): the
    queries and their mask shuffled per cloud give the same rows of output,
    shuffled alike."""
    q, kp, km, qm = _grid_clouds(4, n_half=300, nq=200)
    q4, k4 = centred_clouds(*(torch.from_numpy(a) for a in (q, kp, km)))
    qm = torch.from_numpy(qm)
    r2 = None if radius is None else ball_r2(radius)
    g = torch.Generator().manual_seed(k)
    perm = torch.stack([torch.randperm(200, generator=g) for _ in range(3)])
    want = knn_topk(q4, k4, k, query_mask=qm, r2=r2)
    got = knn_topk(torch.take_along_dim(q4, perm[..., None], dim=1), k4, k,
                   query_mask=torch.take_along_dim(qm, perm, dim=1), r2=r2)
    for a, w in zip(got, want):
        assert torch.equal(a, torch.take_along_dim(w, perm[..., None], dim=1))


@pytest.mark.parametrize("kw", [{"window": 512}, {"variant": "mxu"}])
def test_the_ball_route_is_k1s_full_scan_only(kw):
    """``r2`` with a window, or with K7, raises ``ValueError``, in the
    wrapper and in the plain version alike."""
    q, kp, km, _ = _grid_clouds(4, n_half=300, nq=200)
    q4, k4 = centred_clouds(*(torch.from_numpy(a) for a in (q, kp, km)))
    for fn in (knn_topk, knn_topk_plain):
        with pytest.raises(ValueError, match="full scan|K1's"):
            fn(q4, k4, 4, r2=0.25, **kw)


@pytest.mark.parametrize("r2,list_k", [(-1.0, None), (BALL_MAX_R2 * 1.01, None),
                                       (float("nan"), None), (0.25, 16), (None, 2),
                                       (None, 64)])
def test_routes_refuse_what_the_kernel_does_not_take(r2, list_k):
    """r2 outside [0, BALL_MAX_R2] (pad keys would enter the ball), a ball
    route on another list than 32 slots, or a kNN list that is none of
    ``LISTS``, raise ``ValueError`` before the card is asked for."""
    q4, k4 = torch.zeros((1, 8, 4)), torch.zeros((1, 8, 4))
    with pytest.raises(ValueError):
        launch(q4, k4, 3, r2=r2, list_k=list_k)
    if list_k is None:
        with pytest.raises(ValueError):
            knn_topk(q4, k4, 3, r2=r2)


def test_every_entry_points_argument_types_match_the_c_declaration():
    """ctypes passes a Python float as a double unless its argument is
    ``c_float``: each ``float`` parameter of an entry point (the ball
    route's r2) is bound as ``c_float``, each ``int`` as ``c_int`` and each
    pointer as ``c_void_p``."""
    kinds = {"*": _ext._P, "int": _ext._I, "float": _ext._F}
    for src in sorted(_ext.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            types = ["*" if "*" in p else p.split()[0] for p in params.split(",") if p.strip()]
            assert _ext._SIGNATURES[name] == [kinds[t] for t in types], name
    assert _ext._SIGNATURES["m3d_knn_topk"].count(_ext._F) == 1


def _old_ball_query(monkeypatch):
    """PointNet++'s set abstractions on the generic ``ball_query`` (the 32
    nearest keys, then the radius), as before the ball route."""
    def ball(query_pos, key_pos, key_mask, k, radius, query_mask=None):
        idx, _, neigh_valid = ball_query(query_pos, key_pos, key_mask, k, radius, query_mask)
        return idx, neigh_valid

    monkeypatch.setattr(pointnet2, "ball_neighbours", ball)


def _pn2_batch(n=1024):
    rng = np.random.default_rng(7)
    pos = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    pos[..., 2] = pos[..., 2] * 0.2 - 0.8
    x = rng.uniform(0, 1, (2, n, 9)).astype(np.float32)
    mask = np.arange(n)[None] < np.array([[n], [700]])
    return tuple(torch.from_numpy(a) for a in (x, pos, mask))


@pytest.mark.parametrize("train", [False, True])
def test_full_width_pointnet2_is_bit_equal_on_both_routes(monkeypatch, train):
    """A full-width PointNet++ (64/128/256/512, 32 neighbours) gives the same
    logits, and in training the same gradients and BN running stats, on the
    ball route (x-ordered centroids) as on the generic ``ball_query``."""
    x, pos, mask = _pn2_batch()
    torch.manual_seed(0)
    net = build_net("PointNet2", {"num_features": 9, "num_classes": 7})
    nets = {"new": net, "old": copy.deepcopy(net)}
    out = {}
    for route, m in nets.items():
        with monkeypatch.context() as mp:
            if route == "old":
                _old_ball_query(mp)
            m.train(train)
            gen = torch.Generator().manual_seed(3)
            if train:
                logits = m(x, pos, mask, gen)
                (logits[mask] ** 2).mean().backward()
                out[route] = [logits.detach()] + [p.grad for p in m.parameters()] + \
                    [b for b in m.buffers()]
            else:
                with torch.no_grad():
                    out[route] = [m(x, pos, mask, gen)]
    assert len(out["new"]) == len(out["old"])
    assert all(torch.equal(a, b) for a, b in zip(out["new"], out["old"]))
    assert bool(torch.isfinite(out["new"][0]).all())
