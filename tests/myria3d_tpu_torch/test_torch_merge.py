"""The port's overlap merge (``pctl.native.native_scatter_add_rows`` and
``Interpolator.store_predictions``) held bit for bit against ``np.add.at``
over the same calls: any index order, an index repeated within a subtile
or across the subtiles of a batch, f16 and f32 sources, one thread, two,
and more threads than rows; the coverage bytes beside the plane."""

import numpy as np
import pytest

from myria3d_tpu_torch.models.interpolation import Interpolator
from myria3d_tpu_torch.pctl import native as native_mod

N_POINTS, ROWS, C = 300, [90, 70, 50, 40], 7


def _native_or_skip():
    if native_mod.get_lib() is None:
        pytest.skip("no C++ toolchain for pctl_native")


def _indices(order: str, rng) -> list:
    """A batch's index lists: each subtile's rows are distinct points, in
    ascending order or permuted, unless a repeat is asked for."""
    idx = [np.sort(rng.choice(N_POINTS, n, replace=False)) for n in ROWS]
    if order != "ascending":
        idx = [rng.permutation(i) for i in idx]
    if order == "duplicate_in_subtile":
        for i in idx:
            i[1::7] = i[::7][: len(i[1::7])]
    elif order == "duplicate_across_subtiles":
        for i in idx[1:]:
            i[::3] = idx[0][: len(i[::3])]
    return idx


def _add_at(idx: list, src: list, plane=None, covered=None):
    plane = np.zeros((N_POINTS, C), np.float32) if plane is None else plane
    covered = np.zeros(N_POINTS, bool) if covered is None else covered
    for i, s in zip(idx, src):
        np.add.at(plane, i, s)
        covered[i] = True
    return plane, covered


@pytest.mark.parametrize("threads", [1, 2, 512])
@pytest.mark.parametrize("dtype", [np.float16, np.float32])
@pytest.mark.parametrize("order", ["ascending", "permuted", "duplicate_in_subtile",
                                   "duplicate_across_subtiles"])
def test_native_scatter_is_bit_equal_to_add_at(order, dtype, threads):
    """Two batches into a plane from ``np.empty`` (the first call zeroes
    it): the plane and the coverage bytes equal ``np.add.at``'s after each."""
    _native_or_skip()
    rng = np.random.default_rng(7)
    plane, covered = np.empty((N_POINTS, C), np.float32), np.empty(N_POINTS, bool)
    want = want_cov = None
    for call in range(2):
        idx = _indices(order, rng)
        src = [rng.normal(size=(len(i), C)).astype(dtype) for i in idx]
        if order.startswith("duplicate"):
            assert sum(map(len, idx)) > len(np.unique(np.concatenate(idx)))
        assert native_mod.native_scatter_add_rows(plane, idx, src, covered=covered,
                                                  zero=call == 0, n_threads=threads)
        want, want_cov = _add_at(idx, src, want, want_cov)
        np.testing.assert_array_equal(plane, want)
        np.testing.assert_array_equal(covered, want_cov)


@pytest.mark.parametrize("native", [True, False])
def test_padded_batches_merge_as_add_at(native, monkeypatch):
    """``store_predictions`` on padded (B, M, C) f16 logits whose subtiles
    each hold fewer than M rows (a ``None`` subtile among them), permuted
    and repeated across subtiles: the plane and the coverage equal
    ``np.add.at`` over each subtile's true rows, natively or not."""
    if native:
        _native_or_skip()
    else:
        monkeypatch.setattr(native_mod, "native_scatter_add_rows", lambda *a, **k: False)
    rng = np.random.default_rng(3)
    itp = Interpolator(classification_dict={k: str(k) for k in range(C)})
    itp.prepare(N_POINTS)
    want = want_cov = None
    for _ in range(2):
        idx = _indices("duplicate_across_subtiles", rng)
        logits = rng.normal(size=(len(idx) + 1, max(ROWS) + 16, C)).astype(np.float16)
        itp.store_predictions(logits, idx + [None])
        want, want_cov = _add_at(idx, [logits[b, :len(i)] for b, i in enumerate(idx)],
                                 want, want_cov)
    np.testing.assert_array_equal(itp.reduce_predicted_logits(N_POINTS), want)
    np.testing.assert_array_equal(itp._covered, want_cov)
    assert itp.merge_counts == {"merge_points": 2 * sum(ROWS),
                                "merge_points_native": 2 * sum(ROWS) if native else 0}


def test_the_stash_merges_as_add_at():
    """Without ``prepare()`` the batches are kept and merged at the end by
    the same scatter, in the order they came."""
    rng = np.random.default_rng(5)
    itp = Interpolator(classification_dict={k: str(k) for k in range(C)})
    want = None
    for _ in range(2):
        idx = _indices("duplicate_in_subtile", rng)
        logits = rng.normal(size=(len(idx), max(ROWS), C)).astype(np.float16)
        itp.store_predictions(logits, idx)
        want, _ = _add_at(idx, [logits[b, :len(i)] for b, i in enumerate(idx)], want)
    np.testing.assert_array_equal(itp.reduce_predicted_logits(N_POINTS), want)


def test_the_scatter_refuses_an_index_outside_the_plane():
    _native_or_skip()
    plane = np.zeros((N_POINTS, C), np.float32)
    src = [np.ones((2, C), np.float32)]
    for bad in (np.array([0, N_POINTS]), np.array([-1, 0])):
        with pytest.raises(ValueError, match="outside the plane"):
            native_mod.native_scatter_add_rows(plane, [bad], src)
