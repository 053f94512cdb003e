"""The port's tile route from logits to LAS (``models/interpolation.py`` over
``pctl/native``).

- The overlap merge (``native_scatter_add_rows`` and
  ``Interpolator.store_predictions``) is held bit for bit against
  ``np.add.at`` over the same calls: any index order, an index repeated
  within a subtile or across the subtiles of a batch, f16 and f32 sources,
  one thread, two, and more threads than rows; the coverage bytes beside the
  plane.
- The softmax, class and entropy of the one pass that writes the tile's
  file (``write_las_predictions``) are held against the JAX package's numpy
  chain.
- A tile starts with ``prepare``, and the host library builds or raises.
"""

import subprocess

import numpy as np
import pytest

from myria3d_tpu_torch.models.interpolation import Interpolator
from myria3d_tpu_torch.pctl import native as native_mod
from myria3d_tpu_torch.pctl.dataset.synthetic_tile import write_production_tile
from myria3d_tpu_torch.pctl.dataset.utils import read_las_array
from myria3d_tpu_torch.pctl.io.las import LasHeader, read_las, write_las_predictions

N_POINTS, ROWS, C = 300, [90, 70, 50, 40], 7


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
    rng = np.random.default_rng(7)
    plane, covered = np.empty((N_POINTS, C), np.float32), np.empty(N_POINTS, bool)
    want = want_cov = None
    for call in range(2):
        idx = _indices(order, rng)
        src = [rng.normal(size=(len(i), C)).astype(dtype) for i in idx]
        if order.startswith("duplicate"):
            assert sum(map(len, idx)) > len(np.unique(np.concatenate(idx)))
        native_mod.native_scatter_add_rows(plane, idx, src, covered=covered,
                                           zero=call == 0, n_threads=threads)
        want, want_cov = _add_at(idx, src, want, want_cov)
        np.testing.assert_array_equal(plane, want)
        np.testing.assert_array_equal(covered, want_cov)


@pytest.mark.parametrize("native", [True])
def test_padded_batches_merge_as_add_at(native):
    """``store_predictions`` on padded (B, M, C) f16 logits whose subtiles
    each hold fewer than M rows (a ``None`` subtile among them), permuted
    and repeated across subtiles: the plane and the coverage equal
    ``np.add.at`` over each subtile's true rows. The merge has one route,
    the native scatter, which ``native`` names."""
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
    assert itp.merge_counts == {"merge_points": 2 * sum(ROWS)}


def test_the_scatter_refuses_an_index_outside_the_plane():
    plane = np.zeros((N_POINTS, C), np.float32)
    src = [np.ones((2, C), np.float32)]
    for bad in (np.array([0, N_POINTS]), np.array([-1, 0])):
        with pytest.raises(ValueError, match="outside the plane"):
            native_mod.native_scatter_add_rows(plane, [bad], src)


@pytest.mark.parametrize("dtypes", [(np.float64,), (np.float16, np.float32)])
def test_the_scatter_refuses_sources_not_all_f16_or_all_f32(dtypes):
    plane = np.zeros((N_POINTS, C), np.float32)
    idx = [np.arange(2) for _ in dtypes]
    src = [np.ones((2, C), dt) for dt in dtypes]
    with pytest.raises(ValueError, match="all f16 or all f32"):
        native_mod.native_scatter_add_rows(plane, idx, src)
    assert not plane.any()


def _numpy_finalize(logits, reverse_mapper, want_preds, want_entropy):
    """``myria3d_tpu/models/interpolation.py``'s numpy chain: the stable
    softmax, the class code of the argmax, and H = log Z + max - sum(p *
    logit) clipped at 0."""
    m = logits.max(axis=1, keepdims=True)
    e = np.exp(logits - m)
    z = e.sum(axis=1, keepdims=True)
    probas = e / z
    preds = ent = None
    if want_preds:
        preds = reverse_mapper[np.argmax(probas, axis=1)].astype(np.uint8)
    if want_entropy:
        ent = (np.log(z[:, 0]) + m[:, 0] - np.einsum("nc,nc->n", probas, logits)).astype(np.float32)
        np.maximum(ent, 0.0, out=ent)
    return probas, preds, ent


@pytest.mark.parametrize("want_preds,want_entropy", [(True, True), (True, False), (False, True)])
def test_the_fused_finalize_equals_the_numpy_chain(want_preds, want_entropy, tmp_path):
    """Unit-scale random logits, a row of ties, and one-hot rows (whose
    entropy can round below 0 before the clip), through the one pass that
    writes the tile's file (``write_las_predictions``) and read back: the
    probabilities and the entropy within 1e-6, the classes equal, and only
    the dims asked for. Both sides round the entropy in f32, so their gap
    grows with the logits' scale (about one ulp of the largest logit)."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(5000, C)).astype(np.float32)
    logits[0] = 1.5
    logits[1:50] = -30.0
    logits[np.arange(1, 50), rng.integers(0, C, 49)] = 30.0
    reverse_mapper = np.array([1, 2, 3, 4, 5, 6, 64], np.int32)
    points = np.zeros(len(logits), [("X", "<f8"), ("Y", "<f8"), ("Z", "<f8"),
                                    ("Classification", "u1")])
    points["X"] = np.arange(len(logits))
    channels = {str(j): j for j in range(C)}
    if want_preds:
        channels["PredictedClassification"] = "class"
    if want_entropy:
        channels["entropy"] = "entropy"
    path = str(tmp_path / "finalized.las")
    write_las_predictions(path, points, LasHeader(point_format=6, version=(1, 4)), logits,
                          None, reverse_mapper.astype(np.uint8), channels)
    got = read_las(path).points
    want = _numpy_finalize(logits, reverse_mapper, want_preds, want_entropy)
    probas = np.stack([got[str(j)] for j in range(C)], axis=1)
    np.testing.assert_allclose(probas, want[0], rtol=0, atol=1e-6)
    assert ("PredictedClassification" in got.dtype.names) == want_preds
    assert ("entropy" in got.dtype.names) == want_entropy
    if want_preds:
        np.testing.assert_array_equal(got["PredictedClassification"], want[1])
    if want_entropy:
        np.testing.assert_allclose(got["entropy"], want[2], rtol=0, atol=1e-6)
        assert got["entropy"].min() >= 0.0


@pytest.mark.parametrize("call", ["store_predictions", "reduce_predictions_and_save"])
def test_a_tile_starts_with_prepare(call, tmp_path):
    """Before ``prepare``, a batch or a write raises the error that names
    ``prepare``, and touches no file."""
    itp = Interpolator(classification_dict={k: str(k) for k in range(C)})
    args = {"store_predictions": (np.zeros((1, 4, C), np.float16), [np.arange(4)]),
            "reduce_predictions_and_save": (str(tmp_path / "none.las"), str(tmp_path / "out"))}
    with pytest.raises(RuntimeError, match="prepare"):
        getattr(itp, call)(*args[call])
    assert not list(tmp_path.iterdir())


def test_a_prepared_tile_no_batch_reached_keeps_the_source_classes(tmp_path):
    """No batch after ``prepare``: every point is uncovered, so the output
    keeps the source classes, with null probabilities and null entropy.
    The next tile needs its own ``prepare``."""
    tile = str(tmp_path / "tile.las")
    write_production_tile(tile, 2000, 20.0)
    points, header = read_las_array(tile, None)
    names = ["unclassified", "ground", "vegetation", "building", "water", "bridge", "lasting"]
    itp = Interpolator(classification_dict=dict(zip([1, 2, 3, 6, 9, 17, 64], names)))
    itp.prepare(len(points), points=points, header=header)
    out = read_las(itp.reduce_predictions_and_save(tile, str(tmp_path / "out"), None)).points
    np.testing.assert_array_equal(out["PredictedClassification"], points["Classification"])
    for name in names + ["entropy"]:
        assert not np.asarray(out[name]).any(), name
    assert itp.merge_counts == {}
    with pytest.raises(RuntimeError, match="prepare"):
        itp.store_predictions(np.zeros((1, 4, C), np.float16), [np.arange(4)])


@pytest.mark.parametrize("getter", ["get_lib", "get_laz_lib"])
@pytest.mark.parametrize("error", ["no_compiler", "compile_error"])
def test_the_host_library_builds_or_raises_naming_gpp(getter, error, monkeypatch):
    """No g++ on the path, or g++ failing: ``RuntimeError`` naming g++ and
    carrying its error output, never a numpy route."""
    def fail(*args):
        if error == "no_compiler":
            raise FileNotFoundError(2, "No such file or directory", "g++")
        raise subprocess.CalledProcessError(1, ["g++"], stderr=b"error: 'uint8_t' was not declared")

    monkeypatch.setattr(native_mod, "_lib", None)
    monkeypatch.setattr(native_mod, "_laz_lib", None)
    monkeypatch.setattr(native_mod, "_build_so", fail)
    with pytest.raises(RuntimeError, match=r"g\+\+") as raised:
        getattr(native_mod, getter)()
    if error == "compile_error":
        assert "'uint8_t' was not declared" in str(raised.value)
