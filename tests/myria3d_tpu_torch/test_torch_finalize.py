"""The tile's one pass from merged logits to its output file
(``pctl/io/las.py::write_las_predictions`` over
``pctl/native::native_las_write_predictions``) held against the route it
replaced: the JAX package's ``native_logits_finalize`` (the softmax, the
class code and the entropy), the uncovered points' null probabilities,
null entropy and source classes, then ``write_las`` with the channels as
extra columns. Whole file against whole file, byte for byte: point formats
3, 6, 7 and 8, one thread, three and eight, points uncovered or none
covered, every probability, a subset or none, the class or the entropy
off, 0 points, fewer than a chunk and a chunk boundary plus 1, a NaN
coordinate, records the pack table cannot express, and LAZ."""

import dataclasses
import os

import numpy as np
import pytest

from myria3d_tpu.pctl.io.las import write_las as jax_write_las
from myria3d_tpu.pctl.native import native_logits_finalize as jax_logits_finalize
from myria3d_tpu_torch.pctl import native as native_mod
from myria3d_tpu_torch.pctl.dataset.synthetic_tile import write_production_tile
from myria3d_tpu_torch.pctl.dataset.utils import read_las_array
from myria3d_tpu_torch.pctl.io.las import read_las, write_las_predictions

CHUNK = native_mod.WRITE_CHUNK
N_POINTS = CHUNK + 1
CODES = np.array([1, 2, 3, 6, 9, 17, 64], np.uint8)
NAMES = ["unclassified", "ground", "vegetation", "building", "water", "bridge", "lasting"]
VERSIONS = {3: (1, 2), 6: (1, 4), 7: (1, 4), 8: (1, 4)}


@pytest.fixture(scope="module")
def tile(tmp_path_factory):
    """The production tile's f64 records (point format 8), its header, and
    merged logits of three magnitudes (a tie row and one-hot rows among
    them)."""
    path = str(tmp_path_factory.mktemp("tile") / "tile.las")
    write_production_tile(path, N_POINTS, 60.0)
    points, header = read_las_array(path, None)
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(N_POINTS, len(CODES))) * rng.choice([0.1, 3.0, 40.0], (N_POINTS, 1))
              ).astype(np.float32)
    logits[0] = 1.5
    logits[1:50] = -30.0
    logits[np.arange(1, 50), rng.integers(0, len(CODES), 49)] = 30.0
    return points, header, logits


def _channels(probas="all", pred=True, entropy=True):
    """The Interpolator's new dims: name -> class index, "class" or "entropy"."""
    names = {"all": NAMES, "subset": ["building", "ground", "water"], "none": []}[probas]
    channels = {name: NAMES.index(name) for name in names}
    if pred:
        channels["PredictedClassification"] = "class"
    if entropy:
        channels["entropy"] = "entropy"
    return channels


def _parent_route(path, points, header, logits, covered, channels):
    """``Interpolator.reduce_predictions_and_save``'s route before the one
    pass: the fused softmax, the uncovered points' fills, then
    ``write_las`` with the channels as extra columns."""
    kinds = set(channels.values())
    probas, preds, ent = jax_logits_finalize(logits, CODES, want_preds="class" in kinds,
                                             want_entropy="entropy" in kinds)
    if covered is not None:
        uncov = np.flatnonzero(~covered)
        probas[uncov] = 0.0
        if preds is not None and "Classification" in points.dtype.names:
            preds[uncov] = points["Classification"][uncov].astype(np.uint8)
        if ent is not None:
            ent[uncov] = 0.0
    columns = {"class": preds, "entropy": ent}
    extra = {name: probas[:, kind] if isinstance(kind, int) else columns[kind]
             for name, kind in channels.items()}
    jax_write_las(path, points, header=header, extra_dims="all", extra_columns=extra)


def _both(tmp_path, points, header, logits, covered, channels, threads=0, ext="las"):
    """The parent's file and the pass's file, as bytes; the pass's thread count."""
    want, got = str(tmp_path / f"parent.{ext}"), str(tmp_path / f"pass.{ext}")
    _parent_route(want, points, header, logits.copy(), covered, channels)
    io_s, used = write_las_predictions(got, points, header, logits, covered, CODES, channels,
                                       n_threads=threads)
    assert io_s >= 0.0
    with open(want, "rb") as f, open(got, "rb") as g:
        return f.read(), g.read(), used


def _covered(n, kind, seed=0):
    if kind == "all":
        return None
    if kind == "none":
        return np.zeros(n, bool)
    return np.random.default_rng(seed).random(n) > 0.05


def _format(header, fmt):
    return dataclasses.replace(header, point_format=fmt, version=VERSIONS[fmt])


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("fmt", [3, 6, 7, 8])
def test_the_pass_writes_the_parents_file(tile, tmp_path, fmt, threads):
    """A chunk boundary plus 1 point with some points uncovered, every
    probability, the class and the entropy: the same bytes. Format 3 takes
    the points' ScanAngle and Infrared as extra dims of their own, before
    the channels. Never more threads than chunks."""
    points, header, logits = tile
    want, got, used = _both(tmp_path, points, _format(header, fmt), logits,
                            _covered(N_POINTS, "some"), _channels(), threads)
    assert got == want
    assert used == min(threads, 2)


@pytest.mark.parametrize("pred,entropy", [(True, True), (True, False), (False, True),
                                          (False, False)])
@pytest.mark.parametrize("probas", ["all", "subset", "none"])
@pytest.mark.parametrize("coverage", ["all", "some", "none"])
def test_every_channel_set_and_coverage(tile, tmp_path, coverage, probas, pred, entropy):
    points, header, logits = tile
    n = 3000
    want, got, _ = _both(tmp_path, points[:n], header, logits[:n], _covered(n, coverage),
                         _channels(probas, pred, entropy), threads=3)
    assert got == want


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("n", [0, 1, 1000, CHUNK, CHUNK + 1])
def test_sizes_around_a_chunk(tile, tmp_path, n, threads):
    points, header, logits = tile
    want, got, used = _both(tmp_path, points[:n], header, np.ascontiguousarray(logits[:n]),
                            _covered(n, "some"), _channels(), threads)
    assert got == want
    assert used == min(threads, -(-n // CHUNK))


@pytest.mark.parametrize("axis", ["X", "Z"])
def test_a_nan_coordinate_in_the_bounds(tile, tmp_path, axis):
    """numpy's min and max of a column that holds a NaN are NaN: the
    header's bounds of that axis, from whichever thread met it."""
    points, header, logits = tile
    points = points.copy()
    points[axis][[7, N_POINTS - 3]] = np.nan
    want, got, _ = _both(tmp_path, points, header, logits, None, _channels(), threads=3)
    assert got == want


def test_return_numbers_outside_1_to_15_are_clipped_in_the_counts(tile, tmp_path):
    points, header, logits = tile
    points = points.copy()
    points["ReturnNumber"][::11] = 0
    points["ReturnNumber"][5::13] = 20
    want, got, _ = _both(tmp_path, points, header, logits, _covered(N_POINTS, "some"),
                         _channels(), threads=3)
    assert got == want


@pytest.mark.parametrize("case", ["f32_records", "no_classification", "own_entropy_field",
                                  "no_return_number"])
def test_points_the_pack_table_cannot_express_or_lacks(tile, tmp_path, case):
    """f32 coordinates (the pack table takes f64 only: numpy packs the
    points' fields and the pass writes the channels over them), no
    Classification (an uncovered point keeps the argmax's code), a field of
    the points named like a channel (the channel replaces it), and no
    ReturnNumber (every point counts as a first return)."""
    points, header, logits = tile
    n = 5000
    points = points[:n]
    names = list(points.dtype.names)
    if case == "f32_records":
        points = points.astype([(name, "<f4") for name in names])
    elif case == "own_entropy_field":
        extended = np.zeros(n, points.dtype.descr + [("entropy", "<f8"), ("height", "<f4")])
        for name in names:
            extended[name] = points[name]
        extended["entropy"], extended["height"] = 7.0, 2.5
        points = extended
    else:
        drop = {"no_classification": "Classification", "no_return_number": "ReturnNumber"}[case]
        points = points[[name for name in names if name != drop]]
    want, got, _ = _both(tmp_path, points, header, logits[:n], _covered(n, "some"),
                         _channels(), threads=3)
    assert got == want


@pytest.mark.parametrize("fmt", [3, 8])
def test_a_laz_output_is_the_parents_and_reads_back(tile, tmp_path, fmt):
    points, header, logits = tile
    header = _format(header, fmt)
    covered = _covered(N_POINTS, "some")
    want, got, _ = _both(tmp_path, points, header, logits, covered, _channels(), threads=3,
                         ext="laz")
    assert got == want
    write_las_predictions(str(tmp_path / "pass.las"), points, header, logits, covered, CODES,
                          _channels())
    las, laz = read_las(str(tmp_path / "pass.las")).points, read_las(str(tmp_path / "pass.laz")).points
    assert las.dtype == laz.dtype
    for name in las.dtype.names:
        np.testing.assert_array_equal(laz[name], las[name], err_msg=name)


def test_a_failed_write_raises_oserror(tile, tmp_path):
    """A descriptor the pass cannot write to: ``OSError`` with the errno."""
    points, header, logits = tile
    path = str(tmp_path / "read_only.las")
    open(path, "wb").close()
    fd = os.open(path, os.O_RDONLY)
    try:
        with pytest.raises(OSError):
            write = native_mod.native_las_write_predictions
            n = 100
            write(fd, 0, [], np.zeros(n * 8, np.uint8), n, 8,
                  np.ascontiguousarray(logits[:n]), None, CODES,
                  np.arange(len(CODES), dtype=np.int32) * 0 - 1, 0, -1,
                  [(points["X"][:n], points.strides[0], 9)] * 3
                  + [(np.ones(1, np.int64), 0, 7), None])
    finally:
        os.close(fd)
