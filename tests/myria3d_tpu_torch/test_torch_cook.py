"""The port's subtile front end (``pctl/dataset/utils.py::subtile_indices``,
``pctl/dataset/tile_stream.py::TileSampleStream`` and the native
``bin_windows_*`` and ``lidar_hd_rows`` of ``pctl/native``) held against
plain numpy on the CPU.

- The binning reads X/Y from the records as they are: f64 (``read_las_array``'s
  52-byte records, unaligned) or f32 (``read_las_array_as_float32``). Its
  offsets and indices equal the reference's per-window Chebyshev scan of a
  staged (n, 2) f64 copy less its minimum, with points on the windows'
  borders, at overlap 0 and 25, on one thread and on several.
- The rows-and-features call is bit-equal to ``lidar_hd_pre_transform``
  on the gathered rows, for several layouts and point formats.
- The cooked samples, the batches and ``predict()``'s output file are
  byte-equal between the native route and the numpy route.
"""

import os

import numpy as np
import numpy.lib.recfunctions as rfn
import pytest
import torch

from myria3d_tpu_torch import predict as predict_mod
from myria3d_tpu_torch.pctl import native as native_mod
from myria3d_tpu_torch.pctl.dataset.synthetic_tile import write_production_tile
from myria3d_tpu_torch.pctl.dataset.utils import (
    read_las_array,
    read_las_array_as_float32,
    subtile_indices,
)
from myria3d_tpu_torch.pctl.io.las import read_las, write_las
from myria3d_tpu_torch.pctl.points_pre_transform.lidar_hd import (
    lidar_hd_pre_transform,
    lidar_hd_pre_transform_rows,
)
from myria3d_tpu_torch.run import CONFIG_DIR, compose_config
from perfbench import run as perfbench_run

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_torch")
N_POINTS, EXTENT, SUBTILE = 20_000, 100.0, 50.0


@pytest.fixture(scope="module")
def tile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tile") / "production_tile.las")
    write_production_tile(path, N_POINTS, EXTENT)
    return path


def _layout(tile, layout):
    reader = read_las_array if layout == "f64" else read_las_array_as_float32
    return reader(tile, None)[0]


def _reference_windows(points, tile_width, overlap):
    """The reference's per-center Chebyshev scan of the staged (n, 2) f64
    copy less its minimum: (offsets, indices), x-major windows."""
    xy = np.stack([points["X"], points["Y"]], axis=1).astype(np.float64)
    xy -= xy.min(axis=0)
    radius, stride = SUBTILE // 2, SUBTILE - overlap
    centers = np.arange(SUBTILE / 2, tile_width + SUBTILE / 2 - overlap, step=stride)
    parts = [np.flatnonzero((np.abs(xy[:, 0] - cx) <= radius) & (np.abs(xy[:, 1] - cy) <= radius))
             for cx in centers for cy in centers]
    offsets = np.concatenate([[0], np.cumsum([len(p) for p in parts])])
    return centers, offsets, np.concatenate(parts)


def _grid_records(n, layout, seed=0):
    """``n`` records whose X/Y lie on a 0.5 m grid over 200 m, so that many
    sit on a window's border: f64 X/Y/Z (or f32) beside a u2 field."""
    rng = np.random.default_rng(seed)
    f = "<f8" if layout == "f64" else "<f4"
    pts = np.zeros(n, [("X", f), ("Y", f), ("Z", f), ("Intensity", "<u2")])
    pts["X"] = 650_000.0 + rng.integers(0, 401, n) * 0.5
    pts["Y"] = 100_000.0 + rng.integers(0, 401, n) * 0.5
    return pts


@pytest.mark.parametrize("overlap", [0, 25])
@pytest.mark.parametrize("layout", ["f64", "f32"])
def test_field_binning_equals_the_staged_scan(tile, layout, overlap):
    """The tile's records, f64 (unaligned 52-byte records) or f32."""
    points = _layout(tile, layout)
    assert points.dtype["X"] == np.dtype("<f8" if layout == "f64" else "<f4")
    centers, offsets, indices = _reference_windows(points, EXTENT, overlap)
    got = native_mod.native_bin_windows_fields(points, centers, SUBTILE // 2, SUBTILE - overlap)
    assert got is not None
    np.testing.assert_array_equal(got[0], offsets)
    np.testing.assert_array_equal(got[1], indices)


@pytest.mark.parametrize("overlap", [0, 25])
@pytest.mark.parametrize("layout", ["f64", "f32"])
def test_threaded_binning_keeps_each_window_ascending(layout, overlap):
    """2^20 + 12 345 records on a 0.5 m grid (borders hit), binned by
    several threads: the same offsets and indices as the staged scan."""
    points = _grid_records((1 << 20) + 12_345, layout)
    centers, offsets, indices = _reference_windows(points, 200.0, overlap)
    got = native_mod.native_bin_windows_fields(points, centers, SUBTILE // 2, SUBTILE - overlap)
    np.testing.assert_array_equal(got[0], offsets)
    np.testing.assert_array_equal(got[1], indices)


@pytest.mark.parametrize("overlap", [0, 25])
@pytest.mark.parametrize("layout", ["f64", "f32"])
def test_subtile_indices_equal_the_numpy_route(tile, layout, overlap, monkeypatch):
    """``subtile_indices`` on the native counting sort and on the numpy
    lexsort (the route for X/Y the native call refuses: its wrapper
    returning None) give the same subtiles, in the same order."""
    points = _layout(tile, layout)
    native = subtile_indices(points, EXTENT, SUBTILE, overlap)
    monkeypatch.setattr(native_mod, "native_bin_windows_fields", lambda *a: None)
    plain = subtile_indices(points, EXTENT, SUBTILE, overlap)
    assert len(native) == len(plain) == {0: 4, 25: 9}[overlap]
    for a, b in zip(native, plain):
        np.testing.assert_array_equal(a, b)


def _point_format(tile, tmp_path, fmt, drop):
    """The tile's records written in LAS point format ``fmt`` without the
    fields ``drop``, read back."""
    src = read_las(tile)
    header = src.header
    header.point_format = fmt
    path = str(tmp_path / f"format{fmt}.las")
    write_las(path, rfn.drop_fields(src.points, drop, usemask=False), header)
    points = read_las(path).points
    assert not set(drop) & set(points.dtype.names)
    return points


def _assert_bit_equal(got, want):
    assert set(got) == set(want)
    assert got["x_features_names"] == want["x_features_names"]
    for key in ("pos", "x", "y"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


@pytest.mark.parametrize("records", ["read_las_array", "all_f32", "format7_no_infrared",
                                     "format6_no_colors", "occluded_and_65280"])
def test_native_rows_are_bit_equal_to_the_gathered_transform(tile, tmp_path, records):
    """Every subtile of the tile, a permuted subset with repeats, and a
    single row: ``lidar_hd_pre_transform_rows(points, idx)`` is
    ``lidar_hd_pre_transform(points[idx])`` bit for bit."""
    if records == "all_f32":
        points = read_las_array_as_float32(tile, None)[0]
    elif records == "format7_no_infrared":
        points = _point_format(tile, tmp_path, 7, ("Infrared",))
    elif records == "format6_no_colors":
        points = _point_format(tile, tmp_path, 6, ("Red", "Green", "Blue", "Infrared"))
    else:
        points = read_las_array(tile, None)[0]
    rng = np.random.default_rng(11)
    if records == "occluded_and_65280":
        hit = rng.random(len(points)) < 0.3
        for color in ("Red", "Green", "Blue", "Infrared"):
            points[color][hit & (rng.random(len(points)) < 0.5)] = 65280
        points["ReturnNumber"][rng.random(len(points)) < 0.3] = 3
        points["ReturnNumber"][rng.random(len(points)) < 0.05] = 0
        assert ((points["ReturnNumber"] > 1) & (points["Red"] == 65280)).any()
    assert records != "read_las_array" or points.dtype.itemsize == 52
    lists = subtile_indices(points, EXTENT, SUBTILE, 25)
    lists += [rng.integers(0, len(points), 5000), np.array([len(points) - 1])]
    for idx in lists:
        got = lidar_hd_pre_transform_rows(points, idx)
        assert got is not None
        _assert_bit_equal(got, lidar_hd_pre_transform(points[idx]))


def test_a_color_above_65280_raises_the_transforms_error(tile):
    points = read_las_array(tile, None)[0]
    idx = subtile_indices(points, EXTENT, SUBTILE, 0)[1]
    points["Blue"][idx[7]] = 65281
    for build in (lambda: lidar_hd_pre_transform(points[idx]),
                  lambda: lidar_hd_pre_transform_rows(points, idx)):
        with pytest.raises(AssertionError, match="Blue max too high!"):
            build()


def test_records_the_call_cannot_read_fall_back(tile):
    """A 64-bit integer field, a missing Intensity, a big-endian X: None."""
    points = read_las_array(tile, None)[0]
    idx = np.arange(10)
    wide = points.astype([(n, "<i8" if n == "Classification" else points.dtype[n])
                          for n in points.dtype.names])
    swapped = points.astype([(n, ">f8" if n == "X" else points.dtype[n])
                             for n in points.dtype.names])
    for recs in (wide, rfn.drop_fields(points, ("Intensity",), usemask=False), swapped):
        assert lidar_hd_pre_transform_rows(recs, idx) is None
    assert native_mod.native_bin_windows_fields(swapped, np.array([25.0]), 25.0, 50.0) is None


def _loader(tile, overlap, batch=3):
    cfg = compose_config(CONFIG_DIR, "config.yaml", [
        "task.task_name=predict", "experiment=predict", f"predict.src_las={tile}",
        "predict.output_dir=unused", f"predict.ckpt_path={CKPT}", "datamodule.epsg=2154",
        f"datamodule.tile_width={int(EXTENT)}", f"datamodule.batch_size={batch}",
        f"predict.subtile_overlap={overlap}", "trainer.accelerator=cpu"])
    return cfg


def _assert_same_bytes(a, b, where="sample"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same_bytes(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_bytes(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, where


def _samples(tile, overlap, workers):
    points = read_las_array(tile, "2154")[0]
    dataset = predict_mod.tile_loader(_loader(tile, overlap), points).dataset
    dataset.workers, dataset.timings = workers, {}
    samples = list(dataset)
    return samples, dataset.timings, points


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("overlap", [0, 25])
def test_samples_and_counters_match_the_numpy_route(tile, overlap, workers, monkeypatch):
    """The predict transforms' ``TileSampleStream`` samples, every key
    (``idx_in_original_cloud`` and ``copies`` among them), byte-equal
    on the native cook and on the numpy route that inputs the native calls
    refuse take (their wrappers returning None: the lexsort binning, the
    gather, the numpy features and numpy GridSampling). ``cook_points``
    counts every subtile point; ``cook_points_native`` all of them on the
    native cook, none on the numpy route."""
    native, counted, points = _samples(tile, overlap, workers)
    total = sum(len(i) for i in subtile_indices(points, EXTENT, SUBTILE, overlap))
    assert counted["cook_points"] == counted["cook_points_native"] == total
    assert counted["pctl.bin"] > 0 and counted["pctl.cook"] > 0
    monkeypatch.setattr(native_mod, "native_bin_windows_fields", lambda *a: None)
    monkeypatch.setattr(native_mod, "native_lidar_hd_rows", lambda *a: None)
    monkeypatch.setattr(native_mod, "native_grid_sample", lambda *a: None)
    plain, counted, _ = _samples(tile, overlap, workers)
    assert counted["cook_points"] == total and counted["cook_points_native"] == 0
    assert len(native) == len(plain) == {0: 4, 25: 9}[overlap]
    assert all("copies" in s and "idx_in_original_cloud" in s for s in native)
    _assert_same_bytes(native, plain)


def test_predict_writes_the_same_file_on_both_cook_routes(tile, tmp_path, monkeypatch):
    """``predict()`` on the CPU with the native cook and with the numpy
    cook (the binning's and the features' native calls refused; the merge
    and the writer native on both): the same batches, the same phases'
    counts and the same output LAS, byte for byte."""
    outs, batches = {}, {}
    for route in ("native", "numpy"):
        if route == "numpy":
            monkeypatch.setattr(native_mod, "native_bin_windows_fields", lambda *a: None)
            monkeypatch.setattr(native_mod, "native_lidar_hd_rows", lambda *a: None)
        cfg = _loader(tile, 25)
        cfg["predict"]["output_dir"] = str(tmp_path / route)
        points = read_las_array(tile, "2154")[0]
        batches[route] = [(b.x, b.pos, b.mask, b.idx_in_original_cloud, b.copies)
                          for b in predict_mod.tile_loader(cfg, points)]
        phases = {}
        torch.manual_seed(0)
        outs[route] = predict_mod.predict(cfg, phases=phases, device="cpu")
        assert phases["cook_points"] == sum(
            len(i) for i in subtile_indices(points, EXTENT, SUBTILE, 25))
        assert phases["cook_points_native"] == (phases["cook_points"] if route == "native" else 0)
        assert phases["bin_s"] >= 0
    _assert_same_bytes(batches["native"], batches["numpy"], "batches")
    with open(outs["native"], "rb") as a, open(outs["numpy"], "rb") as b:
        assert a.read() == b.read()


def test_the_cook_native_share_reader():
    """None on a program without the counters (as an older program reports
    its phases), None when nothing was cooked, else the share over the
    window's tiles."""
    read = perfbench_run.load_reader("tile.cook_native_pct")
    old = {"streaming_s": 7.7, "loader_wait_s": 5.76, "cook_busy_s": 14.16,
           "merge_points": 17185131, "merge_points_native": 17185131}
    assert read({"phases": [old, old]}) is None
    assert read({"phases": []}) is None
    new = dict(old, bin_s=0.4, cook_points=17185131, cook_points_native=17185131)
    assert read({"phases": [new, new]}) == 100.0
    assert read({"phases": [new, dict(new, cook_points_native=0)]}) == 50.0
    assert read({"phases": [dict(new, cook_points=0, cook_points_native=0)]}) is None
