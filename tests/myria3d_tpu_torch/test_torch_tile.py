"""The whole ``predict()`` of the port held against the JAX package's on a
small tile with production statistics, on the CPU.

The tile is the port's ``write_production_tile`` (a copy of
``bench_e2e._ensure_tile``): 40 000 points over 100 m, four 50 m subtiles
(about 3 600 sampled and 9 600 full points each, padded to 4096 and
16384). Both packages predict it with the toy checkpoint
(``randlanet_toy_V0.5.0_ckpt`` and its conversion ``_torch``) at
``experiment=predict``'s ``sorted_window: 4608``, at
``predict.subtile_overlap`` 0 (one batch of 4) and 25 (nine subtiles, three
batches of 3, so that no batch carries filler rows).

Decimation is deterministic on both sides (``test_torch_slice.py``). The
JAX package's searches take the full scan of its kernel with one bin per
key (``conftest.jax_search_on_its_kernel``), run as the XLA scan
``conftest.jax_exact_scan``, held bit-equal to the interpreted kernel
here; its interpolation takes its f32 two-op path (the port's K3 weighs in
f32 too), and it predicts on one device, as the port's CPU predict does.

Tolerances: the class map agrees on at least 0.999 of the points; every
probability and the entropy within 2e-3: the logits cross to the host in
float16, whose ulp is 2^-8 for a logit in [4, 8), and one ulp moves a
probability by up to p (1 - p) 2^-8 ~ 1e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_e2e
import myria3d_tpu.models.modules.randla_net as jax_rl
import myria3d_tpu.parallel
import myria3d_tpu_torch.models.modules.randla_net as port_rl
from myria3d_tpu.ops import pallas_knn
from myria3d_tpu.ops.knn import _augment_keys, _augment_queries
from myria3d_tpu.predict import predict as jax_predict
from myria3d_tpu.utils import config as jax_config
from myria3d_tpu_torch import predict as predict_mod
from myria3d_tpu_torch.pctl.dataset.synthetic_tile import write_production_tile
from myria3d_tpu_torch.pctl.io.las import read_las
from myria3d_tpu_torch.run import CONFIG_DIR, compose_config
from tests.myria3d_tpu_torch.conftest import jax_exact_scan, route_jax_searches
from tests.myria3d_tpu_torch.test_torch_slice import _jax_det_decimation, _port_det_decimation

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TORCH_CKPT = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_torch")
JAX_CKPT = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_ckpt")
N_POINTS, EXTENT = 40_000, 100.0
BATCH = {0: 4, 25: 3}           # predict.subtile_overlap -> datamodule.batch_size
PROBA_ATOL = 2e-3
AGREEMENT = 0.999
PHASE_KEYS = {"tile_read_s", "streaming_s", "fetch_blocked_s", "merge_s", "n_batches",
              "finalize_write_s", "finalize_coverage_s", "finalize_softmax_s"}


@pytest.fixture(scope="module")
def tile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tile") / "production_tile.las")
    write_production_tile(path, N_POINTS, EXTENT)
    return path


def test_the_tile_is_bench_e2es(tile, tmp_path):
    """``write_production_tile`` writes what ``bench_e2e._ensure_tile``
    writes: the same point records, header and VLRs, byte for byte."""
    want = str(tmp_path / "bench_e2e_tile.las")
    bench_e2e._ensure_tile(want, N_POINTS, EXTENT)
    got, ref = read_las(tile).points, read_las(want).points
    assert got.dtype == ref.dtype and len(got) == N_POINTS
    for name in ref.dtype.names:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    with open(tile, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("b,nq,nk,k", [(2, 700, 1000, 16), (3, 1280, 600, 10), (2, 300, 1024, 1)])
def test_the_exact_scan_is_the_interpreted_kernel(b, nq, nk, k):
    """``jax_exact_scan`` returns the interpreted kernel's indices and
    distances bit for bit, on keys snapped to a 1/64 grid (ties), queries
    on keys and a cloud with masked keys."""
    rng = np.random.default_rng(nq)
    qp = rng.uniform(-1, 1, (b, nq, 3)).astype(np.float32)
    kp = (np.round(rng.uniform(-1, 1, (b, nk, 3)) * 64) / 64).astype(np.float32)
    qp[:, :50] = kp[:, :50]
    km = np.arange(nk)[None] < np.array([nk - 77] + [nk] * (b - 1))[:, None]
    q4 = _augment_queries(jnp.asarray(qp))
    k4 = _augment_keys(jnp.asarray(kp), jnp.asarray(km))
    want = pallas_knn.knn_topk_pallas(q4, k4, k, interpret=True, tile_q=128,
                                      bins=-(-nk // 128) * 128)
    got = jax.jit(jax_exact_scan, static_argnums=2)(q4, k4, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _overrides(tile, out_dir, overlap):
    return ["task.task_name=predict", "experiment=predict", f"predict.src_las={tile}",
            f"predict.output_dir={out_dir}", f"predict.subtile_overlap={overlap}",
            "datamodule.epsg=2154", f"datamodule.tile_width={int(EXTENT)}",
            f"datamodule.batch_size={BATCH[overlap]}", "hydra.run.dir=run"]


@pytest.fixture(scope="module")
def predictions(tile, tmp_path_factory):
    """``run(overlap)``: both packages' ``predict()`` of the tile, once per
    overlap: ((JAX's LAS points, its phases), (the port's), class names)."""
    done = {}

    def run(overlap):
        if overlap not in done:
            out = tmp_path_factory.mktemp(f"overlap{overlap}")
            jcfg = jax_config.compose(CONFIG_DIR, "config.yaml", _overrides(
                tile, str(out / "jax"), overlap) + [f"predict.ckpt_path={JAX_CKPT}"])
            pcfg = compose_config(CONFIG_DIR, "config.yaml", _overrides(
                tile, str(out / "port"), overlap) + [f"predict.ckpt_path={TORCH_CKPT}"])
            assert pcfg["predict"]["sorted_window"] == 4608
            jax_phases, port_phases = {}, {}
            jax_out = jax_predict(jcfg, phases=jax_phases)
            port_out = predict_mod.predict(pcfg, phases=port_phases, device="cpu")
            names = list(pcfg["predict"]["interpolator"]["classification_dict"].values())
            done[overlap] = ((read_las(jax_out).points, jax_phases),
                             (read_las(port_out).points, port_phases), names)
        return done[overlap]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rl, "random_decimation", _jax_det_decimation)
        mp.setattr(port_rl, "random_decimation", _port_det_decimation)
        route_jax_searches(mp, jax_exact_scan)
        mp.setattr(pallas_knn, "interp_pallas_available", lambda *a, **k: False)
        mp.setattr(myria3d_tpu.parallel, "auto_parallel", lambda *a, **k: None)
        yield run
    jax.clear_caches()


@pytest.mark.parametrize("overlap", [0, 25])
def test_predict_matches_the_jax_package(predictions, overlap):
    (want, jax_phases), (got, port_phases), names = predictions(overlap)
    assert port_phases["n_batches"] == jax_phases["n_batches"] == {0: 1, 25: 3}[overlap]
    assert len(got) == len(want) == N_POINTS
    assert got.dtype.names == want.dtype.names
    for name in ("X", "Y", "Z", "Classification"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    agree = np.mean(got["PredictedClassification"] == want["PredictedClassification"])
    assert agree >= AGREEMENT, agree
    for name in names + ["entropy"]:
        np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                   np.asarray(want[name], np.float64),
                                   rtol=0, atol=PROBA_ATOL, err_msg=name)
    covered = np.abs(np.stack([got[n] for n in names], 1).sum(1) - 1.0) <= 1e-3
    assert covered.mean() > 0.9


def test_predict_phases_as_the_jax_package_reports_them(predictions):
    """The keys of ``myria3d_tpu/predict.py:183-195`` (the Interpolator's
    ``finalize_*`` phases among them), every time rounded to 2 decimals."""
    (_, want), (_, got), _ = predictions(0)
    assert set(want) == PHASE_KEYS
    assert set(got) == set(want)
    for key, value in got.items():
        assert value == round(value, 2), (key, value)
