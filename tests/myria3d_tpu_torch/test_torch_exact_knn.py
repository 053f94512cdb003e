"""``exact_knn``, the net hparam and ``predict.exact_knn``, held against the
JAX package on the CPU (``myria3d_tpu/models/modules/randla_net.py:435``,
``models/model.py:94,177-189,383-389``, ``predict.py:80-94``).

- the port's counterparts of ``tests/myria3d_tpu/models/test_exact_knn.py``;
- the exact net's eval forward, interp steps and train step against the
  JAX net with ``exact_knn=True``, on weights carried across with
  ``flax_to_torch_state_dict`` and deterministic decimation on both sides
  (``test_torch_slice.py``). The JAX exact search ranks by the norm
  expansion ``|q|^2 + |k|^2 - 2 q.k`` (``ops/knn.py:69-75``), whose
  rounding may reorder near-ties and moves inverse-distance weights by up
  to 1e-3; here it ranks by the squared differences the port sums
  (``jax_searches_by_differences``), so both sides select and weight the
  same neighbours. Tolerances: the slice tests' (logits rtol 1e-4 / atol
  1e-5; the train step as ``test_torch_train_slice``), and one f16
  rounding (rtol / atol 1e-3) between the interp steps' f16 outputs;
- on a cloud where the window hides true neighbours (a 1 x 100 x 1 strip,
  x-sorted: an x-slab as wide as the 8-th neighbour's distance holds more
  points than the window's margin), an ``exact_knn`` net with a window
  equals the net with ``knn_window: 0`` and differs from the windowed net
  (on the CPU JAX's fallback ignores the window, so this holds the port to
  itself);
- a checkpoint carries the flag; ``predict.exact_knn`` leaves K3's window
  and makes the two-op interpolation a full scan; PointNet++ refuses the
  hparam as the JAX dataclass does; ``Trainer.test`` sets it.
"""

import importlib
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myria3d_tpu.models.modules.randla_net as jax_rl
import myria3d_tpu_torch.models.modules.randla_net as port_rl
from myria3d_tpu.models.criterion import CrossEntropyLoss as JaxCrossEntropy
from myria3d_tpu.models.model import Model as JaxModel
from myria3d_tpu.models.model import TrainState
from myria3d_tpu.models.modules.randla_net import RandLANet as JaxRandLANet
from myria3d_tpu.pctl.dataset.toy_dataset import write_synthetic_toy_las
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch import predict as predict_mod
from myria3d_tpu_torch import run
from myria3d_tpu_torch.models.criterion import CrossEntropyLoss
from myria3d_tpu_torch.models.model import build_model, build_net
from myria3d_tpu_torch.ops import interpolate as port_interpolate
from myria3d_tpu_torch.ops import knn as port_knn
from myria3d_tpu_torch.ops import nn1 as port_nn1
from myria3d_tpu_torch.ops.cuda_knn import scans_window, stage_window
from myria3d_tpu_torch.ops.knn import knn_graph
from myria3d_tpu_torch.train import Trainer, TrainerConfig
from myria3d_tpu_torch.utils.checkpoint import load_checkpoint, state_dict_from_jax
from tests.myria3d_tpu_torch.test_torch_slice import (
    _jax_det_decimation,
    _port_det_decimation,
    _random_jax_variables,
)
from tests.myria3d_tpu_torch.test_torch_train_slice import _NoDropout

torch.set_num_threads(1)
jax_knn = importlib.import_module("myria3d_tpu.ops.knn")   # the package exports its function

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_torch")
B, N, M, K = 2, 256, 512, 8
HP = {"num_features": 9, "num_classes": 7, "num_neighbors": K, "decimation": 4,
      "return_logits": True, "knn_window": 4608, "sort_inputs": True}
STRIP_N, STRIP_WINDOW = 2048, 512
# the train step's points: at 256 the summit's BatchNorm sees two points,
# whose batch moments make its gradient ill-conditioned on both sides
TRAIN_N = 512


def _knn_single_by_differences(q4, k4, k, exact, recall_target):
    """``ops/knn.py::_knn_single`` ranking by summed squared differences."""
    diff = q4[:, None, :] - k4[None, :, :]
    neg_d, idx = jax.lax.top_k(-jnp.sum(diff * diff, axis=-1), k)
    return idx.astype(jnp.int32), -neg_d


@pytest.fixture
def jax_searches_by_differences(monkeypatch):
    monkeypatch.setattr(jax_knn, "_knn_single", _knn_single_by_differences)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def det_decimation(monkeypatch):
    monkeypatch.setattr(jax_rl, "random_decimation", _jax_det_decimation)
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)


def _model(**hp):
    torch.manual_seed(0)
    return build_model("RandLANet", {**HP, **hp}, lr=0.01)


def _clouds(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, N, 9)).astype(np.float32)
    pos = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    mask = np.arange(N)[None] < np.array([[N], [200]])
    y = rng.integers(0, 7, (B, N))
    y[~mask] = 65
    full_pos = rng.uniform(-1, 1, (B, M, 3)).astype(np.float32)
    full_mask = np.arange(M)[None] < np.array([[M], [400]])
    return x, pos, mask, y, full_pos, full_mask


def _strip(b=1, seed=5):
    """x-sorted clouds on a 1 x 100 x 1 strip: the 8 nearest keys span an
    x-slab that holds more sorted positions than a 512-key window leaves
    beside a query tile."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, 1, (b, STRIP_N)), rng.uniform(0, 100, (b, STRIP_N)),
                    rng.uniform(0, 1, (b, STRIP_N))], axis=-1).astype(np.float32)
    pos = np.take_along_axis(pos, np.argsort(pos[..., 0], axis=1)[..., None], axis=1)
    x = rng.uniform(0, 1, (b, STRIP_N, 9)).astype(np.float32)
    y = rng.integers(0, 7, (b, STRIP_N))
    return [torch.from_numpy(a) for a in (x, pos, np.ones((b, STRIP_N), bool), y)]


# ---------------------------------------------------------------------------
# the port's counterparts of tests/myria3d_tpu/models/test_exact_knn.py


def test_set_exact_knn_flips_the_net_flag_and_the_hparams():
    model = _model()
    assert model.net.exact_knn is False and model.exact_knn is False
    model.set_exact_knn(True)
    assert model.net.exact_knn is True and model.exact_knn is True
    assert model.hparams["neural_net_hparams"]["exact_knn"] is True
    assert model.net.search_window == 0 and model.net.knn_window == 4608
    model.set_exact_knn(False)
    assert model.net.exact_knn is False and model.net.search_window == 4608
    assert model.hparams["neural_net_hparams"]["exact_knn"] is False


def test_exact_forward_matches_the_full_scan_forward_on_the_cpu():
    """Where the window bites nothing (256 points), the exact net runs the
    default net's searches: the same logits, bit for bit."""
    x, pos, mask, y = (torch.from_numpy(a) for a in _clouds()[:4])
    model = _model(knn_window=0)
    _, want = model.eval_step(x, pos, y, mask, torch.Generator().manual_seed(2))
    model.set_exact_knn(True)
    _, got = model.eval_step(x, pos, y, mask, torch.Generator().manual_seed(2))
    assert torch.equal(got, want)


def test_exact_knn_config_knob_composes():
    cfg = run.compose_config(run.CONFIG_DIR, "config.yaml", ["predict.exact_knn=true"])
    assert cfg["predict"]["exact_knn"] is True
    assert cfg["predict"]["exact_interpolation"] is False   # orthogonal knobs


# ---------------------------------------------------------------------------
# against the JAX exact net


@pytest.mark.parametrize("fused", [False, True])
def test_exact_eval_forward_and_interp_step_match_jax(det_decimation,
                                                      jax_searches_by_differences, fused):
    """The eval forward and the interp step of an ``exact_knn`` net: the
    two-op interpolation (``fused=False``, a full scan under exact_knn) and
    K3's path (``fused=True``; no window set) against JAX's
    ``exact_interp_step`` / ``interp_step`` after ``set_exact_knn(True)``."""
    x, pos, mask, y, full_pos, full_mask = _clouds()
    jm = JaxModel(neural_net_class_name="RandLANet", neural_net_hparams=dict(HP),
                  criterion=JaxCrossEntropy(ignore_index=65))
    jm.set_exact_knn(True)
    assert jm.net.exact_knn is True
    params, stats = _random_jax_variables(jm.net, N)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=None)
    key = jax.random.PRNGKey(2)
    _, want_logits = jm.eval_step(state, x, pos, y, mask, key)
    step = jm.interp_step if fused else jm.exact_interp_step
    want_full = np.asarray(step(state, x, pos, mask, pos, full_pos, full_mask, key))

    model = _model()
    model.net.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    model.set_exact_knn(True)
    t = [torch.from_numpy(np.asarray(a)) for a in (x, pos, y, mask, full_pos, full_mask)]
    _, logits = model.eval_step(t[0], t[1], t[2], t[3])
    full = model.interp_step(t[0], t[1], t[3], t[1], t[4], t[5], fused=fused)
    np.testing.assert_allclose(logits.numpy()[mask], np.asarray(want_logits)[mask],
                               rtol=1e-4, atol=1e-5)
    # both steps ship f16: within one f16 rounding of each other
    np.testing.assert_allclose(full.float().numpy()[full_mask],
                               want_full[full_mask].astype(np.float32), rtol=1e-3, atol=1e-3)


def test_exact_train_step_matches_jax(jax_searches_by_differences, monkeypatch):
    """One train step of the ``exact_knn`` net (``fused_train_lfa: true``,
    which exact_knn overrides) against JAX's exact step: the loss, every
    gradient and the BN running stats, on the unfused route (the fused LFA
    is never called), with the train slice's tolerances."""
    n = TRAIN_N
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (B, n, 9)).astype(np.float32)
    pos = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    mask = np.arange(n)[None] < np.array([[n], [400]])
    y = rng.integers(0, 7, (B, n))
    y[~mask] = 65
    hp = {**HP, "exact_knn": True, "fused_train_lfa": True, "bn_momentum": 0.2}
    jnet = JaxRandLANet(**hp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rl, "random_decimation", _jax_det_decimation)
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        params, stats = _random_jax_variables(jnet, n)

        def loss_fn(p):
            logits, upd = jnet.apply(
                {"params": p, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(pos),
                jnp.asarray(mask), train=True, mutable=["batch_stats"],
                rngs={"decimation": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)})
            return JaxCrossEntropy()(logits, jnp.asarray(y)), upd["batch_stats"]

        (want_loss, want_stats), want_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    want_grads = flax_to_torch_state_dict(jax.device_get(want_grads), {})
    want_state = flax_to_torch_state_dict(jax.device_get(params), jax.device_get(want_stats))

    def no_fused_lfa(*args, **kwargs):
        raise AssertionError("the exact_knn net took the fused train LFA")

    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    monkeypatch.setattr(port_rl, "lfa_train", no_fused_lfa)
    net = build_net("RandLANet", hp)
    net.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    net.mlp_classif.dropout = [0.0, 0.0]
    net.train()
    t = [torch.from_numpy(np.asarray(a)) for a in (x, pos, mask, y)]
    loss = CrossEntropyLoss()(net(*t[:3]), t[3])
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    top = max(float(np.abs(g).max()) for g in want_grads.values())
    for k, p in net.named_parameters():
        want = np.array(want_grads[k])
        tol = 1e-3 * float(np.abs(want).max()) + 1e-5 * top
        assert float((p.grad - torch.from_numpy(want)).abs().max()) <= tol, k
    got_state = net.state_dict()
    for k, want in want_state.items():
        if k not in dict(net.named_parameters()):   # BN running stats
            np.testing.assert_allclose(got_state[k].numpy(), want, rtol=1e-4, atol=1e-5,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the window that hides neighbours


def test_the_strip_window_hides_true_neighbours():
    """The premise of the next tests: stage 1's windowed graph misses true
    neighbours on the strip (and the deeper stages scan every key)."""
    _, pos, mask, _ = _strip()
    window = stage_window(STRIP_WINDOW, STRIP_N)
    assert scans_window(window, STRIP_N) and not scans_window(
        stage_window(STRIP_WINDOW, STRIP_N // 4), STRIP_N // 4)
    idx_w, _, _ = knn_graph(pos, mask, K, window=window)
    idx_f, _, _ = knn_graph(pos, mask, K, window=0)
    missed = (idx_w.sort(-1).values != idx_f.sort(-1).values).any(-1).float().mean()
    assert float(missed) > 0.05


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_exact_knn_overrides_a_window_that_hides_neighbours(mode):
    """``exact_knn: true`` with ``knn_window`` 512 gives the logits (and in
    training the gradients) of ``knn_window: 0``, not those of the windowed
    net: every search scans every key."""
    x, pos, mask, y = _strip()
    hp = {"knn_window": STRIP_WINDOW, "sort_inputs": False, "fused_train_lfa": False}
    out = {}
    for name, extra in (("windowed", {}), ("exact", {"exact_knn": True}),
                        ("full", {"knn_window": 0})):
        model = _model(**{**hp, **extra})
        model.net.mlp_classif.dropout = [0.0, 0.0]
        model.net.train(mode == "train")
        with torch.set_grad_enabled(mode == "train"):
            logits = model.net(x, pos, mask, torch.Generator().manual_seed(3))
        if mode == "train":
            model.criterion(logits, y).backward()
            out[name] = torch.cat([p.grad.flatten() for p in model.net.parameters()])
        else:
            out[name] = logits
    assert torch.equal(out["exact"], out["full"])
    assert float((out["windowed"] - out["full"]).abs().max()) > 1e-3 * float(
        out["full"].abs().max())


def test_checkpoint_keeps_exact_knn(tmp_path):
    """A checkpoint whose hparams carry ``exact_knn: true`` (from the config,
    or written by ``set_exact_knn``) loads exact, and stays exact after
    ``set_sorted_window``."""
    x, pos, mask, _ = _strip()
    for name, model in (("hparam", _model(exact_knn=True)), ("set", _model())):
        if name == "set":
            model.set_exact_knn(True)
        path = model.save_checkpoint(str(tmp_path / name))
        loaded = load_checkpoint(path)
        assert loaded.exact_knn and loaded.net.exact_knn
        assert loaded.hparams["neural_net_hparams"]["exact_knn"] is True
        loaded.set_sorted_window(STRIP_WINDOW)
        assert loaded.net.search_window == 0
        full = load_checkpoint(path)
        full.set_exact_knn(False)
        with torch.no_grad():
            got = loaded.net(x, pos, mask, torch.Generator().manual_seed(4))
            want = full.net(x, pos, mask, torch.Generator().manual_seed(4))
        assert torch.equal(got, want)


def test_interp_step_windows_k3_but_not_the_exact_two_op_search():
    """``models/model.py:383-389``: under exact_knn the two-op interpolation
    (``exact_interpolation``) scans every key, K3's keeps the window; with
    the window hiding neighbours, K3's output is the windowed K3's, not the
    full scan's, and the two-op output does not depend on the window."""
    x, pos, mask, _ = _strip()
    full_pos, full_mask = pos + 0.01, mask
    out = {}
    for window in (STRIP_WINDOW, 0):
        model = _model(sort_inputs=False)
        model.set_sorted_window(window)
        model.set_exact_knn(True)
        for fused in (True, False):
            out[window, fused] = model.interp_step(x, pos, mask, pos, full_pos, full_mask,
                                                   torch.Generator().manual_seed(5),
                                                   fused=fused)
    with torch.no_grad():
        logits = model.net(x, pos, mask, torch.Generator().manual_seed(5))
    windowed = port_interpolate.knn_interpolate(
        logits, pos, mask, full_pos, full_mask, k=10, fused_payload=True,
        window=stage_window(STRIP_WINDOW, STRIP_N)).half()
    assert torch.equal(out[STRIP_WINDOW, False], out[0, False])
    assert torch.equal(out[STRIP_WINDOW, True], windowed)
    assert not torch.equal(out[STRIP_WINDOW, True], out[0, True])


@pytest.fixture(scope="module")
def small_tile(tmp_path_factory):
    """~1 500-point subtiles padded to 2 048: the sorted window bites."""
    path = str(tmp_path_factory.mktemp("tile") / "small_tile.las")
    return write_synthetic_toy_las(path, n_points=6000)


@pytest.mark.parametrize("exact_knn,exact_interpolation",
                         [(True, False), (True, True), (False, False)])
def test_predict_exact_knn_decides_the_interpolation_search(small_tile, tmp_path, monkeypatch,
                                                            exact_knn, exact_interpolation):
    """``predict()`` with the sorted window: ``predict.exact_knn`` makes
    every search of the net a full scan; the interpolation keeps K3's
    window without ``exact_interpolation`` and scans every key with it
    (``myria3d_tpu/predict.py:80-94``); without exact_knn stage 1 is
    windowed."""
    net_scans, interp_scans = [], []

    def spy(real, seen):
        def wrapped(*args, window=0, **kw):   # (..., q4, k4, k)
            seen.append(scans_window(window, args[-2].shape[1]))
            return real(*args, window=window, **kw)
        return wrapped

    monkeypatch.setattr(port_knn, "knn_topk", spy(port_knn.knn_topk, net_scans))
    monkeypatch.setattr(port_nn1, "knn_topk", spy(port_nn1.knn_topk, net_scans))
    monkeypatch.setattr(port_interpolate, "knn_interp",
                        spy(port_interpolate.knn_interp, interp_scans))
    cfg = run.compose_config(run.CONFIG_DIR, "config.yaml", [
        "task.task_name=predict", f"predict.src_las={small_tile}", f"predict.ckpt_path={CKPT}",
        f"predict.output_dir={tmp_path}", "datamodule.batch_size=2", "trainer.accelerator=cpu",
        f"predict.exact_knn={str(exact_knn).lower()}",
        f"predict.exact_interpolation={str(exact_interpolation).lower()}"])
    assert cfg["predict"]["sorted_window"] > 0
    assert os.path.isfile(predict_mod.predict(cfg))
    if exact_interpolation:   # the two-op search: the net's calls, then one a batch
        assert not interp_scans and not any(net_scans)
    elif exact_knn:
        assert interp_scans == [True, True] and net_scans and not any(net_scans)
    else:
        assert interp_scans == [True, True] and any(net_scans)


def test_pointnet2_refuses_exact_knn_as_the_jax_dataclass_does():
    pn2 = {"num_features": 9, "num_classes": 7}
    with pytest.raises(TypeError):
        build_model("PointNet2", {**pn2, "exact_knn": True})
    with pytest.raises(TypeError):
        JaxModel(neural_net_class_name="PointNet2", neural_net_hparams={**pn2, "exact_knn": True})
    # set_exact_knn on PointNet++: the interpolation's flag only, no hparam
    model = build_model("PointNet2", pn2)
    model.set_exact_knn(True)
    assert model.exact_knn and "exact_knn" not in model.hparams["neural_net_hparams"]


class _TestDataModule:
    batch_size = B

    def prepare_data(self, stage=None):
        pass

    def setup(self, stage=None):
        pass

    def test_dataloader(self):
        from myria3d_tpu_torch.pctl.batching import PointCloudBatch

        x, pos, mask, y = _clouds(3)[:4]
        yield PointCloudBatch(pos=pos, x=x, y=y.astype(np.int32), mask=mask,
                              num_valid=mask.sum(1).astype(np.int32),
                              idx_in_original_cloud=[None] * B, copies=[{} for _ in range(B)])


def test_trainer_test_sets_exact_knn():
    """``Trainer.test`` under ``predict.exact_knn`` calls ``set_exact_knn``
    (``myria3d_tpu/train.py:489-490``): the net scans every key."""
    trainer = Trainer(TrainerConfig(accelerator="cpu"))
    trainer.exact_knn = True
    trainer.sorted_window = 4608
    model = _model()
    out = trainer.test(model, _TestDataModule())
    assert np.isfinite(out["test/loss_epoch"])
    assert model.exact_knn and model.net.exact_knn and model.net.search_window == 0
