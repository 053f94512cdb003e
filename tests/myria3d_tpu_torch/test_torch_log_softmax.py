"""``return_logits: false``: both nets end in ``log_softmax`` of their f32
logits (``myria3d_tpu/models/modules/randla_net.py:561-563``,
``pointnet2.py:143-145``), held against the JAX package.

- The eval forward of both families against the JAX nets built with
  ``return_logits=False``, on weights carried over from a randomly
  initialised JAX model, deterministic decimation: within 1e-4 of the
  log-probabilities' scale (f32 sums in another order, as the slice tests).
- The train loss with ``return_logits: false`` equals the ``true`` run's
  within 1e-6 relative, and so do the gradients within 1e-5 of their
  tensor's scale plus 1e-6 of the net's largest gradient (the Linear
  biases that feed a BatchNorm have an exact-zero gradient, f32 noise on
  both runs): the criterion's ``log_softmax`` leaves log-probabilities as
  they are, as in JAX (``myria3d_tpu/models/criterion.py:47``).
- ``predict()`` on the CPU with a checkpoint saved with ``return_logits:
  false``: the probabilities agree with the ``true`` run's within 1e-3,
  and so does the class map except at near-ties (the two best
  probabilities of the ``true`` run within 2e-3), on at least 0.999 of the
  points. The full-cloud interpolation weighs the neighbours'
  log-probabilities where the other run weighs their logits: the two
  differ by each neighbour's log-sum-exp, so the finalize softmax gives
  nearly, not exactly, the same probabilities.
- The f16 wire format of ``Model.interp_step`` keeps the log-probabilities
  of confident points finite.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myria3d_tpu_torch import predict as predict_mod
from myria3d_tpu_torch import run
from myria3d_tpu_torch.models.model import Model, build_net
from myria3d_tpu_torch.pctl.io.las import read_las
from myria3d_tpu_torch.utils.checkpoint import load_checkpoint
from tests.myria3d_tpu_torch.test_torch_mixed_precision import (
    HP,
    JAX_NET,
    _batch,
    _no_dropout,
    _port_net,
    _torch,
    det_no_dropout,  # noqa: F401
    jax_vars,  # noqa: F401
)
from tests.myria3d_tpu_torch.test_torch_predict import CKPT, CLASSES, _overrides, small_tile  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(HP))
def test_eval_log_probabilities_match_jax(name, jax_vars, det_no_dropout,  # noqa: F811
                                          jax_search_on_its_kernel):
    jax_search_on_its_kernel()
    x, pos, mask, _ = _batch(3)
    jnet = JAX_NET[name](**HP[name], return_logits=False)
    params, stats = jax_vars[name]
    want = np.asarray(jax.jit(lambda p: jnet.apply(
        {"params": p, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(mask),
        train=False, rngs={"decimation": jax.random.PRNGKey(2)}))(params))[mask]
    net = _port_net(name, jax_vars, return_logits=False).eval()
    with torch.no_grad():
        got = net(*_torch(x, pos, mask))
        net.return_logits = True
        logits = net(*_torch(x, pos, mask))
    torch.testing.assert_close(got, torch.log_softmax(logits, -1), rtol=0, atol=0)
    got = got.numpy()[mask]
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name", list(HP))
def test_the_loss_is_the_logits_runs(name, jax_vars):  # noqa: F811
    x, pos, mask, y = _torch(*_batch(4))
    out = {}
    for return_logits in (True, False):
        net = _port_net(name, jax_vars, return_logits=return_logits)
        _no_dropout(net)
        model = Model(net)
        model.init_train_state()
        loss, _ = model.grad_step(x, pos, y, mask, torch.Generator().manual_seed(0))
        out[return_logits] = float(loss), {k: p.grad for k, p in net.named_parameters()}
    assert out[False][0] == pytest.approx(out[True][0], rel=1e-6)
    top = max(float(g.abs().max()) for g in out[True][1].values())
    for k, g in out[True][1].items():
        err = float((out[False][1][k] - g).abs().max())
        assert err <= 1e-5 * float(g.abs().max()) + 1e-6 * top, k


def test_predict_with_log_probabilities(small_tile, tmp_path):  # noqa: F811
    ckpt = tmp_path / "ckpt"
    shutil.copytree(CKPT, ckpt)
    hp = json.loads((ckpt / "hparams.json").read_text())
    hp["neural_net_hparams"]["return_logits"] = False
    (ckpt / "hparams.json").write_text(json.dumps(hp))
    assert load_checkpoint(str(ckpt)).net.return_logits is False
    res = {}
    for name, path in (("logits", CKPT), ("log_probs", str(ckpt))):
        cfg = run.compose_config(run.CONFIG_DIR, "config.yaml",
                                 _overrides(small_tile, tmp_path / name))
        cfg["predict"]["ckpt_path"] = path
        res[name] = read_las(predict_mod.predict(cfg, device="cpu")).points
    a, b = res["logits"], res["log_probs"]
    pa = np.stack([np.asarray(a[c], np.float64) for c in CLASSES], 1)
    pb = np.stack([np.asarray(b[c], np.float64) for c in CLASSES], 1)
    assert np.abs(pa - pb).max() <= 1e-3
    differ = np.asarray(a["PredictedClassification"]) != np.asarray(b["PredictedClassification"])
    assert differ.mean() <= 1e-3
    best_two = np.sort(pa[differ], axis=1)[:, -2:]
    assert (best_two[:, 1] - best_two[:, 0] <= 2e-3).all()


@pytest.mark.parametrize("name", list(HP))
def test_the_wire_keeps_confident_log_probabilities_finite(name):
    net = build_net(name, {**HP[name], "return_logits": False})
    with torch.no_grad():   # confident: logit gaps of hundreds
        net.fc_classif.weight.mul_(1e4)
    model = Model(net, interpolation_k=3).eval()
    x, pos, mask, _ = _torch(*_batch(5, b=1, n=256))
    full = model.interp_step(x, pos, mask, pos, pos, mask, torch.Generator().manual_seed(0))
    assert full.dtype == torch.float16
    logp = full.float()[mask]
    assert bool(torch.isfinite(logp).all()) and float(logp.min()) < -100.0
    probs = torch.softmax(logp, -1)
    assert bool(torch.isfinite(probs).all())
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
