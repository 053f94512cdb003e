"""The whole train slice of the PyTorch port held against the JAX package:
one train step of the full-width RandLA-Net (32/128/256/512, K=16,
decimation 4, in-model x-sort with ``knn_window`` 4608, BN momentum 0.2)
from the same randomly initialised JAX variables, on both train routes of
the port (``fused_train_lfa`` True and False) against the JAX unfused f32
program; and ``Trainer.fit`` through the port's CLI.

Decimation is deterministic on both sides and dropout is off, as in
``test_torch_slice.py``: JAX's and torch's random draws cannot match.
Tolerances: loss 1e-5; BN running stats 1e-4 relative (1e-5 absolute);
every gradient within 1e-3 of its tensor's largest entry plus 1e-5 of the
net's largest gradient (f32 sums over ~1e5 edges in another order; the
encoder Linear biases sit right before BN and have an exact-zero gradient
that both sides only approximate); the Adam update within 1e-5 absolute
wherever the JAX gradient is above 1e-5 of the net's largest (below that
the normalised step m / (sqrt(v) + eps) of an f32-noise gradient is
itself noise).
"""

import json
import os
import subprocess
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import myria3d_tpu.models.modules.randla_net as jax_rl
import myria3d_tpu_torch.models.modules.randla_net as port_rl
from myria3d_tpu.models.criterion import CrossEntropyLoss as JaxCrossEntropy
from myria3d_tpu.models.modules.randla_net import RandLANet as JaxRandLANet
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch.models.model import Model, build_net
from myria3d_tpu_torch.utils.checkpoint import load_checkpoint, state_dict_from_jax
from tests.myria3d_tpu_torch.test_torch_slice import (
    _jax_det_decimation,
    _port_det_decimation,
    _random_jax_variables,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N, LR = 1280, 0.004
HPARAMS = {"num_features": 9, "num_classes": 7, "bn_momentum": 0.2, "knn_window": 4608,
           "sort_inputs": True}


class _NoDropout:
    def __init__(self, rate, deterministic=None):
        pass

    def __call__(self, x):
        return x


def _batch():
    rng = np.random.default_rng(21)
    pos = rng.uniform(-10.0, 10.0, (2, N, 3)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (2, N, 9)).astype(np.float32)
    mask = np.arange(N)[None] < np.array([[N], [1088]])
    y = rng.integers(0, 7, (2, N))
    y[~mask] = 65
    return x, pos, mask, y


@pytest.fixture(scope="module")
def jax_step():
    """Loss, gradients, updated BN stats and the Adam update of one JAX
    train step on the unfused f32 route (no Pallas kernel on the CPU)."""
    x, pos, mask, y = _batch()
    jnet = JaxRandLANet(**HPARAMS, fused_train_lfa=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rl, "random_decimation", _jax_det_decimation)
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        params, stats = _random_jax_variables(jnet, N)

        def loss_fn(p):
            logits, upd = jnet.apply(
                {"params": p, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(pos),
                jnp.asarray(mask), train=True, mutable=["batch_stats"],
                rngs={"decimation": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)})
            return JaxCrossEntropy()(logits, jnp.asarray(y)), upd["batch_stats"]

        (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        jax.clear_caches()
    tx = optax.adam(LR)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    as_torch = lambda p, s: flax_to_torch_state_dict(jax.device_get(p), jax.device_get(s))  # noqa: E731
    return dict(batch=(x, pos, mask, y), params=params, stats=stats, loss=float(loss),
                grads=as_torch(grads, {}), new_state=as_torch(new_params, new_stats))


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_matches_jax(jax_step, monkeypatch, fused):
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    x, pos, mask, y = (torch.from_numpy(np.asarray(a)) for a in jax_step["batch"])
    net = build_net("RandLANet", {**HPARAMS, "fused_train_lfa": fused})
    net.load_state_dict(state_dict_from_jax(jax_step["params"], jax_step["stats"]), strict=True)
    net.mlp_classif.dropout = [0.0, 0.0]
    model = Model(net, lr=LR)
    model.init_train_state()
    net.train()
    loss = model.criterion(net(x, pos, mask), y)
    loss.backward()
    named = dict(net.named_parameters())
    grads = {k: p.grad.clone() for k, p in named.items()}
    model.optimizer.step()

    assert float(loss.detach()) == pytest.approx(jax_step["loss"], rel=1e-5)
    want_grads = jax_step["grads"]
    assert grads.keys() == want_grads.keys()
    top = max(float(np.abs(g).max()) for g in want_grads.values())
    for k, g in grads.items():
        want = want_grads[k]
        tol = 1e-3 * float(np.abs(want).max()) + 1e-5 * top
        assert float((g - torch.from_numpy(np.array(want))).abs().max()) <= tol, k
    state = net.state_dict()
    for k, want in jax_step["new_state"].items():
        got = state[k].numpy()
        if k in named:
            moved = np.abs(want_grads[k]) > 1e-5 * top
            np.testing.assert_allclose(got[moved], want[moved], rtol=0, atol=1e-5, err_msg=k)
        else:   # BN running stats
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=k)


def test_fit_through_the_cli_writes_a_checkpoint_predict_loads(tmp_path, toy_dataset_hdf5_path):
    """``python -m myria3d_tpu_torch.run task.task_name=fit`` on the toy HDF5
    (two train steps, one val batch, CPU): finite losses in the CSV log, the
    best and last checkpoints with their optimizer state, a checkpoint the
    predict path loads, and no JAX in the process."""
    run_dir = tmp_path / "run"
    code = (
        "import sys, json\n"
        "from myria3d_tpu_torch.run import main\n"
        "t = main(sys.argv[1:])\n"
        "assert 'jax' not in sys.modules, 'the fit path imported jax'\n"
        "print(json.dumps({'losses': t.train_losses, 'step': t.global_step,\n"
        "                  'best': t.checkpoint_cb.best_model_path}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, "task.task_name=fit", "experiment=RandLaNetDebug",
         "dataset_description=toy_synthetic", "logger=csv", "trainer.limit_train_batches=2",
         "trainer.accelerator=cpu", f"datamodule.hdf5_file_path={toy_dataset_hdf5_path}",
         "datamodule.num_workers=1", f"hydra.run.dir={run_dir}"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["step"] == 2 and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"]))
    for name in ("last", os.path.basename(res["best"])):
        ckpt = run_dir / "checkpoints" / name
        assert {"state_dict.npz", "hparams.json", "train_state.pt"} <= set(os.listdir(ckpt))
    csv = (run_dir / "csv" / "version_0" / "metrics.csv").read_text()
    assert "train/loss_step" in csv and "val/loss_epoch" in csv
    model = load_checkpoint(str(run_dir / "checkpoints" / "last"))
    assert not model.training and model.net.knn_window == 0
    stored = torch.load(run_dir / "checkpoints" / "last" / "train_state.pt", weights_only=True)
    assert stored["step"] == 2 and stored["optimizer"]["state"]
