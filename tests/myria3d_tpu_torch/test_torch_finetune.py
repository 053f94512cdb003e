"""Finetuning in the port held against the JAX package: the staged-unfreeze
multipliers of ``FinetuningFreezeUnfreeze``, one finetune train step
against JAX ``build_train_step(...)(..., lr_mult)`` on both train routes,
the LR scale keeping the multipliers, the plateau scheduler with
``min_lr``, the finetune restore, and ``task.task_name=finetune`` through
the port's CLI.

The train step reuses ``test_torch_train_slice.py``'s setup: the full-width
net from the same random JAX variables, deterministic decimation and no
dropout (JAX's and torch's draws cannot match). Tolerances: multipliers
equal; frozen parameters (multiplier 0) bit-equal to before the step; the
others within 1e-5 absolute of the JAX step wherever the gradient is above
1e-5 of the net's largest (below that Adam's normalised step of an
f32-noise gradient is itself noise); scheduler scales equal.
"""

import json
import os
import subprocess
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myria3d_tpu.models.modules.randla_net as jax_rl
import myria3d_tpu_torch.models.modules.randla_net as port_rl
from myria3d_tpu.callbacks.finetuning_callbacks import FinetuningFreezeUnfreeze as JaxFinetuning
from myria3d_tpu.models.model import Model as JaxModel
from myria3d_tpu.models.model import TrainState
from myria3d_tpu.models.optimizers import ReduceLROnPlateau as JaxPlateau
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch.callbacks.finetuning_callbacks import FinetuningFreezeUnfreeze
from myria3d_tpu_torch.models.model import Model, build_model, build_net
from myria3d_tpu_torch.models.optimizers import OneCycleLR, ReduceLROnPlateau
from myria3d_tpu_torch.utils.checkpoint import load_state_dict, state_dict_from_jax
from tests.myria3d_tpu_torch.test_torch_slice import (
    _jax_det_decimation,
    _port_det_decimation,
    _random_jax_variables,
)
from tests.myria3d_tpu_torch.test_torch_train_slice import HPARAMS, LR, N, _batch, _NoDropout

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EPOCHS = (0, 3)   # the last FC alone; the FC head and the decoder damped


@pytest.fixture(scope="module")
def jax_vars():
    return _random_jax_variables(jax_rl.RandLANet(**HPARAMS, fused_train_lfa=False), N)


@pytest.mark.parametrize("lr_factor", [100.0, 10.0])
@pytest.mark.parametrize("epoch", range(5))
def test_multipliers_match_jax(jax_vars, epoch, lr_factor):
    """Every parameter's multiplier equals the one JAX gives its leaf,
    matched through ``flax_to_torch_state_dict``'s names."""
    params, _ = jax_vars
    want = JaxFinetuning(1, 3, lr_factor).lr_mult_for_epoch(params, epoch)
    want = flax_to_torch_state_dict(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), want, params), {})
    net = build_net("RandLANet", HPARAMS)
    got = FinetuningFreezeUnfreeze(1, 3, lr_factor).lr_mult_for_epoch(net, epoch)
    assert got.keys() == want.keys()
    for name, m in got.items():
        assert np.all(want[name] == np.float32(m)), name


@pytest.fixture(scope="module")
def jax_finetune_steps(jax_vars):
    """The JAX package's train step with the finetune multipliers of each
    of ``EPOCHS`` (unfused f32 route, no Pallas kernel on the CPU): the
    updated parameters as a torch state dict."""
    x, pos, mask, y = _batch()
    params, stats = jax_vars
    model = JaxModel("RandLANet", {**HPARAMS, "fused_train_lfa": False}, lr=LR)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=model.tx.init(params))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rl, "random_decimation", _jax_det_decimation)
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        step = jax.jit(model.build_train_step())
        for epoch in EPOCHS:
            mult = JaxFinetuning().lr_mult_for_epoch(params, epoch)
            new, _, _ = step(state, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(y),
                             jnp.asarray(mask), jax.random.PRNGKey(0), mult)
            out[epoch] = flax_to_torch_state_dict(jax.device_get(new.params), {})
        jax.clear_caches()
    return out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("epoch", EPOCHS)
def test_finetune_step_matches_jax(jax_vars, jax_finetune_steps, monkeypatch, epoch, fused):
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    x, pos, mask, y = (torch.from_numpy(np.asarray(a)) for a in _batch())
    net = build_net("RandLANet", {**HPARAMS, "fused_train_lfa": fused})
    net.load_state_dict(state_dict_from_jax(*jax_vars), strict=True)
    net.mlp_classif.dropout = [0.0, 0.0]
    model = Model(net, lr=LR)
    model.init_train_state(per_module=True)
    mults = FinetuningFreezeUnfreeze().lr_mult_for_epoch(net, epoch)
    model.set_lr_mult(mults)
    named = dict(net.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    grads = {}
    model.optimizer.register_step_pre_hook(
        lambda *_: grads.update({k: p.grad.clone() for k, p in named.items()}))
    model.train_step(x, pos, y, mask)

    top = max(float(g.abs().max()) for g in grads.values())
    want = jax_finetune_steps[epoch]
    assert {k for k, m in mults.items() if m == 1.0} == {"fc_classif.weight", "fc_classif.bias"}
    assert not torch.equal(named["fc_classif.weight"], before["fc_classif.weight"])
    for k, p in named.items():
        if mults[k] == 0.0:
            assert torch.equal(p, before[k]), k
            np.testing.assert_array_equal(want[k], before[k].numpy(), err_msg=k)
        else:
            moved = (grads[k].abs() > 1e-5 * top).numpy()
            np.testing.assert_allclose(p.detach().numpy()[moved], want[k][moved], rtol=0,
                                       atol=1e-5, err_msg=k)


def _small_model(**kw):
    torch.manual_seed(0)
    return build_model("RandLANet", {"num_features": 9, "num_classes": 7, "num_neighbors": 8},
                       lr=0.01, **kw)


def test_lr_scale_keeps_the_multipliers():
    """The plateau and one-cycle scales multiply each group's ``lr_mult``
    instead of overwriting it."""
    model = _small_model()
    model.init_train_state(per_module=True)
    model.set_lr_mult(FinetuningFreezeUnfreeze(lr_factor=10.0).lr_mult_for_epoch(model.net, 1))

    def lrs():
        return {g["name"]: g["lr"] for g in model.optimizer.param_groups}

    want = {"fc_classif": 1.0, "mlp_classif": 0.1}
    assert lrs() == {n: 0.01 * want.get(n, 0.0) for n in lrs()}
    plateau = ReduceLROnPlateau(patience=0)
    plateau.step(1.0)
    model.set_lr_scale(plateau.step(2.0))
    assert lrs() == {n: 0.01 * 0.5 * want.get(n, 0.0) for n in lrs()}
    cycle = OneCycleLR(epochs=1, steps_per_epoch=10)
    scale = cycle.step()
    model.set_lr_scale(scale)
    assert lrs() == {n: 0.01 * scale * want.get(n, 0.0) for n in lrs()}
    assert model.lr_scale == scale


def test_plateau_scheduler_matches_jax_with_min_lr():
    kw = dict(mode="min", factor=0.5, patience=2, cooldown=1, threshold=1e-3, min_lr=1e-5)
    port, ref = ReduceLROnPlateau(**kw), JaxPlateau(**kw)
    metrics = [1.0, 0.9, 0.95, 0.95, 0.91, 0.9, 0.8, 0.85, 0.85, 0.85, 0.85, 0.7, 0.9, 0.9,
               0.9, 0.9, 0.9, 0.9]
    assert [port.step(m) for m in metrics] == [ref.step(m) for m in metrics]
    assert port.scale < 1.0


def test_finetune_restore(tmp_path):
    """``restore_train_state(ckpt, optimizer=False)``: the checkpoint's
    weights and BN buffers, a fresh optimizer, the stored step (the JAX
    package's ``restore_into_state`` restores ``step``, which seeds the
    generators) and a fresh accumulation group (a fresh ``MultiSteps``
    state: with ``accumulate_grad_batches=2`` the update comes on the
    second batch after the restore); a plain resume continues the stored
    group."""
    from tests.myria3d_tpu_torch.test_torch_trainer import _batch as trainer_batch
    from tests.myria3d_tpu_torch.test_torch_trainer import _tensors

    src = _small_model(accumulate_grad_batches=2)
    src.net.mlp_classif.dropout = [0.0, 0.0]
    for i in range(3):
        src.train_step(*_tensors(trainer_batch(i)), torch.Generator().manual_seed(i))
    src.save_checkpoint(str(tmp_path / "ck"))
    stored = load_state_dict(str(tmp_path / "ck"))

    def restored(optimizer):
        model = _small_model(accumulate_grad_batches=2)
        model.net.mlp_classif.dropout = [0.0, 0.0]
        model.restore_train_state(str(tmp_path / "ck"), optimizer=optimizer)
        return model

    ft, resume = restored(False), restored(True)
    for k, v in ft.net.state_dict().items():
        assert torch.equal(v, stored[k]), k
    assert ft.step == resume.step == 3
    assert not ft.optimizer.state and resume.optimizer.state
    assert (ft.accum, resume.accum) == (0, 1)
    for model, moves in ((ft, False), (resume, True)):
        before = [p.detach().clone() for p in model.net.parameters()]
        model.train_step(*_tensors(trainer_batch(5)), torch.Generator().manual_seed(5))
        same = all(torch.equal(a, b) for a, b in zip(before, model.net.parameters()))
        assert same != moves



def test_fit_takes_groups_per_module_only_when_finetuning():
    """A fit keeps one parameter group (one optimizer update a step); a
    finetune fit has one group per top-level module, which ``set_lr_mult``
    needs."""
    from myria3d_tpu_torch.train import Trainer, TrainerConfig
    from tests.myria3d_tpu_torch.test_torch_trainer import FakeDataModule

    for finetune in (False, True):
        model = _small_model()
        Trainer(TrainerConfig(max_epochs=1, accelerator="cpu"), seed=0).fit(
            model, FakeDataModule(), finetune=finetune)
        names = [n for n, _ in model.net.named_parameters()]
        groups = model.optimizer.param_groups
        if finetune:
            tops = list(dict.fromkeys(n.split(".", 1)[0] for n in names))
            assert [g["name"] for g in groups] == tops and len(tops) > 1
        else:
            assert len(groups) == 1 and len(groups[0]["params"]) == len(names)
            with pytest.raises(ValueError, match="per_module"):
                model.set_lr_mult(dict.fromkeys(names, 1.0))


_CLI_RUN = r'''
import json, os, sys
from myria3d_tpu_torch.run import main
work, hdf5 = sys.argv[1], sys.argv[2]
common = ["dataset_description=toy_synthetic", f"datamodule.hdf5_file_path={hdf5}",
          "trainer.accelerator=cpu", "datamodule.num_workers=1", "logger=csv"]
fit = main(["task.task_name=fit", "experiment=RandLaNetDebug", f"hydra.run.dir={work}/fit"]
           + common)
ckpt = os.path.abspath(fit.checkpoint_cb.last_model_path)
ft = main(["task.task_name=finetune", "experiment=DebugFineTune", f"model.ckpt_path={ckpt}",
           f"hydra.run.dir={work}/ft"] + common)
assert "jax" not in sys.modules, "the finetune path imported jax"
print(json.dumps({"fit": ckpt, "ft": os.path.abspath(ft.checkpoint_cb.last_model_path),
                  "step": ft.global_step,
                  "losses": ft.train_losses}))
'''


def test_finetune_through_the_cli(tmp_path, toy_dataset_hdf5_path):
    """Fit one epoch on the toy HDF5, then ``task.task_name=finetune
    experiment=DebugFineTune`` from its checkpoint (one epoch: only the
    last FC trains): the encoder's and the decoder's parameters are
    bit-equal to the checkpoint's, the last FC's moved; no test after the
    finetune."""
    out = subprocess.run([sys.executable, "-c", _CLI_RUN, str(tmp_path), toy_dataset_hdf5_path],
                         cwd=REPO, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["step"] == 1 and np.isfinite(res["losses"]).all()
    before, after = load_state_dict(res["fit"]), load_state_dict(res["ft"])
    assert before.keys() == after.keys()
    params = [k for k in before if not k.endswith(("running_mean", "running_var"))]
    for k in params:
        if k.startswith("fc_classif."):
            assert not torch.equal(before[k], after[k]), k
        else:
            assert torch.equal(before[k], after[k]), k
    csv = (tmp_path / "ft" / "csv" / "version_0" / "metrics.csv").read_text()
    assert "train/loss_step" in csv and "test/" not in csv
