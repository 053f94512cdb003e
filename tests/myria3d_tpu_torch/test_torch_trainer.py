"""The port's train loop on the CPU at a small size: gradient accumulation,
the SIGTERM save and resume, the confusion-matrix metrics against the JAX
package, the redirect of the config's targets to the port (a target
without a counterpart raises), a fit with ``logger=comet`` and no
credentials, and what raises: several nodes without torchrun (the port
starts the ranks of one node) and what the JAX package refuses as well
(``remat`` on PointNet++, a compute dtype outside float32 / bfloat16 /
float16)."""

import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myria3d_tpu.callbacks.checkpoint_callbacks import ModelCheckpoint
from myria3d_tpu.callbacks.metric_callbacks import ModelMetrics as JaxModelMetrics
from myria3d_tpu.pctl.batching import PointCloudBatch
from myria3d_tpu_torch.callbacks.metric_callbacks import ModelMetrics
from myria3d_tpu_torch.models.model import build_model
from myria3d_tpu_torch.train import Trainer, TrainerConfig, build_trainer, port_targets

torch.set_num_threads(1)
B, N = 2, 256


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return PointCloudBatch(
        pos=rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
        x=rng.uniform(0, 1, (B, N, 9)).astype(np.float32),
        y=rng.integers(0, 7, (B, N)).astype(np.int32),
        mask=np.ones((B, N), bool), num_valid=np.full(B, N, np.int32),
        idx_in_original_cloud=[None] * B, copies=[{} for _ in range(B)],
    )


class FakeDataModule:
    batch_size = B

    def prepare_data(self, stage=None):
        pass

    def setup(self, stage=None):
        pass

    def train_dataloader(self, seed=None):
        return [_batch(0), _batch(1)]

    def val_dataloader(self):
        return [_batch(2)]


def _model(accumulate=1, fused="auto"):
    torch.manual_seed(0)
    model = build_model("RandLANet", {"num_features": 9, "num_classes": 7, "num_neighbors": 8,
                                      "fused_train_lfa": fused}, lr=0.01,
                        accumulate_grad_batches=accumulate)
    model.net.mlp_classif.dropout = [0.0, 0.0]
    return model


def _tensors(batch):
    return [torch.from_numpy(a) for a in (batch.x, batch.pos, batch.y.astype(np.int64), batch.mask)]


@pytest.mark.parametrize("fused", [False, True])
def test_accumulate_grad_batches_updates_every_k_on_the_mean_gradient(fused):
    """With ``accumulate_grad_batches=2`` the parameters stay put after the
    first batch and then take one Adam step on the mean of the two
    batches' gradients (optax ``MultiSteps``); BN stats move every batch."""
    model = _model(accumulate=2, fused=fused)
    ref = _model(fused=fused)
    ref.init_train_state()
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    grads = []
    for i, seed in enumerate((0, 1)):
        x, pos, y, mask = _tensors(_batch(seed))
        model.train_step(x, pos, y, mask, torch.Generator().manual_seed(i))
        ref.net.train()
        ref.optimizer.zero_grad()
        ref.criterion(ref.net(x, pos, mask, torch.Generator().manual_seed(i)), y).backward()
        grads.append([p.grad.clone() for p in ref.net.parameters()])
        if i == 0:
            params = dict(model.net.named_parameters())
            assert all(torch.equal(params[k], before[k]) for k in params)
            stats = [k for k in before if k.endswith("running_mean")]
            assert not all(torch.equal(model.net.state_dict()[k], before[k]) for k in stats)
    torch.manual_seed(0)
    check = _model(fused=fused)
    check.init_train_state()
    for p, g0, g1 in zip(check.net.parameters(), *grads):
        p.grad = (g0 + g1) / 2
    check.optimizer.step()
    for (name, p), q in zip(model.net.named_parameters(), check.net.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6, msg=name)
    assert model.step == 2


class _KillerLogger:
    """Sends SIGTERM to this process on the first step's log row."""

    def __init__(self):
        self.kills = 0

    def log_metrics(self, metrics, step=None):
        if "train/loss_step" in metrics and self.kills == 0:
            self.kills += 1
            os.kill(os.getpid(), signal.SIGTERM)


def test_sigterm_saves_last_checkpoint_and_resumes(tmp_path):
    """SIGTERM mid-epoch: the in-flight step finishes, the "last" checkpoint
    (weights, BN buffers, optimizer state, step) is written, the handlers
    are restored, and a fresh model resumes from it exactly."""
    prev = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    trainer = Trainer(TrainerConfig(max_epochs=5, accelerator="cpu"),
                      callbacks={"model_checkpoint": ModelCheckpoint(dirpath=str(tmp_path / "ck"))},
                      logger=_KillerLogger(), seed=0)
    model = trainer.fit(_model(), FakeDataModule())
    assert trainer.interrupted and trainer.global_step == 1 and model.step == 1
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == prev
    last = trainer.checkpoint_cb.last_model_path
    fresh = _model()
    fresh.restore_train_state(last)
    assert fresh.step == 1
    for (k, a), b in zip(model.net.state_dict().items(), fresh.net.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    saved = model.optimizer.state_dict()["state"]
    loaded = fresh.optimizer.state_dict()["state"]
    assert saved.keys() == loaded.keys()
    torch.testing.assert_close(saved[0]["exp_avg"], loaded[0]["exp_avg"], rtol=0, atol=0)


def test_fit_runs_sanity_val_limits_scheduler_and_early_stopping():
    """Sanity-val steps, ``limit_train_batches``, the val epoch, the plateau
    scheduler and early stopping, on a monitor (the epoch index, mode min)
    that never improves after epoch 0: both act after epoch 1."""
    from myria3d_tpu.callbacks.early_stopping import EarlyStopping
    from myria3d_tpu_torch.models.optimizers import ReduceLROnPlateau

    model = _model()
    model.monitor = "epoch"
    model.lr_scheduler_factory = lambda: ReduceLROnPlateau(patience=0, factor=0.5)
    trainer = Trainer(TrainerConfig(max_epochs=6, num_sanity_val_steps=1, limit_train_batches=1,
                                    accelerator="cpu"),
                      callbacks={"early_stopping": EarlyStopping(monitor="epoch", patience=1),
                                 "model_detailed_metrics": ModelMetrics(7)}, seed=0)
    trainer.fit(model, FakeDataModule())
    assert trainer.global_step == 2 and len(trainer.train_losses) == 2
    assert model.optimizer.param_groups[0]["lr"] == pytest.approx(0.005)


def test_metrics_match_jax():
    """The confusion matrix and every metric derived from it, with masked
    rows and out-of-range targets, equal the JAX package's."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 300, 5)).astype(np.float32)
    y = rng.integers(0, 5, (2, 300))
    y[0, :10] = 65
    mask = rng.uniform(size=(2, 300)) < 0.8
    names = {1: "a", 2: "b", 5: "c", 6: "d", 9: "e"}
    port, ref = ModelMetrics(5, names), JaxModelMetrics(5, names)
    for _ in range(2):
        port.update("val", torch.from_numpy(logits), torch.from_numpy(y), torch.from_numpy(mask))
        ref.update("val", jnp.asarray(logits), jnp.asarray(y), jnp.asarray(mask))
    np.testing.assert_array_equal(port.confusion_matrix("val"), ref.confusion_matrix("val"))
    got, want = port.compute_and_reset("val"), ref.compute_and_reset("val")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_config_targets_are_redirected_to_the_port():
    cfg = port_targets({
        "model": {"_target_": "myria3d_tpu.models.model.Model",
                  "optimizer": {"_args_": ["${get_method:myria3d_tpu.models.optimizers.adam}"]}},
        "cb": {"_target_": "myria3d_tpu.callbacks.checkpoint_callbacks.ModelCheckpoint"},
        "dm": {"_target_": "myria3d_tpu.pctl.datamodule.hdf5.HDF5LidarDataModule"},
        "tr": {"_target_": "myria3d_tpu.pctl.transforms.transforms.GridSampling"},
    })
    assert cfg["model"]["_target_"] == "myria3d_tpu_torch.models.model.build_model"
    assert cfg["model"]["optimizer"]["_args_"] == [
        "${get_method:myria3d_tpu_torch.models.optimizers.adam}"]
    assert cfg["cb"]["_target_"] == "myria3d_tpu_torch.callbacks.checkpoint_callbacks.ModelCheckpoint"
    assert cfg["dm"]["_target_"] == "myria3d_tpu_torch.data.HDF5LidarDataModule"
    assert cfg["tr"]["_target_"] == "myria3d_tpu_torch.pctl.transforms.transforms.GridSampling"
    ft = "myria3d_tpu.callbacks.finetuning_callbacks.FinetuningFreezeUnfreeze"
    assert port_targets({"_target_": ft})["_target_"] == (
        "myria3d_tpu_torch.callbacks.finetuning_callbacks.FinetuningFreezeUnfreeze")
    comet = "myria3d_tpu.callbacks.logging_callbacks.CometLogger"
    assert port_targets({"_target_": comet})["_target_"] == (
        "myria3d_tpu_torch.callbacks.logging_callbacks.CometLogger")
    missing = "myria3d_tpu.callbacks.logging_callbacks.NoSuchLogger"
    with pytest.raises(NotImplementedError, match=missing):
        port_targets({"_target_": missing})


def _fit_with_comet_logger():
    """``logger=comet`` without credentials composes and fits, as in the
    JAX package: the logger makes no experiment and no call."""
    trainer, model = build_trainer({
        "model": {"_target_": "myria3d_tpu.models.model.Model",
                  "neural_net_class_name": "RandLANet",
                  "neural_net_hparams": {"num_features": 9, "num_classes": 7,
                                         "num_neighbors": 8}},
        "trainer": {"accelerator": "cpu", "max_epochs": 1},
        "callbacks": {"model_detailed_metrics": {
            "_target_": "myria3d_tpu.callbacks.metric_callbacks.ModelMetrics",
            "num_classes": 7}},
        "logger": {"comet": {"_target_": "myria3d_tpu.callbacks.logging_callbacks.CometLogger",
                             "api_key": ""}}})
    trainer.fit(model, FakeDataModule())
    assert trainer.global_step == 2 and np.isfinite(trainer.train_losses).all()
    assert type(trainer.logger).__module__ == "myria3d_tpu_torch.callbacks.logging_callbacks"
    assert trainer.logger.experiment is None


@pytest.mark.parametrize("what", ["comet_logger", "pointnet2", "float64", "devices"])
def test_unported_parts_raise(what):
    # the Comet logger is ported: its case fits. What the JAX package
    # refuses too: an hparam PointNet++ lacks (its dataclass raises
    # TypeError) and a compute dtype outside its table (a KeyError there,
    # ValueError here)
    if what == "comet_logger":
        _fit_with_comet_logger()
        return
    expected = {"pointnet2": TypeError, "float64": ValueError}.get(what, NotImplementedError)
    with pytest.raises(expected):
        if what == "pointnet2":
            build_model("PointNet2", {"num_features": 9, "num_classes": 7, "remat": True})
        elif what == "float64":
            build_model("RandLANet", {"num_features": 9, "num_classes": 7, "dtype": "float64"})
        else:
            Trainer(TrainerConfig(devices=2, num_nodes=2, accelerator="cpu"))
