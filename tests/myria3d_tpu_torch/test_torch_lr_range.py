"""The port's LR range test held against the JAX package's
``lr_range_test``: stub models on both sides return the same scripted
losses, and the suggestions are float-equal (a decreasing sequence, one
that diverges after step 10, a NaN at step 4, fewer than 3 points). Under
one-cycle the port's learning rate at step i is ``lr_i`` times the JAX
class's optax schedule at i (within 1e-6 relative: optax computes it in
float32). A real tiny model's sweep gives a finite suggestion and leaves
the net's state dict, the step and the optimizer as they were; ``train()``
with ``task.auto_lr_find`` fits from the suggestion.
"""

import math
import types

import numpy as np
import pytest
import torch

import myria3d_tpu_torch.train as port_train
from myria3d_tpu.models.optimizers import OneCycleLR as JaxOneCycle
from myria3d_tpu.train import lr_range_test as jax_lr_range_test
from myria3d_tpu_torch.models.model import Model, build_model
from myria3d_tpu_torch.models.optimizers import OneCycleLR
from myria3d_tpu_torch.pctl.batching import PointCloudBatch
from myria3d_tpu_torch.train import Trainer, lr_range_test, train

torch.set_num_threads(1)
B, N = 2, 256


def _batch(seed):
    rng = np.random.default_rng(seed)
    return PointCloudBatch(
        pos=rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
        x=rng.uniform(0, 1, (B, N, 9)).astype(np.float32),
        y=rng.integers(0, 7, (B, N)).astype(np.int32),
        mask=np.ones((B, N), bool), num_valid=np.full(B, N, np.int32),
        idx_in_original_cloud=[None] * B, copies=[{} for _ in range(B)])


class FakeDataModule:
    batch_size = B

    def __init__(self, **_):
        pass

    def prepare_data(self, stage=None):
        pass

    def setup(self, stage=None):
        pass

    def train_dataloader(self, seed=None):
        return [_batch(i) for i in range(3)]


class JaxStub:
    """What the JAX ``lr_range_test`` calls, returning scripted losses."""

    lr = 0.5

    def __init__(self, losses):
        self.losses = list(losses)

    def init_state(self, rng, arrays):
        return types.SimpleNamespace(opt_state=None)

    def train_step(self, state, x, pos, y, mask, rng):
        return state, self.losses.pop(0), None


class PortStub(Model):
    """The port's ``Model`` whose train step returns scripted losses and
    records the learning rate it was given."""

    def __init__(self, losses, lr_scheduler=None):
        super().__init__(torch.nn.Linear(2, 2), lr=0.5, lr_scheduler=lr_scheduler)
        self.losses = list(losses)
        self.seen_lr = []

    def train_step(self, x, pos, y, mask, generator=None):
        self.seen_lr.append(self.optimizer.param_groups[0]["lr"])
        self.step += 1
        return torch.tensor(self.losses.pop(0)), None


SEQUENCES = {
    "decreasing": [3.0 * 0.95**i + 0.01 * math.sin(i) for i in range(40)],
    "diverges_after_10": [2.0 - 0.05 * i for i in range(16)] + [2.0 * 3**i for i in range(1, 25)],
    "nan_at_4": [1.0, 0.9, 0.85, 0.7, float("nan")] + [0.5] * 35,
    "fewer_than_3": [1.0, 0.8, float("inf")] + [0.5] * 37,
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_suggestion_equals_jax(name):
    kw = dict(seed=3, min_lr=1e-4, max_lr=3.0, num_steps=40)
    want = jax_lr_range_test(JaxStub(SEQUENCES[name]), FakeDataModule(), **kw)
    port = PortStub(SEQUENCES[name])
    got = lr_range_test(port, FakeDataModule(), **kw)
    assert got == want
    assert len(port.seen_lr) == 40 - len(port.losses)
    if name == "fewer_than_3":
        assert got == port.lr


def test_one_cycle_sweep_follows_the_jax_schedule():
    """The JAX optimizer chains the one-cycle schedule after Adam with a
    fresh count, so its step i runs at ``lr_i * onecycle(i)``."""
    port = PortStub([1.0 - 0.01 * i for i in range(30)],
                    lr_scheduler=lambda: OneCycleLR(epochs=2, steps_per_epoch=10))
    lr_range_test(port, FakeDataModule(), min_lr=1e-3, max_lr=1.0, num_steps=30)
    schedule = JaxOneCycle(epochs=2, steps_per_epoch=10).optax_schedule()
    gamma = (1.0 / 1e-3) ** (1.0 / 29)
    want = [1e-3 * gamma**i * float(schedule(i)) for i in range(30)]
    np.testing.assert_allclose(port.seen_lr, want, rtol=1e-6)


def test_tiny_model_sweep_restores_the_model():
    torch.manual_seed(0)
    model = build_model("RandLANet", {"num_features": 9, "num_classes": 7, "num_neighbors": 8},
                        lr=0.01)
    model.init_train_state()
    model.step = 5
    optimizer = model.optimizer
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    lr = lr_range_test(model, FakeDataModule(), num_steps=6, min_lr=1e-3, max_lr=1.0)
    assert np.isfinite(lr) and 1e-3 <= lr <= 1.0
    after = model.net.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert model.step == 5 and model.optimizer is optimizer and not optimizer.state


@pytest.mark.parametrize("task", ["fit", "finetune"])
def test_train_fits_from_the_suggestion(monkeypatch, task):
    """``task.auto_lr_find``: fit starts from the range test's suggestion
    (finetune ignores it, as the JAX package does)."""
    seen = {}

    def fake_range_test(model, datamodule, seed):
        seen["device"] = next(model.parameters()).device
        return 0.0123

    def fake_fit(self, model, datamodule, ckpt_path=None, finetune=False):
        seen.update(lr=model.lr, finetune=finetune)
        self.interrupted = True     # no test after fit
        return model

    monkeypatch.setattr(port_train, "lr_range_test", fake_range_test)
    monkeypatch.setattr(Trainer, "fit", fake_fit)
    train({"task": {"task_name": task, "auto_lr_find": True}, "seed": 3,
           "model": {"_target_": "myria3d_tpu.models.model.Model",
                     "neural_net_class_name": "RandLANet",
                     "neural_net_hparams": {"num_features": 9, "num_classes": 7}, "lr": 0.5},
           "datamodule": {"_target_": f"{__name__}.FakeDataModule"},
           "trainer": {"accelerator": "cpu"}})
    if task == "fit":
        assert seen == {"device": torch.device("cpu"), "lr": 0.0123, "finetune": False}
    else:
        assert seen == {"lr": 0.5, "finetune": True}
