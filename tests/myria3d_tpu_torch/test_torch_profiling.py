"""The port's profiling module against the JAX package's: ``trace`` and
``annotate`` on ``torch.profiler`` (a Chrome trace on the CPU), the copied
``StageTimer`` giving the JAX one's metrics with the clock patched on both
sides (equal), and ``trainer.profiler`` tracing epoch 0's train loop to
``$LOGS_DIR/profile``."""

import glob
import itertools
import json
import os
import time

import pytest
import torch

from myria3d_tpu.utils.profiling import StageTimer as JaxStageTimer
from myria3d_tpu_torch.train import Trainer, TrainerConfig
from myria3d_tpu_torch.utils.profiling import StageTimer, annotate, trace
from tests.myria3d_tpu_torch.test_torch_trainer import FakeDataModule, _model

torch.set_num_threads(1)


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(None):
        with annotate("region"):
            torch.ones(3).sum()
    with trace(""):
        pass
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    logdir = tmp_path / "profile"
    with trace(str(logdir)):
        with annotate("m3d_region"):
            (torch.ones((64, 64)) @ torch.ones((64, 64))).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    names = {ev.get("name") for ev in _events(logdir / files[0])}
    assert "m3d_region" in names and "aten::mm" in names


def test_stage_timer_matches_jax(monkeypatch):
    clock = itertools.count(start=1.0, step=0.25)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    out = []
    for timer in (StageTimer(), JaxStageTimer()):
        for name in ("read", "step", "step", "merge", "step"):
            with timer.stage(name):
                next(clock)
        out.append((timer.metrics(reset=False), timer.metrics(), timer.metrics()))
    assert out[0] == out[1]
    assert out[0][0]["profile/step_s"] == 3 * 0.5 and out[0][2] == {}


@pytest.mark.parametrize("profiler", ["torch", "jax", "simple"])
def test_fit_traces_epoch_0_to_logs_dir(tmp_path, monkeypatch, profiler):
    """``trainer.profiler`` "torch" (or the JAX package's "jax") writes one
    trace of epoch 0's train loop, its steps the "train_step" regions (the
    model's spans in each) and its waits for the loader the "data_wait"
    regions, and logs the host's time in both once (``StageTimer``);
    another value writes and logs nothing of it."""
    monkeypatch.setenv("LOGS_DIR", str(tmp_path))
    trainer = Trainer(TrainerConfig(max_epochs=2, accelerator="cpu", profiler=profiler), seed=0)
    rows = []
    monkeypatch.setattr(trainer, "_log", rows.append)
    trainer.fit(_model(), FakeDataModule())
    assert trainer.global_step == 4
    files = glob.glob(str(tmp_path / "profile" / "*.json"))
    timed = [r for r in rows if "profile/train_step_s" in r]
    if profiler == "simple":
        assert files == [] and timed == []
        return
    assert len(timed) == 1 and timed[0].keys() == {"profile/train_step_s",
                                                   "profile/train_step_mean_s",
                                                   "profile/data_wait_s",
                                                   "profile/data_wait_mean_s"}
    assert timed[0]["profile/train_step_s"] > 0 and timed[0]["profile/data_wait_s"] > 0
    # three waits: epoch 0's two batches, then the loader's end
    assert timed[0]["profile/data_wait_mean_s"] == pytest.approx(
        timed[0]["profile/data_wait_s"] / 3)
    assert len(files) == 1
    names = [ev.get("name") for ev in _events(files[0])]
    assert names.count("train_step") == 2          # epoch 0's two batches
    assert names.count("model.train_step") == 2 and names.count("model.optimizer") == 2
    assert names.count("data_wait") == 3
