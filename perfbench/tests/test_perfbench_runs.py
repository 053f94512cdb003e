"""Whole runs of each cell on the CPU at a small size (the harness's look
for a card skipped): the result line's shape, the program's readings under
their limits, and ``correct`` false for every fault a cell can have and for
the lower-precision control."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from perfbench import compare, faults, run
from perfbench.tests.conftest import ROOT, small_cell

WORKLOADS = ("randla.predict_step", "pn2.predict_step", "randla.train_step",
             "randla.tile_predict")


def execute(workload: str, trace: int = 0, seed: int = 2 ** 31 + 3):
    bench, cell, config, traffic = small_cell(workload)
    args = types.SimpleNamespace(seed=seed, seconds=0.0, trace=trace)
    return run.execute(bench, cell, config, traffic, args, torch.device("cpu"))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line(workload):
    res = execute(workload, trace=1)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "compared"
    assert res["correct"] is True, res["compared"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    want = {m["name"] for m in bench["per_layer"] if workload in m["workloads"]}
    assert set(res["metrics"]) <= want and res["metrics"]
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"} <= set(dev)
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())
    json.dumps(res)
    for c in res["compared"].values():
        assert c["value"] <= c["limit"]


def test_end_to_end_line():
    res = execute("randla.predict_step", trace=0)
    assert set(res["metrics"]) == {"predict_step_mpts_per_s", "setup_s"}
    assert "breakdown" not in res and "busy_s" not in res["device"]


FAULTS = [("randla.predict_step", "altered_answer"), ("pn2.predict_step", "altered_answer"),
          ("randla.tile_predict", "altered_answer"), ("randla.train_step", "unchanged_state"),
          ("randla.train_step", "half_batch")]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f}" for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    getattr(faults, fault)(monkeypatch)
    res = execute(workload)
    assert res["correct"] is False, res["compared"]


def test_a_fault_of_the_window_steps_alone_is_not_correct(monkeypatch):
    """An update that goes wrong only after set-up (as a path taken once
    warm would) fails the train cell: window steps are checked too."""
    from myria3d_tpu_torch.models.model import Model

    step = Model.train_step
    _, _, _, traffic = small_cell("randla.train_step")
    taken = []

    def late(self, *a, **k):
        taken.append(1)
        if len(taken) <= traffic["warmup_steps"]:
            return step(self, *a, **k)
        before = {n: p.detach().clone() for n, p in self.net.named_parameters()}
        out = step(self, *a, **k)
        with torch.no_grad():
            for n, p in self.net.named_parameters():
                p.copy_(before[n])
        return out

    monkeypatch.setattr(Model, "train_step", late)
    res = execute("randla.train_step")
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    """The reference in the program's place with TF32 products (rounded
    operands on the CPU) fails one of the cell's numbers."""
    import importlib

    from perfbench.drivers.common import Ctx

    _, cell, config, traffic = small_cell(workload)
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    ctx = Ctx(workload=workload, config=config, traffic=traffic, seed=2 ** 31 + 9, seconds=0.0,
              trace=False, device=torch.device("cpu"), control=True)
    out = driver.run(ctx)
    ok, _ = compare.judge(out["control_readings"], compare.limits(workload))
    assert not ok, out["control_readings"]
    ok, _ = compare.judge(out["readings"], compare.limits(workload))
    assert ok, out["readings"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the run exits non-zero and prints nothing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "randla.predict_step",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
