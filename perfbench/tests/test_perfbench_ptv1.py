"""The cell ``ptv1.predict_step`` on the CPU at the small size of the other
cells' tests (the harness's look for a card skipped): a correct run with its
per-layer metrics, a planted fault and the lower-precision control not
correct, Point Transformer's yardstick (perfbench/yardstick_pt.py) against a
hand count, and its reference importing nothing of the program."""

import importlib
import json
import os
import types

import pytest
import torch

from perfbench import compare, faults, run
from perfbench import yardstick as y
from perfbench import yardstick_pt as ypt
from perfbench.tests.conftest import ROOT, small_cell
from perfbench.tests.test_perfbench_imports import FORBIDDEN, _loaded_after

CELL = "ptv1.predict_step"
PT = {"num_features": 9, "num_classes": 7, "planes": [32, 64, 128, 256, 512],
      "blocks": [2, 3, 4, 6, 3], "nsample": [8, 16, 16, 16, 16], "stride": [1, 4, 4, 4, 4],
      "share_planes": 8}


def execute(trace: int = 0, seed: int = 2 ** 31 + 3):
    bench, cell, config, traffic = small_cell(CELL)
    args = types.SimpleNamespace(seed=seed, seconds=0.0, trace=trace)
    return run.execute(bench, cell, config, traffic, args, torch.device("cpu"))


def test_small_run_is_correct_and_reads_its_metrics():
    res = execute(trace=1)
    assert res["correct"] is True, res["compared"]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    want = {m["name"] for m in bench["per_layer"] if CELL in m["workloads"]}
    # the CPU has no K1 or K3 kernels, so their rooflines read nothing
    assert set(res["metrics"]) == want - {"k1_knn_roofline.ptv1.predict_step",
                                          "k3_interp_roofline.ptv1.predict_step"}
    assert res["metrics"]["ptv1.attention_ms"]["value"] > 0
    assert 0 < res["metrics"]["mfu_pct.ptv1.predict_step"]["value"] < 100


def test_altered_answer_is_not_correct(monkeypatch):
    faults.altered_answer(monkeypatch)
    res = execute()
    assert res["correct"] is False, res["compared"]


def test_control_is_not_correct():
    from perfbench.drivers.common import Ctx

    _, _, config, traffic = small_cell(CELL)
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    ctx = Ctx(workload=CELL, config=config, traffic=traffic, seed=2 ** 31 + 9, seconds=0.0,
              trace=False, device=torch.device("cpu"), control=True)
    out = driver.run(ctx)
    assert not compare.judge(out["control_readings"], compare.limits(CELL))[0]
    assert compare.judge(out["readings"], compare.limits(CELL))[0], out["readings"]


def test_point_transformer_flops_and_k1_bytes_by_hand():
    # 1000 real points: 1000, 250, 62, 15, 3 a stage
    assert ypt.stages(PT, 1000) == [1000, 250, 62, 15, 3]
    ns, planes = [1000, 250, 62, 15, 3], PT["planes"]
    want = 2 * 9 * 32 * 1000
    for c, m, blocks in zip(planes, ns, PT["blocks"]):
        want += blocks * 2 * m * (c * c + 3 * c * c + c * c)
    want += 2 * 1024 * 512 * 3 + 2 * 512 * 512
    want += sum(2 * planes[i] ** 2 * ns[i] + 2 * planes[i + 1] * planes[i] * ns[i + 1]
                for i in range(4))
    want += 2 * 1000 * (32 * 32 + 32 * 7)
    assert ypt.point_flops(PT, 1000) == want
    slots = {"graph": [10, 20, 30, 40, 50], "down": [1, 2, 3, 4], "up": [5, 6, 7, 8]}
    want = 0
    for c, blocks, s in zip(planes, PT["blocks"], slots["graph"]):
        want += blocks * 2 * s * (9 + 3 * c + c * (c // 8) + (c // 8) ** 2)
    want += sum(2 * (3 + planes[i]) * planes[i + 1] * slots["down"][i] for i in range(4))
    assert ypt.slot_flops(PT, slots) == want
    b = y.search_bytes
    want = (b(1000, 1000, 8) + b(250, 250, 16) + b(62, 62, 16) + b(15, 15, 15) + b(3, 3, 3)
            + b(250, 1000, 16) + b(62, 250, 16) + b(15, 62, 16) + b(3, 15, 15)
            + b(1000, 250, 3) + b(250, 62, 3) + b(62, 15, 3) + b(15, 3, 3))
    assert ypt.k1_bytes(PT, 1000) == want


def test_point_transformer_readers_read_none_without_their_inputs():
    rec = {"cfg": PT, "batches": [([1000], [3000], 1024)], "steps": 2, "window_s": 1.0}
    assert run.load_reader("mfu_pct.ptv1.predict_step")(rec) is None
    assert run.load_reader("k1_knn_roofline.ptv1.predict_step")(rec) is None
    assert run.load_reader("ptv1.attention_ms")(rec) is None
    slots = {"graph": [1] * 5, "down": [1] * 4, "up": [1] * 4}
    got = run.load_reader("mfu_pct.ptv1.predict_step")(dict(rec, slots={0: slots}))
    want = 2 * (ypt.point_flops(PT, 1000) + ypt.slot_flops(PT, slots))
    assert got == pytest.approx(100.0 * want / y.PEAKS["fp32_flops"])


def test_the_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("import perfbench.reference.point_transformer, perfbench.yardstick_pt")
    assert not loaded & (FORBIDDEN | {"myria3d_tpu_torch"})
