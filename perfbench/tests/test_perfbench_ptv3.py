"""The cell ``ptv3.predict_step`` on the CPU at the small size of the other
cells' tests (the harness's look for a card skipped): a correct run with its
per-layer metrics, a planted fault and the lower-precision control not
correct, Point Transformer V3's yardstick (perfbench/yardstick_ptv3.py)
against a hand count, its readers reading None without their inputs, and
its reference importing nothing of the program."""

import importlib
import json
import os
import types

import pytest
import torch

from perfbench import compare, faults, run
from perfbench import yardstick as y
from perfbench import yardstick_ptv3 as y3
from perfbench.tests.conftest import ROOT, small_cell
from perfbench.tests.test_perfbench_imports import FORBIDDEN, _loaded_after

CELL = "ptv3.predict_step"
PT3 = {"num_features": 9, "num_classes": 7, "enc_depths": [2, 2, 2, 6, 2],
       "enc_channels": [32, 64, 128, 256, 512], "dec_depths": [2, 2, 2, 2],
       "dec_channels": [64, 64, 128, 256], "mlp_ratio": 4}
READERS = ("mfu_pct.ptv3.predict_step", "attn_roofline.ptv3.predict_step",
           "ptv3.attention_ms", "ptv3.cpe_ms", "ptv3.serialize_ms")


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
    # the CPU runs neither K3 nor the attention's CUDA kernels
    assert set(res["metrics"]) == want - {"k3_interp_roofline.ptv3.predict_step",
                                          "attn_roofline.ptv3.predict_step"}
    for name in ("ptv3.attention_ms", "ptv3.cpe_ms", "ptv3.serialize_ms"):
        assert res["metrics"][name]["value"] > 0, name
    assert 0 < res["metrics"]["mfu_pct.ptv3.predict_step"]["value"] < 100


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


def test_point_transformer_v3_flops_by_hand():
    slots = {"points": [1000, 300, 90, 30, 10], "conv_pairs": [9000, 8000, 2500, 800, 200, 40],
             "attn_pairs": [1_000_000, 90_000, 8100, 900, 100], "dup_points": 3}
    pts, conv, attn = slots["points"], slots["conv_pairs"], slots["attn_pairs"]
    enc, dec = PT3["enc_channels"], PT3["dec_channels"]

    def block(c, s):
        per_point = c * c + 3 * c * c + c * c + c * 4 * c + 4 * c * c
        return 2 * pts[s] * per_point + 2 * c * c * conv[s + 1] + 4 * c * attn[s]

    want = 2 * 9 * 32 * 9000
    for s, c in enumerate(enc):
        want += PT3["enc_depths"][s] * block(c, s)
        if s:
            want += 2 * enc[s - 1] * c * pts[s - 1]
    ins = dec + [512]
    for s, c in enumerate(dec):
        want += PT3["dec_depths"][s] * block(c, s)
        want += 2 * ins[s + 1] * c * pts[s + 1] + 2 * enc[s] * c * pts[s]
    want += 2 * 64 * 7 * 1000
    assert y3.batch_flops(PT3, slots) == want
    attn_want = sum(d * 4 * c * attn[s] for s, (c, d) in enumerate(zip(enc, PT3["enc_depths"])))
    attn_want += sum(d * 4 * c * attn[s] for s, (c, d) in enumerate(zip(dec, PT3["dec_depths"])))
    assert y3.attention_flops(PT3, slots) == attn_want
    # the attention's floor is part of the step's
    assert y3.attention_flops(PT3, slots) < y3.batch_flops(PT3, slots)


def test_point_transformer_v3_readers_read_none_without_their_inputs():
    rec = {"cfg": PT3, "batches": [([1000], [3000], 1024)], "steps": 2, "window_s": 1.0}
    for name in READERS:
        assert run.load_reader(name)(rec) is None, name

    class NoKernel:
        host = [(0.0, 5.0, "aten::mm")]

        @staticmethod
        def kernel_s(*patterns):
            return 0.0

    traced = dict(rec, trace=NoKernel(), trace_batches=[0])
    for name in READERS[1:]:
        assert run.load_reader(name)(traced) is None, name
    slots = {"points": [1000, 300, 90, 30, 10], "conv_pairs": [1] * 6,
             "attn_pairs": [1] * 5, "dup_points": 0}
    got = run.load_reader("mfu_pct.ptv3.predict_step")(dict(rec, slots={0: slots}))
    assert got == pytest.approx(100.0 * 2 * y3.batch_flops(PT3, slots) / y.PEAKS["fp32_flops"])


def test_the_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("import perfbench.reference.point_transformer_v3, "
                           "perfbench.yardstick_ptv3")
    assert not loaded & (FORBIDDEN | {"myria3d_tpu_torch"})
