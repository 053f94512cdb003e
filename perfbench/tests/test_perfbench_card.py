"""On the card: the control with real TF32 products, and the program's
readings, at the small size of the CPU tests (``-m cuda``; skipped without
a card)."""

import importlib

import pytest
import torch

from perfbench import compare
from perfbench.tests.conftest import small_cell

WORKLOADS = ("randla.predict_step", "pn2.predict_step", "randla.train_step",
             "randla.tile_predict")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_on_the_card(workload, card):
    from perfbench.drivers.common import Ctx

    _, _, config, traffic = small_cell(workload)
    traffic["overrides"] = [o for o in traffic.get("overrides", []) if "accelerator" not in o]
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    ctx = Ctx(workload=workload, config=config, traffic=traffic, seed=2 ** 31 + 11, seconds=0.0,
              trace=False, device=card, control=True)
    out = driver.run(ctx)
    assert not compare.judge(out["control_readings"], compare.limits(workload))[0]
    assert compare.judge(out["readings"], compare.limits(workload))[0], out["readings"]
