#!/usr/bin/env python3
"""Readings for setting a cell's limits: the program's and the control's.

    python3 perfbench/control.py --workload <name> --seeds <a>-<b> [--control-seeds <c>-<d>]
        [--fault <name>]

For every seed, one run of the cell with no measured window (the steps or
tiles that a run checks, and only those), in one process: the compared
numbers of the program against the float32 reference, and for the control
seeds also those of the control, the reference computed with TF32 products
in the program's place. ``--fault`` plants one of ``perfbench/faults.py``
in the program first. One JSON line a seed. The benchmark's own runs never
run the control or a fault.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def seed_range(text: str) -> list:
    a, _, b = text.partition("-")
    return list(range(int(a), int(b or a) + 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="", help="a fault of perfbench/faults.py, planted first")
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    from perfbench import run
    from perfbench.drivers.common import Ctx

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, config, traffic = run.cell_of(bench, args.workload)
    run.setup_env()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    if args.fault:
        from perfbench import faults

        getattr(faults, args.fault)(faults.Patch)
    # a check reads one tile: the window's whole tiles are the same input
    if "min_tiles" in traffic:
        traffic["min_tiles"] = 1
    controls = set(seed_range(args.control_seeds)) if args.control_seeds else set()
    for seed in seed_range(args.seeds):
        t0 = time.perf_counter()
        ctx = Ctx(workload=args.workload, config=config, traffic=traffic, seed=seed, seconds=0.0,
                  trace=False, device=torch.device("cuda:0"), control=seed in controls)
        out = driver.run(ctx)
        print(json.dumps({"seed": seed, "fault": args.fault or None, "program": out["readings"],
                          "control": out["control_readings"] if ctx.control else None,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
