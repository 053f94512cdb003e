#!/usr/bin/env python3
"""Wall clock of the port's train step on a CUDA card at ``bench.py
--train``'s shape (N=12288, 7 classes, full-width RandLA-Net, window 4608),
as ``chip_smoke.py`` phase 8 times it, for one tree and one route at a
time, so that two trees can be run in many alternating turns on one card:

    python3 scripts/time_train_step.py [--port-root DIR] [--batches 16 32]
        [--route fused|unfused] [--reps 10] [--turns 2]

``--port-root`` imports ``myria3d_tpu_torch`` from another tree (an older
commit unpacked with ``git archive``). Per batch size: ms/step of each turn
(``--reps`` steps, each reading the parameters the last one wrote, one
synchronisation at the end), then a ``torch.profiler`` trace of three
steps: device kernels and copies per step, device busy time per step and
the device's idle share of the traced window. The step is paced by the
host's launches, and the card machine shares its host: compare trees only
over several turns of one call. Last line: the results as JSON, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port-root", default=ROOT, help="tree to import myria3d_tpu_torch from")
    ap.add_argument("--batches", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--route", choices=("fused", "unfused"), default="fused")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.path.abspath(args.port_root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from myria3d_tpu_torch.models.model import build_model

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = []
    for b in args.batches:
        torch.manual_seed(0)
        model = build_model("RandLANet", {
            "num_features": 9, "num_classes": 7, "num_neighbors": 16, "decimation": 4,
            "knn_window": smoke.WINDOW, "sort_inputs": True,
            "fused_train_lfa": args.route == "fused"}, lr=0.001)
        model.to(dev)
        model.init_train_state()
        batch = [torch.from_numpy(a).to(dev) for a in smoke.train_batch(b)]

        def step(i):
            return model.train_step(*batch, torch.Generator(device=dev).manual_seed(i))

        turns = []
        for _ in range(args.turns):
            step(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(args.reps):
                loss, _ = step(i + 1)
            ok = float(loss)
            turns.append((time.perf_counter() - t0) * 1e3 / args.reps)
        if ok != ok:
            print("FAIL: non-finite loss")
            return 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(3):
                step(i)
            torch.cuda.synchronize()
        spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                       if ev.device_type == DeviceType.CUDA)
        row = {"batch": b, "route": args.route, "ms_per_step": turns}
        if spans:      # an empty trace leaves the device numbers unmeasured
            busy, end = 0.0, spans[0][0]
            for t0, t1 in spans:
                busy += max(0.0, t1 - max(t0, end))
                end = max(end, t1)
            window = end - spans[0][0]
            row.update(device_ops_per_step=len(spans) / 3, device_busy_ms=busy / 3e3,
                       idle_share=1 - busy / window)
        results.append(row)
        print(f"B={b} {args.route}: " + ", ".join(f"{t:.1f}" for t in turns) + " ms/step; "
              + (f"{row['device_ops_per_step']:.0f} device kernels and copies a step, device busy "
                 f"{row['device_busy_ms']:.2f} ms/step, idle {100 * row['idle_share']:.1f} %"
                 if spans else "device profile not measured (empty trace)"))
        del model, batch
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"port_root": os.path.abspath(args.port_root), "card": card,
                      "reps": args.reps, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
