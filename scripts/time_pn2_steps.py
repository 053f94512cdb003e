#!/usr/bin/env python3
"""The full-width PointNet++ steps of ``chip_smoke.py`` phases 16c and 16d,
timed on a CUDA card in each compute dtype the tree has, for this tree or
an older one.

    python scripts/time_pn2_steps.py [--port-root DIR] [--turns N] [--reps N]

16c is ``Model.interp_step`` over the x-sorted bench subtiles (B=48,
N=12288, M=32768, window 4608), 16d ``Model.train_step`` on
``bench.py --train``'s batch (B=16, N=12288), both from
``chip_smoke.pn2_model`` (seed 0). Each turn times ``--reps`` calls of each
step after one warm call, the host waiting for the card at the end (ms a
step). ``--port-root`` imports ``myria3d_tpu_torch`` from another tree (an
older commit unpacked with ``git archive``; a tree without
``Model.set_compute_dtype`` runs f32 only): run the trees in turns within
one call to compare them. The last line names the card and its power
limit.
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
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.path.abspath(args.port_root))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from myria3d_tpu_torch.models.model import Model

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = ["float32"] + (["bfloat16"] if hasattr(Model, "set_compute_dtype") else [])
    predict, _ = smoke.pn2_predict_step(dev)
    batch = smoke.pn2_train_batch(dev)
    model = smoke.pn2_model(dev)
    model.init_train_state()

    def train():
        return model.train_step(*batch, torch.Generator(device=dev).manual_seed(0))

    for turn in range(args.turns):
        for dtype in dtypes:
            if hasattr(Model, "set_compute_dtype"):
                predict.model.set_compute_dtype(dtype)
                model.set_compute_dtype(dtype)
            for name, step in (("16c predict step B=48", predict), ("16d train step B=16", train)):
                step()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    step()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / args.reps
                print(f"turn {turn} {dtype} {name}: {ms:.2f} ms a step", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "port_root": os.path.abspath(args.port_root)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
