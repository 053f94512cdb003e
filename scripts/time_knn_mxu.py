#!/usr/bin/env python3
"""Times of K7 (``knn_topk(..., variant="mxu")``, the expanded-score full
scan) and of K1's full scan on the same clouds on a CUDA card, at
``chip_smoke.py`` phase 9's shapes: B=48 bench subtiles, k=16, self 12288,
768 and 192 (the predict step's full-scan stages).

    python scripts/time_knn_mxu.py [--port-root DIR] [--reps N]

``--port-root`` imports ``myria3d_tpu_torch`` from another tree (an older
commit unpacked with ``git archive``), so the same inputs time both; run
the trees in turns within one call on one card. Every wrapper is timed
twice with CUDA events over ``--reps`` calls: ``device`` with a long
matrix product queued first, so the host runs ahead and the events see the
card's time alone (``chip_smoke.cuda_ms(..., ahead=True)``); ``enqueued``
on an idle stream, where a call that the host takes longer to enqueue than
the card to run shows the host's time. Prints one line per case and, last,
a JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port-root", default=ROOT, help="tree to import myria3d_tpu_torch from")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.path.abspath(args.port_root))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from myria3d_tpu_torch.ops.cuda_knn import knn_topk
    from myria3d_tpu_torch.ops.knn import centred_clouds

    stages = smoke.knn_mxu_stages(torch.device("cuda"))
    out = {}
    with torch.inference_mode():
        for i in (0, 2, 3):
            q4, k4 = centred_clouds(stages[i][0], stages[i][0], stages[i][1])
            label = f"self {q4.shape[1]}"
            for name, fn in (("K7", lambda: knn_topk(q4, k4, 16, variant="mxu")),
                             ("K1 full scan", lambda: knn_topk(q4, k4, 16))):
                device = smoke.cuda_ms(fn, args.reps, warmup=2, ahead=True)
                enqueued = smoke.cuda_ms(fn, args.reps)
                out[f"{name} {label}"] = {"device": device, "enqueued": enqueued}
                print(f"{name} {label} B=48 k=16: device {device:.4f} ms, "
                      f"enqueued {enqueued:.4f} ms")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"port_root": os.path.abspath(args.port_root), "card": card,
                      "reps": args.reps, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
