#!/usr/bin/env python3
"""Worst errors of scale of the fused LFA kernels K2 and K6 against their
plain versions on the card tests' LFA cases (``LFA_CASES`` of
``tests/myria3d_tpu_torch/test_torch_cuda_kernels.py``: every width the
model uses, K = 8 and 16, three more draws at C_in = 16, two clouds that
end inside a tile), on a CUDA card.

    python scripts/lfa_accuracy.py [--port-root DIR]

``--port-root`` imports ``myria3d_tpu_torch`` from another tree (an older
commit unpacked with ``git archive``), so the same cases measure both.
Prints one line per case and, last, the worst error of scale of each
output as JSON: K2 against its plain version, K6 (dx, d(att_w), BN sums)
against its plain version in float64; tolerances 1e-4, 1e-4, 1e-3, 1e-3.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests", "myria3d_tpu_torch", "test_torch_cuda_kernels.py")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port-root", default=ROOT, help="tree to import myria3d_tpu_torch from")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.port_root))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    spec = importlib.util.spec_from_file_location("cuda_kernel_tests", TESTS)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    from myria3d_tpu_torch.ops.cuda_gather import inverse_map
    from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention, lfa_attention_plain
    from myria3d_tpu_torch.ops.cuda_lfa_train import lfa_train_bwd, lfa_train_bwd_plain

    def rel_err(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    dev = torch.device("cuda")
    worst = {"K2": 0.0, "K6 dx": 0.0, "K6 d_att_w": 0.0, "K6 sums": 0.0}
    with torch.inference_mode():
        for c_in, k, seed, n in cases.LFA_CASES:
            a2 = cases.k2_args(dev, c_in, k, seed, n)
            e2 = rel_err(lfa_attention(*a2), lfa_attention_plain(*a2))
            a6 = cases.k6_args(dev, c_in, k, seed, n)
            got = lfa_train_bwd(*a6[:4], inverse_map(a6[2], a6[3], n), *a6[4:])
            want = lfa_train_bwd_plain(*(a.double() if a.is_floating_point() else a for a in a6))
            e6 = [rel_err(a, b.float()) for a, b in zip(got, want)]
            for key, e in zip(worst, [e2, *e6]):
                worst[key] = max(worst[key], e)
            print(f"C_in={c_in} K={k} seed={seed} N={n}: K2 {e2:.3g}; K6 dx {e6[0]:.3g}, "
                  f"d_att_w {e6[1]:.3g}, sums {e6[2]:.3g} (errors of scale)")
    print(json.dumps({"port_root": os.path.abspath(args.port_root), "worst": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
