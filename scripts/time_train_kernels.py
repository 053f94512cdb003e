#!/usr/bin/env python3
"""Times of the train step's graph kernels on a CUDA card: K4 (the gather
VJP, at the unfused route's eight gather widths and at the widths of K6's
eight dx scatters), K4's inverse map and K5 (rel statistics), at the train
stage shapes of ``chip_smoke.py`` phase 6 (B=16, N=12288 -> 3072 -> 768 ->
192, K=16). K5 is called as the tree's train block calls it (on the
block's marked indices where ``rel_stats`` takes them).

    python scripts/time_train_kernels.py [--port-root DIR] [--reps N]

``--port-root`` imports ``myria3d_tpu_torch`` from another tree (an older
commit unpacked with ``git archive``), so the same inputs time both; run
the trees in turns within one process group on one card. Every wrapper is
timed twice with CUDA events over ``--reps`` calls: ``device`` with a long
matrix product queued first, so the host runs ahead and the events see the
card's time alone (checked: the product must still run when the last call
is enqueued, else the time reads nan); ``enqueued`` on an idle stream,
where a call that the host takes longer to enqueue than the card to run
shows the host's time.
The kernels of one ``inverse_map`` call are also listed by name with their
times from a ``torch.profiler`` trace, at each stage and on a graph whose
every slot chose one key of its cloud (the longest range a map can hold).
Prints one line per case and, last, the sums per B=16 train step as JSON,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
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
    from myria3d_tpu_torch.ops.cuda_gather import gather_bwd, inverse_map
    from myria3d_tpu_torch.ops.cuda_knn import stage_window
    from myria3d_tpu_torch.ops.cuda_lfa import idx_with_invalid
    from myria3d_tpu_torch.ops.cuda_lfa_train import rel_stats
    from myria3d_tpu_torch.ops.knn import gather_rows, knn_graph
    from myria3d_tpu_torch.ops.sampling import random_decimation

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    def both(fn):
        """(device ms, enqueued ms) of ``fn``; the device time is NaN for a
        call that waits for the stream (an older tree's ``rel_stats``), which
        the host cannot enqueue ahead of the card."""
        try:
            device = smoke.cuda_ms(fn, args.reps, ahead=True)
        except smoke.PhaseError:
            device = float("nan")
        return device, smoke.cuda_ms(fn, args.reps)

    _, pos, _, mask = (torch.from_numpy(a).to(dev) for a in smoke.train_batch(16, 1))
    pos = gather_rows(pos, pos[..., 0].sort(dim=1, stable=True).indices)
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = [(pos, mask)]
    for _ in range(3):
        p, m = stages[-1]
        idx, m2 = random_decimation(m, 4, gen)
        stages.append((gather_rows(p, idx), m2))

    sums = {name: [0.0, 0.0] for name in ("inverse_map", "K4 gathers", "K4 dx", "K5")}

    def line(name, label, fn):
        d, e = both(fn)
        sums[name][0] += d
        sums[name][1] += e
        print(f"{name} {label}: device {d:.4f} ms, enqueued {e:.4f} ms")

    def map_kernels(label, idx, nv, n):
        """The device kernels of one warm ``inverse_map`` call."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        inverse_map(idx, nv, n)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            inverse_map(idx, nv, n)
            torch.cuda.synchronize()
        parts = [(ev.name.split("(")[0].replace("void ", ""),
                  (ev.time_range.end - ev.time_range.start) / 1e3)
                 for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        print(f"inverse_map {label} kernels: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in parts))

    for d_out, (p, m) in zip((32, 128, 256, 512), stages):
        n = p.shape[1]
        idx, _, nv = knn_graph(p, m, 16, window=stage_window(smoke.WINDOW, n))
        inv = inverse_map(idx, nv, n)
        line("inverse_map", f"N={n}", lambda: inverse_map(idx, nv, n))
        map_kernels(f"N={n}", idx, nv, n)
        for name, widths in (("K4 gathers", (3 + d_out // 8, d_out // 4)),
                             ("K4 dx", (d_out // 8, d_out // 4))):
            for width in widths:
                dout = torch.randn((16, n, 16, width), generator=gen, device=dev)
                line(name, f"P={width} N={n}", lambda: gather_bwd(dout, idx, nv, inv, n))
        if "idx_marked" in inspect.signature(rel_stats).parameters:
            # as the train block calls it: on the marked indices it made already
            marked = idx_with_invalid(idx, nv)
            line("K5", f"N={n}", lambda: rel_stats(p, idx, nv, marked))
        else:
            line("K5", f"N={n}", lambda: rel_stats(p, idx, nv))
    # not part of a train step: every slot of each cloud on one key
    n = stages[0][0].shape[1]
    hub_idx = torch.full((16, n, 16), 7, dtype=torch.int32, device=dev)
    hub_nv = torch.ones((16, n, 16), dtype=torch.bool, device=dev)
    d, e = both(lambda: inverse_map(hub_idx, hub_nv, n))
    print(f"inverse_map one key a cloud N={n}: device {d:.4f} ms, enqueued {e:.4f} ms")
    map_kernels(f"one key a cloud N={n}", hub_idx, hub_nv, n)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"port_root": os.path.abspath(args.port_root), "card": card,
                      "reps": args.reps,
                      "ms_per_step": {k: {"device": v[0], "enqueued": v[1]}
                                      for k, v in sums.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
