#!/usr/bin/env python3
"""K8 (farthest-point sampling, ``ops/cuda_fps.py``) on a CUDA card along
every route it can take, at ``chip_smoke.py`` phase 16a's shapes: B=16 and
48 at 12288 -> 3072 -> 768 -> 192 -> 48, B=16 (and 15) at 40960 -> 10240, the
x-sorted bench subtiles (B=48, 12288 -> 3072) and a mask that is no prefix.

    python scripts/tune_fps.py [--port-root DIR] [--reps N] [--cases a,b,...] [--out DIR]
    python scripts/tune_fps.py --steps N

Each route (threads a CTA, points a thread, cluster size, the box skip on
or off) is checked bit-equal to the plain version, then timed with CUDA
events over ``--reps`` calls with the host ahead
(``chip_smoke.cuda_ms(..., ahead=True)``); each line gives the ms, the us
a round (the batch's longest chain: min(valid, m) rounds of its largest
cloud) and ``cudaOccupancyMaxActiveClusters``. The route that
``cuda_fps.route`` picks is marked ``*``. Before the routes, K8's
registers, stack frame and spills per instantiation (``cuobjdump`` and
``ptxas``). ``--port-root`` imports ``myria3d_tpu_torch`` from another tree
(an older commit unpacked with ``git archive``) and times its ``fps`` alone,
on the same inputs: run the trees in turns within one call. With ``--out``
it writes every case's rows to ``DIR/tune_fps[_<tag>].json`` and the
kernels' SASS to ``DIR/fps_sass[_<tag>].txt``; the last line names the
card and its power limit.

``--steps N`` times K8 inside the full-width PointNet++ steps instead:
phase 16c's predict step (x-sorted bench subtiles, as predict sorts them)
and phase 16d's train step (unsorted, as fit feeds them), each with the
box skip where the rule puts it and with the skip off everywhere, in N
turns that alternate the two. Each line gives K8's device ms per step from
a ``torch.profiler`` trace of three steps (``chip_smoke.device_profile``)
with the launches it traced (four a step), the device's busy ms per step
and the step's ms with the host waiting for the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cases(smoke):
    """name -> (pos, mask, m) as numpy arrays."""
    out = {"B=4 2048->512": (*smoke.fps_clouds(4, 2048, 512, seed=3), 512)}
    for b in (16, 48):
        for n, m in smoke.FPS_SHAPES:
            out[f"B={b} {n}->{m}"] = (*smoke.fps_clouds(b, n, m, seed=n + b), m)
    for b in (15, 16):      # the card holds 15 clusters of seven or eight 512-thread CTAs
        out[f"B={b} 40960->10240"] = (*smoke.fps_clouds(b, *smoke.FPS_LARGE, seed=40960 + b),
                                      smoke.FPS_LARGE[1])
    out["B=48 12288->3072 x-sorted"] = (*smoke.fps_sorted_clouds(), 3072)
    out["B=48 12288->3072 non-prefix"] = (*smoke.fps_scattered_clouds(48, 12288, 3072, seed=7),
                                          3072)
    return out


def candidates(cuda_fps, b, n):
    """Every route that holds the cloud: c in 1..8, threads 32..512, the
    fewest points a thread, skip off and on."""
    out = []
    for c in range(1, cuda_fps.MAX_CLUSTER + 1):
        share = -(-n // c)
        threads = 32
        while threads <= cuda_fps.MAX_THREADS:
            fits = [p for p in cuda_fps.PTS if threads * p >= share]
            if fits and threads <= max(32, cuda_fps._pow2_at_least(share)):
                for skip in (False, True):
                    out.append(cuda_fps.Route(threads, fits[0], c, skip))
            threads *= 2
    return out


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def occupancy(cuda_fps) -> None:
    """``cudaOccupancyMaxActiveClusters`` at 12 points a thread, 256 and
    512 threads a CTA, for every cluster size: how the card's SMs group."""
    for threads in (256, 512):
        got = [cuda_fps.max_active_clusters(cuda_fps.Route(threads, 12, c, False))
               for c in range(1, cuda_fps.MAX_CLUSTER + 1)]
        print(f"clusters at once, {threads} threads x 12 points, c = 1..8: {got}")


def steps(smoke, cuda_fps, dev, turns: int) -> int:
    """K8 in the PointNet++ predict (16c) and train (16d) steps, the box
    skip as the rule takes it against off everywhere, in alternating
    turns (an older tree's kernel as it is)."""
    import time

    import torch

    predict, _ = smoke.pn2_predict_step(dev)
    x, pos, y, mask = smoke.pn2_train_batch(dev)
    model = smoke.pn2_model(dev)
    model.init_train_state()

    def train():
        return model.train_step(x, pos, y, mask, torch.Generator(device=dev).manual_seed(0))

    own = hasattr(cuda_fps, "route")      # an older tree has no rule to patch
    rule = getattr(cuda_fps, "route", None)
    try:
        for turn in range(turns):
            for skip in (True, False) if own else (None,):
                if own:
                    cuda_fps.route = lambda b, n, sms, on=skip: rule(b, n, sms)._replace(
                        skip=on and rule(b, n, sms).skip)
                for name, step in (("predict 16c (x-sorted)", predict),
                                   ("train 16d (unsorted)", train)):
                    busy, _, by_name, count = smoke.device_profile(step)
                    k8 = sum(v for k, v in by_name.items() if k.startswith("fps_kernel"))
                    traced = sum(v for k, v in count.items() if k.startswith("fps_kernel"))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(5):
                        step()
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3 / 5
                    what = "its kernel" if skip is None else f"skip {'rule' if skip else 'off'}"
                    print(f"turn {turn} {name} {what}: K8 {k8:.4f} ms/step on the device "
                          f"({traced} launches traced), device busy {busy:.2f} ms/step, step "
                          f"{ms:.2f} ms", flush=True)
    finally:
        if own:
            cuda_fps.route = rule
    print(json.dumps({"card": card_name(), "port_root": sys.path[0]}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port-root", default=ROOT, help="tree to import myria3d_tpu_torch from")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cases", default="", help="comma-separated substrings of case names")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="", help="directory for the JSON rows and the SASS")
    ap.add_argument("--steps", type=int, default=0,
                    help="turns of K8 inside the PointNet++ steps, skip on and off")
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.path.abspath(args.port_root))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    from myria3d_tpu_torch import _ext
    from myria3d_tpu_torch.ops import cuda_fps

    dev = torch.device("cuda")
    if args.steps:
        return steps(smoke, cuda_fps, dev, args.steps)
    own = hasattr(cuda_fps, "route")
    result = {"port_root": os.path.abspath(args.port_root), "cases": {}}
    usage = _ext.resource_usage()
    for name, u in sorted(usage.items()):
        if name.startswith("fps_kernel"):
            print(f"{name}: {u.get('reg')} registers, stack {u.get('stack')} B, local "
                  f"{u.get('local')} B, spills {u.get('spill_stores')}/{u.get('spill_loads')} B")
    result["resources"] = {k: v for k, v in usage.items() if k.startswith("fps_kernel")}
    suffix = f"_{args.tag}" if args.tag else ""
    if own:     # the kernels' SASS, for counting the round loop's instructions
        tool = os.path.join(os.path.dirname(_ext._nvcc()), "cuobjdump")
        sass = subprocess.run([tool, "-sass", str(_ext.build())], capture_output=True,
                              text=True, check=True).stdout
        funcs = [f for f in sass.split("\t\tFunction : ")[1:] if "fps_kernel" in f.split()[0]]
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"fps_sass{suffix}.txt"), "w") as f:
                f.write("\n".join("Function : " + fn for fn in funcs))
        for fn in funcs:
            count = len(re.findall(r"/\*[0-9a-f]{4,}\*/", fn))
            print(f"SASS {_ext._short_name(fn.split()[0])}: {count} instructions")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if own:
        occupancy(cuda_fps)
    want_cases = [c for c in args.cases.split(",") if c]
    with torch.inference_mode():
        for name, (pos_np, mask_np, m) in cases(smoke).items():
            if want_cases and not any(w in name for w in want_cases):
                continue
            pos, mask = torch.from_numpy(pos_np).to(dev), torch.from_numpy(mask_np).to(dev)
            b, n = mask_np.shape
            rounds = int(min(mask_np.sum(1).max(), m))
            want = cuda_fps.farthest_point_sampling_plain(pos, mask, m)
            rows = []
            if not own:
                got = cuda_fps.fps(pos, mask, m)
                ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                ms = smoke.cuda_ms(lambda: cuda_fps.fps(pos, mask, m), args.reps, warmup=2,
                                   ahead=True)
                print(f"{name} fps: {'bit-equal' if ok else 'DIFFERS'}, {ms:.4f} ms, "
                      f"{1e3 * ms / max(rounds, 1):.3f} us a round")
                rows.append({"route": None, "equal": ok, "ms": ms})
            else:
                chosen = cuda_fps.route(b, n, sms)
                for rt in candidates(cuda_fps, b, n):
                    got = cuda_fps.launch(pos, mask, m, rt)
                    ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                    ms = smoke.cuda_ms(lambda: cuda_fps.launch(pos, mask, m, rt), args.reps,
                                       warmup=2, ahead=True)
                    occ = cuda_fps.max_active_clusters(rt)
                    mark = "*" if rt == chosen else " "
                    print(f"{mark} {name} T={rt.threads} PT={rt.pt} c={rt.cluster} "
                          f"skip={int(rt.skip)}: {'bit-equal' if ok else 'DIFFERS'}, "
                          f"{ms:.4f} ms, {1e3 * ms / max(rounds, 1):.3f} us a round, "
                          f"{occ} clusters at once", flush=True)
                    rows.append({"route": list(rt), "chosen": rt == chosen, "equal": ok,
                                 "ms": ms, "max_clusters": occ})
            result["cases"][name] = {"b": b, "n": n, "m": m, "rounds": rounds, "rows": rows}
    card = card_name()
    result["card"] = card
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"tune_fps{suffix}.json"), "w") as f:
            json.dump(result, f, indent=1)
    bad = [(k, r["route"]) for k, c in result["cases"].items() for r in c["rows"]
           if not r["equal"]]
    print(json.dumps({"card": card, "port_root": result["port_root"], "differs": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
