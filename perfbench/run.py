#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``workloads`` in ``BENCHMARK.json``)
names a configuration (``perfbench/configs/<name>.json``) and a traffic mix
(``perfbench/traffic/<name>.json``); the mix names the driver that runs it
(``perfbench/drivers/<driver>.py``). With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, each
read by its own reader (``perfbench/metrics/<metric>.py``, a ``read(record)``
that returns a number or None; a metric ``<quantity>.<cells>`` without a
file of its own is read by ``perfbench/metrics/<quantity>.py``). Everything is found by name; nothing here
lists a cell, a configuration, a mix or a metric.

The run needs a CUDA device: without one (or with fewer than the cell asks
for) it exits 2 and prints no result. It exits 3 without a result if
``jax``, ``jaxlib``, ``flax`` or ``myria3d_tpu`` was loaded. The compared
numbers and their limits are the last lines of standard error and the last
key of the result.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "myria3d_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def load_reader(name: str):
    """The ``read`` function of ``perfbench/metrics/<name>.py``, or else of
    ``perfbench/metrics/<quantity>.py`` for a name ``<quantity>.<cells>``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        path = os.path.join(HERE, "metrics", f"{name.split('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_of(bench: dict, workload: str):
    """(cell, configuration, traffic) of ``workload``."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def metrics_for(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries the cell reports: end-to-end without the trace,
    per-layer with it (those listing the cell, or, without a list, every
    cell that reports the metric they move)."""
    e2e = [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]] if m["moves"] in names else [])]


def setup_env() -> None:
    """Every cache of the run at a fixed place inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, config, traffic = cell_of(bench, args.workload)
    setup_env()
    # the package by its name from the checkout's root, not its modules by theirs
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = execute(bench, cell, config, traffic, args, torch.device("cuda:0"))
    with open("/proc/self/io") as f:
        wrote = next(int(v) for k, v in (ln.split(":") for ln in f) if k == "wchar")
    print(f"set-up phases (s since start): {result.pop('setup_phases')}; bytes written {wrote}",
          file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"loaded modules that the benchmark may not load: {found}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def execute(bench: dict, cell: dict, config: dict, traffic: dict, args, device) -> dict:
    """Everything of a run after the look for a device: set-up, window,
    trace, check; the result as a dict."""
    import torch

    from perfbench import compare
    from perfbench.drivers.common import Ctx, process_age_s

    ctx = Ctx(workload=cell["name"], config=config, traffic=traffic, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device=device,
              start_age_s=process_age_s() - (time.perf_counter() - T0), t0=T0)
    ctx.mark("imports")
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        ctx.mark("CUDA context")
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    out = driver.run(ctx)
    metrics = {}
    for m in metrics_for(bench, cell, ctx.trace):
        value = load_reader(m["name"])(out["record"]) if ctx.trace else out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, compared = compare.judge(out["readings"], compare.limits(cell["name"]))
    cuda = device.type == "cuda"
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": 0 if correct else out["attempted"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": cell["chips"],
                         "memory_peak_bytes": int(out["memory_peak_bytes"])}}
    if out.get("trace") is not None:
        tr = out["trace"]
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["setup_phases"] = ctx.marks
    result["compared"] = compared
    return result


if __name__ == "__main__":
    sys.exit(main())
