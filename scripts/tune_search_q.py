#!/usr/bin/env python3
"""Queries per thread (Q) of the K1/K3 search (``csrc/topk.cuh``) on the
card: each variant of the dispatch in ``csrc/knn.cu`` and ``csrc/interp.cu``
is built from a copy of the sources into its own library, loaded in place
of the package's, checked bit-equal (K1) or equal (K3) to the shipped
choice, and timed at the predict step's shapes (B=48 subtiles as
``chip_smoke.py`` builds them) with its registers, stack frame and spills.

    python3 scripts/tune_search_q.py [--variants 1:4,16:2,10:2 1:2,16:2,10:2 ...]

A variant lists ``K:Q`` for the K1 K=1 and K=16 lists and the K3 k=10
list. Run from the repository root on a machine with a CUDA card and
``nvcc``. The first variant is the shipped dispatch.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from myria3d_tpu_torch import _ext  # noqa: E402

SHIPPED = "1:2,16:1,10:1"
DEFAULT = [SHIPPED, "1:4,16:2,10:2", "1:1,16:1,10:1", "1:8,16:4,10:4"]
# the dispatch lines each variant rewrites: (file, K, text with {q})
DISPATCH = [("knn.cu", 1, "launch<1, {q}>(qp, kp, bp"),
            ("knn.cu", 16, "launch<16, {q}>(qp, kp, bp"),
            ("interp.cu", 10, "launch<10, {q}>(xp, qp, kp")]


def build_variant(spec: str, out_dir: Path) -> subprocess.Popen:
    """Start building the library of ``spec`` into ``out_dir``."""
    q_of = {int(k): int(q) for k, q in (item.split(":") for item in spec.split(","))}
    src = out_dir / "csrc"
    shutil.copytree(_ext.CSRC, src)
    for name, k, text in DISPATCH:
        path = src / name
        code = path.read_text()
        shipped = re.escape(text.format(q="QQ")).replace("QQ", r"\d+")
        code, n = re.subn(shipped, text.format(q=q_of[k]), code)
        if n != 1:
            raise RuntimeError(f"{name}: the K={k} dispatch was not found")
        path.write_text(code)
    nvcc = _ext._nvcc()
    sources = " ".join(str(src / n) for n in ("knn.cu", "interp.cu"))
    cmd = (f"{nvcc} {' '.join(_ext.NVCC_FLAGS)} -shared -o {out_dir / 'lib.so'} {sources} "
           f"> {out_dir / 'ptxas.txt'} 2>&1")
    return subprocess.Popen(cmd, shell=True)


def load(library: Path) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(library))
    for name in ("m3d_knn_topk", "m3d_knn_topk_mxu", "m3d_knn_interp"):
        fn = getattr(handle, name)
        fn.argtypes = _ext._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return handle


def cases(dev):
    """(label, call) of K1 and K3 at the predict step's shapes."""
    import torch

    from myria3d_tpu_torch.ops.cuda_interp import knn_interp
    from myria3d_tpu_torch.ops.cuda_knn import knn_topk, stage_window
    from myria3d_tpu_torch.ops.knn import centred_clouds, gather_rows
    from myria3d_tpu_torch.ops.sampling import random_decimation

    _, pos, mask, full_pos, full_mask = (torch.from_numpy(a).to(dev)
                                         for a in chip_smoke.bench_subtiles(1))
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = [(pos, mask)]
    for _ in range(3):
        p, m = stages[-1]
        idx, m2 = random_decimation(m, 4, gen)
        stages.append((gather_rows(p, idx), m2))
    out = []
    for label, (qp, qm), (kp, km), k in [("K1 K=16 self 12288", stages[0], stages[0], 16),
                                         ("K1 K=16 self 3072", stages[1], stages[1], 16),
                                         ("K1 K=1 12288<-3072", stages[0], stages[1], 1),
                                         ("K1 K=1 768<-192", stages[2], stages[3], 1)]:
        q4, k4 = centred_clouds(qp, kp, km)
        w = stage_window(chip_smoke.WINDOW, kp.shape[1])
        out.append((label, lambda q4=q4, k4=k4, k=k, w=w, qm=qm:
                    knn_topk(q4, k4, k, window=w, query_mask=qm)))
    logits = torch.randn((chip_smoke.B, chip_smoke.N, 7), generator=gen, device=dev) * 3
    q4, k4 = centred_clouds(full_pos, pos, mask)
    for w in (stage_window(chip_smoke.WINDOW, chip_smoke.N), 0):
        out.append((f"K3 k=10 32768<-12288 ({f'window {w}' if w else 'full scan'})",
                    lambda w=w: knn_interp(logits, q4, k4, 10, window=w, query_mask=full_mask)))
    return out


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=DEFAULT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="m3d_tune_") as tmp:
        dirs = [Path(tmp) / f"v{i}" for i in range(len(args.variants))]
        for d in dirs:
            d.mkdir()
        procs = [build_variant(spec, d) for spec, d in zip(args.variants, dirs)]
        if any(p.wait() != 0 for p in procs):
            for d in dirs:
                print((d / "ptxas.txt").read_text()[-4000:])
            print("FAIL: a variant did not build")
            return 1
        calls = cases(dev)
        reference = None
        with torch.inference_mode():
            for spec, d in zip(args.variants, dirs):
                _ext._lib = load(d / "lib.so")
                shutil.copy(d / "ptxas.txt", _ext.ptxas_log(d / "lib.so"))
                usage = _ext.resource_usage(d / "lib.so")
                outs = [fn() for _, fn in calls]
                reference = reference or outs
                same = all(all(torch.equal(a, b) for a, b in zip(as_tuple(o), as_tuple(r)))
                           for o, r in zip(outs, reference))
                times = [chip_smoke.cuda_ms(fn, 10, warmup=2) for _, fn in calls]
                print(f"variant {spec}{' (shipped)' if spec == SHIPPED else ''}: equal to the "
                      f"shipped outputs {same}; " + "; ".join(
                          f"{label} {ms:.3f} ms" for (label, _), ms in zip(calls, times)))
                print("  resources: " + "; ".join(
                    f"{n} {u.get('reg')} registers, stack frame {u.get('stack')} B, "
                    f"spill stores {u.get('spill_stores')} B" for n, u in sorted(usage.items())
                    if n.startswith(("knn_topk_kernel<", "knn_interp_kernel<"))))
    _ext._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
