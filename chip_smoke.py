#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's predict path (one NVIDIA GPU).

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, one line each:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the kernels built from ``myria3d_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch version at the predict step's
   stage shapes (B=48 subtiles, N=12288 sampled, M=32768 full points):
   K1 (kNN) within 1e-6 relative on d2 and equal indices except at d2 ties,
   K2 (fused LFA) within 1e-4 and K3 (fused interpolation) within 1e-5 of
   the plain version's scale (max |kernel - plain| / max |plain|);
4. the main path: ``myria3d_tpu_torch.predict.predict`` on the synthetic
   toy tile with the converted toy checkpoint; the output LAS is checked,
   every kernel must have launched, and the ground-truth accuracy must be
   within 0.02 of the plain path's accuracy on the CPU;
5. the predict step at the bench shape, kernel path against plain path:
   ms per batch, Mpts/s, argmax agreement (>= 0.999).

Then one JSON line with the kernels and, last, the device JSON line. Any
failure, and a missing CUDA device, exits nonzero without a result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(ROOT, "trained_model_assets", "randlanet_toy_V0.5.0_torch")
# GT accuracy of the plain-version predict path on this tile and checkpoint
# on a CPU (datamodule.batch_size=4, seed 12345), recorded in CHANGES.md
CPU_PLAIN_ACCURACY = 0.7195166666666667
ACCURACY_MARGIN = 0.02
B, N, M, RAW = 48, 12_288, 32_768, 30_000   # bench.py:196-202
WINDOW = 4608                                # configs/predict/default.yaml
TOL = {"K1": 1e-6, "K2": 1e-4, "K3": 1e-5}


class PhaseError(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms (CUDA events over ``reps`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench_subtiles(seed: int = 0):
    """Synthetic subtiles built as bench.py builds them: 30 000 raw points
    per 50 m subtile, GridSampling(0.25) on the host, x-sorted sampled and
    full clouds padded to N and M."""
    from myria3d_tpu.pctl.transforms.transforms import CopyFullPos, GridSampling

    rng = np.random.default_rng(seed)
    x = np.zeros((B, N, 9), np.float32)
    pos = np.zeros((B, N, 3), np.float32)
    mask = np.zeros((B, N), bool)
    full_pos = np.zeros((B, M, 3), np.float32)
    full_mask = np.zeros((B, M), bool)
    gs = GridSampling(0.25)
    for b in range(B):
        raw = np.stack([rng.uniform(0, 50, RAW), rng.uniform(0, 50, RAW),
                        rng.uniform(0, 10, RAW)], axis=1).astype(np.float32)
        sample = gs(CopyFullPos()({"pos": raw, "x": rng.uniform(0, 1, (RAW, 9)).astype(np.float32)}))
        ns = min(sample["pos"].shape[0], N)
        order = np.argsort(sample["pos"][:ns, 0], kind="stable")
        pos[b, :ns] = sample["pos"][:ns][order]
        x[b, :ns] = sample["x"][:ns][order]
        mask[b, :ns] = True
        full_pos[b, :RAW] = raw[np.argsort(raw[:, 0], kind="stable")]
        full_mask[b, :RAW] = True
    return x, pos, mask, full_pos, full_mask


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain PyTorch versions."""
    from myria3d_tpu_torch.models.modules import randla_net
    from myria3d_tpu_torch.ops import cuda_interp, cuda_knn, cuda_lfa, interpolate, knn, nn1

    patches = [(knn, "knn_topk", cuda_knn.knn_topk_plain),
               (nn1, "knn_topk", cuda_knn.knn_topk_plain),
               (interpolate, "knn_interp", cuda_interp.knn_interp_plain),
               (randla_net, "lfa_attention", cuda_lfa.lfa_attention_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    return smi


def phase_build():
    from myria3d_tpu_torch import _ext

    t0 = time.perf_counter()
    path = _ext.build()
    _ext.lib()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path, ROOT)}")


def check_k1(idx_k, d2_k, idx_p, d2_p, tol: float):
    """The kernel's K slots against the plain version's K + 1: d2 within
    ``tol`` relative everywhere; indices equal except where a slot's d2 is
    within ``tol`` of a neighbouring candidate's (a tie), the (K+1)-th
    included."""
    import torch

    k = idx_k.shape[-1]
    rel = (d2_k - d2_p[..., :k]).abs() / d2_p[..., :k].abs().clamp(min=1e-30)
    need(bool((rel <= tol).all()), f"K1 d2 rel err {rel.max().item():.3g} > {tol}")
    gap = (d2_p[..., 1:] - d2_p[..., :-1]).abs() <= tol * d2_p[..., 1:].abs()
    tied = torch.zeros_like(idx_p, dtype=torch.bool)
    tied[..., 1:] |= gap
    tied[..., :-1] |= gap
    bad = int(((idx_k != idx_p[..., :k]) & ~tied[..., :k]).sum())
    need(bad == 0, f"K1 {bad} index mismatches outside ties")
    return float((d2_k - d2_p[..., :k]).abs().max())


def scale_err(a, b, tol: float, what: str) -> float:
    """max |a - b|, required to be within ``tol`` of max |b|."""
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    need(err <= tol * scale, f"{what}: max abs err {err:.3g} > {tol} x {scale:.3g}")
    return err


def phase_kernels(model, dev):
    """K1/K2/K3 against their plain versions at the bench stage shapes."""
    import torch

    from myria3d_tpu_torch.ops.cuda_interp import knn_interp, knn_interp_plain
    from myria3d_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_plain, stage_window
    from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention, lfa_attention_plain
    from myria3d_tpu_torch.ops.knn import centred_clouds, gather_rows, knn_graph
    from myria3d_tpu_torch.ops.sampling import random_decimation

    _, pos, mask, full_pos, full_mask = (torch.from_numpy(a).to(dev) for a in bench_subtiles(1))
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = [(pos, mask)]
    for _ in range(3):
        p, m = stages[-1]
        idx, m2 = random_decimation(m, 4, gen)
        stages.append((gather_rows(p, idx), m2))

    stats = {"K1": [], "K2": [], "K3": []}

    def record(name, label, err, fn_k, fn_p, reps_p=2):
        ms, plain_ms = cuda_ms(fn_k, 5), cuda_ms(fn_p, reps_p)
        stats[name].append((err, ms, plain_ms))
        print(f"phase 3 {name} {label}: max_abs_err {err:.3g}, {ms:.3f} ms, plain {plain_ms:.3f} ms")

    k1_cases = [("K=16 self 12288", stages[0], stages[0], 16),
                ("K=16 self 3072", stages[1], stages[1], 16),
                ("K=1 12288<-3072", stages[0], stages[1], 1),
                ("K=1 768<-192", stages[2], stages[3], 1)]
    for label, (qp, qm), (kp, km), k in k1_cases:
        q4, k4 = centred_clouds(qp, kp, km)
        w = stage_window(WINDOW, kp.shape[1])
        idx_k, d2_k = knn_topk(q4, k4, k, window=w, query_mask=qm)
        idx_p, d2_p = knn_topk_plain(q4, k4, k + 1, window=w, query_mask=qm)
        err = check_k1(idx_k, d2_k, idx_p, d2_p, TOL["K1"])
        record("K1", f"{label} (window {w})", err,
               lambda: knn_topk(q4, k4, k, window=w, query_mask=qm),
               lambda: knn_topk_plain(q4, k4, k, window=w, query_mask=qm))

    net = model.net
    for blk, (p, m) in zip((net.block1, net.block2, net.block3, net.block4), stages):
        idx, _, nv = knn_graph(p, m, 16, window=stage_window(WINDOW, p.shape[1]))
        for lfa in (blk.lfa1, blk.lfa2):
            enc_a, enc_c = (t.contiguous() for t in lfa.folded_encoder())
            att_w = lfa.mlp_attention.lins[0].weight.T.contiguous()
            c_in = enc_a.shape[0]
            feats = torch.rand((B, p.shape[1], c_in), generator=gen, device=dev) * 2 - 1
            args = (feats, p, idx, nv, enc_a, enc_c, att_w)
            with torch.inference_mode():
                err = scale_err(lfa_attention(*args), lfa_attention_plain(*args),
                                TOL["K2"], f"K2 ({c_in},{2 * c_in})")
                record("K2", f"({c_in},{2 * c_in}) N={p.shape[1]}", err,
                       lambda: lfa_attention(*args), lambda: lfa_attention_plain(*args))

    logits = torch.randn((B, N, 7), generator=gen, device=dev) * 3
    q4, k4 = centred_clouds(full_pos, pos, mask)
    w = stage_window(WINDOW, N)
    args = (logits, q4, k4, 10)
    kw = dict(window=w, query_mask=full_mask)
    err = scale_err(knn_interp(*args, **kw), knn_interp_plain(*args, **kw), TOL["K3"], "K3")
    record("K3", f"k=10 32768<-12288 (window {w})", err,
           lambda: knn_interp(*args, **kw), lambda: knn_interp_plain(*args, **kw))
    return stats


def launch_counters():
    from myria3d_tpu_torch.ops.cuda_interp import knn_interp
    from myria3d_tpu_torch.ops.cuda_knn import knn_topk
    from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention

    return {"K1": knn_topk, "K2": lfa_attention, "K3": knn_interp}


def phase_main_path(dev):
    """The port's predict() on the toy tile, through the kernels."""
    from myria3d_tpu.pctl.io.las import read_las
    from myria3d_tpu_torch.predict import predict
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config

    tile = os.path.join(ASSETS, "toy_tile.las")
    with tempfile.TemporaryDirectory(prefix="m3d_predict_") as out_dir:
        cfg = compose_config(CONFIG_DIR, "config.yaml", [
            "task.task_name=predict", f"predict.src_las={tile}", f"predict.ckpt_path={ASSETS}",
            f"predict.output_dir={out_dir}", f"predict.gpus={int(dev.type == 'cuda')}",
            "datamodule.batch_size=4",
        ])
        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = predict(cfg)
        dt = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        res = read_las(out).points
    need(all(v > 0 for v in launches.values()), f"kernels not launched on the main path: {launches}")

    src = read_las(tile).points
    need(len(res) == len(src), f"output has {len(res)} points, input {len(src)}")
    names = list(cfg["predict"]["interpolator"]["classification_dict"].values())
    dims = set(res.dtype.names)
    need({"PredictedClassification", "entropy", *names} <= dims, f"missing dims in {sorted(dims)}")
    probas = np.stack([np.asarray(res[n], np.float64) for n in names], axis=1)
    need(np.isfinite(probas).all() and np.isfinite(np.asarray(res["entropy"])).all(), "NaN in output")
    sums = probas.sum(axis=1)
    covered = np.abs(sums - 1.0) <= 1e-3
    # uncovered points (dropped artefacts) carry null probabilities
    need(bool((covered | (sums == 0.0)).all()), "probabilities neither sum to 1 nor are null")
    need(covered.mean() > 0.9, f"only {covered.mean():.3f} of the points are predicted")
    acc = float((np.asarray(res["PredictedClassification"]) == np.asarray(res["Classification"])).mean())
    need(abs(acc - CPU_PLAIN_ACCURACY) <= ACCURACY_MARGIN,
         f"GT accuracy {acc:.4f} vs CPU plain {CPU_PLAIN_ACCURACY:.4f}")
    print(f"phase 4 main path: predict() {dt:.2f} s, {len(res)} points, covered {covered.mean():.4f}, "
          f"GT accuracy {acc:.4f} (CPU plain {CPU_PLAIN_ACCURACY:.4f}), launches {launches}")
    return launches


def phase_step(model, dev):
    """The predict step at the bench shape: kernel path vs plain path."""
    import torch

    x, pos, mask, full_pos, full_mask = (torch.from_numpy(a).to(dev) for a in bench_subtiles(0))
    model.set_sorted_window(WINDOW)

    def step():
        gen = torch.Generator(device=dev).manual_seed(1)
        return model.interp_step(x, pos, mask, pos, full_pos, full_mask, gen)

    def wall_ms(reps: int):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps, out

    counters = launch_counters()
    ms, out_k = wall_ms(5)
    before = {n: fn.launches for n, fn in counters.items()}
    with plain_versions():
        plain_ms, out_p = wall_ms(2)
    need(before == {n: fn.launches for n, fn in counters.items()}, "plain path launched a kernel")
    need(bool(torch.isfinite(out_k).all()) and out_k.shape == (B, M, 7), "bad step output")
    valid = full_mask
    agree = float((out_k.argmax(-1) == out_p.argmax(-1))[valid].float().mean())
    need(agree >= 0.999, f"argmax agreement {agree:.5f} < 0.999")
    mpts = B * RAW / ms / 1e3
    print(f"phase 5 predict step B={B} N={N} M={M}: kernels {ms:.1f} ms/batch "
          f"({mpts:.3f} Mpts/s), plain {plain_ms:.1f} ms/batch ({B * RAW / plain_ms / 1e3:.3f} Mpts/s), "
          f"argmax agreement {agree:.6f}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed")
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    try:
        sys.path.insert(0, ROOT)
        import myria3d_tpu_torch
        from myria3d_tpu_torch.utils.checkpoint import load_checkpoint
    except ImportError as e:
        print(f"FAIL: the port is not importable from {ROOT}: {e}")
        return 1
    if not os.path.abspath(myria3d_tpu_torch.__file__).startswith(os.path.join(ROOT, "")):
        print(f"FAIL: myria3d_tpu_torch was imported from outside {ROOT}")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    try:
        phase_device()
        phase_build()
        model = load_checkpoint(ASSETS, dev)
        with torch.inference_mode():
            stats = phase_kernels(model, dev)
        launches = phase_main_path(dev)
        phase_step(model, dev)
    except Exception:  # noqa: BLE001 - every phase failure ends the run
        traceback.print_exc()
        print("FAIL")
        return 1
    sources = {"K1": ("myria3d_tpu_torch/csrc/knn.cu", "myria3d_tpu/ops/pallas_knn.py:238"),
               "K2": ("myria3d_tpu_torch/csrc/lfa.cu", "myria3d_tpu/ops/pallas_lfa.py:106"),
               "K3": ("myria3d_tpu_torch/csrc/interp.cu", "myria3d_tpu/ops/pallas_knn.py:475")}
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[name],
        "max_abs_err": max(s[0] for s in stats[name]),
        "ms": sum(s[1] for s in stats[name]),
        "plain_ms": sum(s[2] for s in stats[name]),
    } for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
