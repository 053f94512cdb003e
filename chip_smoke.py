#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's predict and train paths (one
NVIDIA GPU).

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
   ms per batch, Mpts/s, argmax agreement (>= 0.999);
6. the train kernels against their plain versions at the train step's
   stage shapes (B=16, N=12288 -> 3072 -> 768 -> 192, K=16, window 4608
   density-scaled per stage): K4 (gather VJP) within 1e-5 of scale, K5 (rel
   statistics) within 1e-5 of its float64 plain version, with the variance
   it implies within 1e-4 of the unfused route's two-pass masked variance,
   K6 (fused LFA backward) within 1e-4 (dx) and 1e-3 (d(att_w), BN sums)
   of its float64 plain version;
7. the train path: the port's ``Trainer.fit`` on toy-tile subtiles
   (``overfit_batches: 1``, 20 steps) at a batch under each
   ``fused_train_lfa: auto`` route; finite losses whose last five average
   below the first five, K4 (unfused) and K5/K6 (fused) launched, and the
   port's ``predict()`` run with the checkpoint the fit wrote;
8. the train step at ``bench.py --train``'s shape (N=12288, uniform
   positions in [-25, 25], 7 classes): both routes timed in turns at B = 4,
   8, 10 (the base run's), 16 (the bench's) and 32 (the datamodule's
   default), with the plain path beside the kernel path at B=16 and 10:
   ms/step (updated parameters consumed), Mpts/s, peak memory, and the
   cosine of the whole-model gradient between the routes and between the
   paths (>= 0.999).

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
TOL = {"K1": 1e-6, "K2": 1e-4, "K3": 1e-5, "K4": 1e-5, "K5": 1e-5, "K6": 1e-4, "K6sum": 1e-3,
       "var": 1e-4}
TRAIN_N = 12_288                             # bench.py --train
FIT_STEPS = 20


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
    from myria3d_tpu_torch.ops import (
        cuda_gather,
        cuda_interp,
        cuda_knn,
        cuda_lfa,
        cuda_lfa_train,
        interpolate,
        knn,
        nn1,
    )

    def lfa_train_bwd_plain(x, pos, idx, nv, inv, *rest):
        return cuda_lfa_train.lfa_train_bwd_plain(x, pos, idx, nv, *rest)

    def gather_neighbors_plain(payload, idx, nv, inv=None):
        return cuda_gather.gather_neighbors_plain(payload, idx, nv)

    patches = [(knn, "knn_topk", cuda_knn.knn_topk_plain),
               (nn1, "knn_topk", cuda_knn.knn_topk_plain),
               (interpolate, "knn_interp", cuda_interp.knn_interp_plain),
               (randla_net, "lfa_attention", cuda_lfa.lfa_attention_plain),
               (randla_net, "gather_neighbors", gather_neighbors_plain),
               (cuda_lfa_train, "lfa_attention", cuda_lfa.lfa_attention_plain),
               (cuda_lfa_train, "rel_stats", cuda_lfa_train.rel_stats_plain),
               (cuda_lfa_train, "lfa_train_bwd", lfa_train_bwd_plain)]
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
    from myria3d_tpu_torch.ops.cuda_gather import gather_bwd
    from myria3d_tpu_torch.ops.cuda_interp import knn_interp
    from myria3d_tpu_torch.ops.cuda_knn import knn_topk
    from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention
    from myria3d_tpu_torch.ops.cuda_lfa_train import lfa_train_bwd, rel_stats

    return {"K1": knn_topk, "K2": lfa_attention, "K3": knn_interp, "K4": gather_bwd,
            "K5": rel_stats, "K6": lfa_train_bwd}


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
        counters = {k: v for k, v in launch_counters().items() if k in ("K1", "K2", "K3")}
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


def train_batch(b: int, seed: int = 0):
    """``bench.py --train``'s batch: N=12288 uniform positions in [-25, 25],
    uniform features, random labels over 7 classes."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (b, TRAIN_N, 9)).astype(np.float32),
            rng.uniform(-25, 25, (b, TRAIN_N, 3)).astype(np.float32),
            rng.integers(0, 7, (b, TRAIN_N)).astype(np.int64),
            np.ones((b, TRAIN_N), bool))


def phase_train_kernels(dev):
    """K4/K5/K6 against their plain versions at the train stage shapes."""
    import torch

    from myria3d_tpu_torch.ops.cuda_gather import gather_bwd, gather_bwd_plain, inverse_map
    from myria3d_tpu_torch.ops.cuda_knn import stage_window
    from myria3d_tpu_torch.ops.cuda_lfa_train import (
        lfa_train_bwd,
        lfa_train_bwd_plain,
        locse,
        moments,
        rel_stats,
        rel_stats_plain,
    )
    from myria3d_tpu_torch.ops.knn import gather_rows, knn_graph
    from myria3d_tpu_torch.ops.masked import masked_var
    from myria3d_tpu_torch.ops.sampling import random_decimation

    _, pos, _, mask = (torch.from_numpy(a).to(dev) for a in train_batch(16, 1))
    key = torch.where(mask, pos[..., 0], float("inf"))
    order = key.sort(dim=1, stable=True).indices
    pos = gather_rows(pos, order)
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = [(pos, mask)]
    for _ in range(3):
        p, m = stages[-1]
        idx, m2 = random_decimation(m, 4, gen)
        stages.append((gather_rows(p, idx), m2))

    stats = {"K4": [], "K5": [], "K6": []}

    def record(name, label, err, fn_k, fn_p, reps=5, reps_p=2):
        ms, plain_ms = cuda_ms(fn_k, reps), cuda_ms(fn_p, reps_p)
        stats[name].append((err, ms, plain_ms))
        print(f"phase 6 {name} {label}: max_abs_err {err:.3g}, {ms:.3f} ms, plain {plain_ms:.3f} ms")

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    for d_out, (p, m) in zip((32, 128, 256, 512), stages):
        n = p.shape[1]
        w = stage_window(WINDOW, n)
        idx, _, nv = knn_graph(p, m, 16, window=w)
        inv = inverse_map(idx, nv, n)
        for width in (3 + d_out // 8, d_out // 4):      # the wide gather, lfa2's gather
            dout = rnd(16, n, 16, width)
            err = scale_err(gather_bwd(dout, idx, nv, inv, n),
                            gather_bwd_plain(dout, idx, nv, n), TOL["K4"], f"K4 P={width}")
            record("K4", f"P={width} N={n}", err, lambda: gather_bwd(dout, idx, nv, inv, n),
                   lambda: gather_bwd_plain(dout, idx, nv, n))

        got = rel_stats(p, idx, nv)
        err = scale_err(got, rel_stats_plain(p.double(), idx, nv), TOL["K5"], "K5")
        # the encoder variance the moments imply against the unfused route's
        # two-pass masked variance over the edges
        w_e, b_e = rnd(d_out // 4, 10, scale=0.3), rnd(d_out // 4, scale=0.3)
        _, var, _, _, _ = moments(got, w_e, b_e)
        e = locse(p, gather_rows(p, idx)) @ w_e.T + b_e
        two_pass = masked_var(e, nv[..., None], dim=(0, 1, 2))
        var_err = scale_err(var, two_pass, TOL["var"], "K5 variance vs two-pass")
        record("K5", f"N={n} (window {w}; variance vs two-pass {var_err:.3g} of "
               f"{float(two_pass.abs().max()):.3g})", err,
               lambda: rel_stats(p, idx, nv), lambda: rel_stats_plain(p, idx, nv))

        for c_in in (d_out // 8, d_out // 4):           # lfa1, lfa2
            args = (rnd(16, n, c_in), p, idx, nv, rnd(c_in, 10, scale=0.3), rnd(c_in, scale=0.3),
                    1.0 + rnd(c_in, scale=0.2), rnd(c_in, scale=0.2),
                    rnd(2 * c_in, 2 * c_in, scale=(2 * c_in) ** -0.5), rnd(16, n, 2 * c_in))
            got = lfa_train_bwd(*args[:4], inv, *args[4:])
            want = lfa_train_bwd_plain(*(a.double() if a.is_floating_point() else a for a in args))
            errs = [scale_err(a, b.float(), tol, f"K6 C_in={c_in} {what}") for a, b, tol, what in
                    zip(got, want, (TOL["K6"], TOL["K6sum"], TOL["K6sum"]), ("dx", "d_att_w", "sums"))]
            record("K6", f"C_in={c_in} N={n} (dx/d_att_w/sums errs "
                   + "/".join(f"{e:.3g}" for e in errs) + ")", errs[0],
                   lambda: lfa_train_bwd(*args[:4], inv, *args[4:]),
                   lambda: lfa_train_bwd_plain(*args), reps_p=1)
    return stats


class TileDataModule:
    """Toy-tile subtiles for ``Trainer.fit``, read straight from the LAS
    file: the card has no ``h5py`` for the HDF5 sample cache, so the train
    and eval transforms of the config run on ``TileSampleStream`` samples
    of the committed tile."""

    def __init__(self, cfg: dict):
        from myria3d_tpu.pctl.transforms.compose import CustomCompose
        from myria3d_tpu.utils.config import instantiate

        dm = cfg["datamodule"]
        t = dm["transforms"]
        stages = {k: [instantiate(x) for x in t[k]] for k in (
            "preparations_train_list", "preparations_eval_list", "normalizations_list",
            "augmentations_list")}
        self.train_transform = CustomCompose(stages["preparations_train_list"]
                                             + stages["normalizations_list"]
                                             + stages["augmentations_list"])
        self.eval_transform = CustomCompose(stages["preparations_eval_list"]
                                            + stages["normalizations_list"])
        self.dm = dm
        self.batch_size = int(dm["batch_size"])
        self.pre_transform = instantiate(dm["points_pre_transform"])
        self.pre_filter = instantiate(dm.get("pre_filter"))

    def prepare_data(self, stage=None):
        pass

    def setup(self, stage=None):
        pass

    def _loader(self, transform, seed=None):
        from myria3d_tpu.pctl.dataset.tile_stream import TileSampleStream
        from myria3d_tpu.pctl.loader import PaddedBatchLoader

        stream = TileSampleStream(
            os.path.join(ASSETS, "toy_tile.las"), self.dm.get("epsg"),
            self.dm["tile_width"], self.dm["subtile_width"], 0, self.pre_transform,
            pre_filter=self.pre_filter, transform=transform)
        return PaddedBatchLoader(stream, batch_size=self.batch_size, num_workers=1,
                                 seed=seed, process_index=0, process_count=1)

    def train_dataloader(self, seed=None):
        return self._loader(self.train_transform, seed)

    def val_dataloader(self):
        return self._loader(self.eval_transform)


def phase_fit(dev):
    """The port's Trainer.fit on toy-tile subtiles under each auto route,
    then predict() with the checkpoint it wrote."""
    from myria3d_tpu.pctl.io.las import read_las
    from myria3d_tpu_torch.models.modules.randla_net import FUSED_TRAIN_MIN_BATCH
    from myria3d_tpu_torch.predict import predict
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config
    from myria3d_tpu_torch.train import build_trainer

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    runs = []
    with tempfile.TemporaryDirectory(prefix="m3d_fit_") as work:
        # 16 m subtiles: the 100 m toy tile gives 49 of up to ~1.5k points
        for batch in (4, FUSED_TRAIN_MIN_BATCH):
            run_dir = os.path.join(work, f"b{batch}")
            cfg = compose_config(CONFIG_DIR, "config.yaml", [
                "task.task_name=fit", "dataset_description=toy_synthetic", "logger=csv",
                f"hydra.run.dir={run_dir}", "trainer.overfit_batches=1",
                f"trainer.max_epochs={FIT_STEPS}", f"trainer.min_epochs={FIT_STEPS}",
                f"datamodule.batch_size={batch}", "datamodule.subtile_width=16",
                f"trainer.accelerator={'gpu' if dev.type == 'cuda' else 'cpu'}",
                f"callbacks.model_checkpoint.dirpath={run_dir}/checkpoints",
            ])
            trainer, model = build_trainer(cfg)
            route = "fused" if batch >= FUSED_TRAIN_MIN_BATCH else "unfused"
            before = {n: fn.launches for n, fn in counters.items()}
            t0 = time.perf_counter()
            trainer.fit(model, TileDataModule(cfg))
            dt = time.perf_counter() - t0
            used = {n: fn.launches - before[n] for n, fn in counters.items()}
            losses = trainer.train_losses
            need(len(losses) == FIT_STEPS and all(np.isfinite(losses)), f"fit losses {losses}")
            first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
            need(last < first, f"B={batch} loss did not fall: first five {first:.4f}, "
                 f"last five {last:.4f}")
            want = ("K4",) if route == "unfused" else ("K5", "K6")
            need(all(used[k] > 0 for k in want), f"B={batch} {route}: launches {used}")
            print(f"phase 7 fit B={batch} ({route} route): {FIT_STEPS} steps in {dt:.1f} s, "
                  f"loss first five {first:.4f} -> last five {last:.4f}, launches {used}")
            runs.append((cfg, trainer.checkpoint_cb.last_model_path))
        launches = {n: fn.launches for n, fn in counters.items()}

        cfg, ckpt = runs[-1]
        tile = os.path.join(ASSETS, "toy_tile.las")
        pcfg = compose_config(CONFIG_DIR, "config.yaml", [
            "task.task_name=predict", f"predict.src_las={tile}", f"predict.ckpt_path={ckpt}",
            f"predict.output_dir={work}/pred", f"predict.gpus={int(dev.type == 'cuda')}",
            "datamodule.batch_size=4"])
        out = predict(pcfg)
        res = read_las(out).points
        names = list(pcfg["predict"]["interpolator"]["classification_dict"].values())
        probas = np.stack([np.asarray(res[n], np.float64) for n in names], axis=1)
        need(len(res) == len(read_las(tile).points), "predict output point count")
        need(bool(np.isfinite(probas).all()), "NaN in the predicted probabilities")
        acc = float((np.asarray(res["PredictedClassification"]) == np.asarray(res["Classification"])).mean())
        print(f"phase 7 predict with the fit checkpoint: {len(res)} points, GT accuracy {acc:.4f}")
    return launches


def phase_train_step(dev):
    """The train step at bench.py --train's shape: both routes on the kernel
    path, timed in turns (fused, unfused, unfused, fused) at B = 4 ... 32,
    which places the ``fused_train_lfa: auto`` threshold; at B=16 and 10
    also the plain path, and the gradient cosines."""
    import torch

    from myria3d_tpu_torch.models.model import build_model

    def make(fused):
        torch.manual_seed(0)
        model = build_model("RandLANet", {
            "num_features": 9, "num_classes": 7, "num_neighbors": 16, "decimation": 4,
            "knn_window": WINDOW, "sort_inputs": True, "fused_train_lfa": fused}, lr=0.001)
        model.to(dev)
        model.init_train_state()
        return model

    def grads(model, batch):
        model.net.train()
        model.optimizer.zero_grad(set_to_none=True)
        gen = torch.Generator(device=dev).manual_seed(7)
        loss = model.criterion(model.net(batch[0], batch[1], batch[3], gen), batch[2])
        loss.backward()
        return torch.cat([p.grad.flatten() for p in model.net.parameters()])

    def timed(model, batch, reps):
        """ms per step over ``reps`` steps, each reading the parameters the
        last one wrote (the sync comes after the last update), and the peak
        memory."""
        def step(i):
            return model.train_step(*batch, torch.Generator(device=dev).manual_seed(i))
        step(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for i in range(reps):
            loss, _ = step(i + 1)
        chk = sum(float(p.detach().sum()) for p in model.net.parameters())
        dt = (time.perf_counter() - t0) * 1e3 / reps
        need(np.isfinite(float(loss)) and np.isfinite(chk), "non-finite train step")
        return dt, torch.cuda.max_memory_allocated(dev) / 2**30

    def cos(a, b):
        return float((a.double() @ b.double()) / (a.double().norm() * b.double().norm()))

    rows = []
    for b in (4, 8, 10, 16, 32):
        batch = [torch.from_numpy(a).to(dev) for a in train_batch(b)]
        models = {True: make(True), False: make(False)}
        grad = {f: grads(m, batch) for f, m in models.items()}
        ms = {True: [], False: []}
        mem = {}
        for fused in (True, False, False, True):
            dt, mem[fused] = timed(models[fused], batch, 5)
            ms[fused].append(dt)
        c = cos(grad[True], grad[False])
        need(c >= 0.999, f"B={b}: fused/unfused gradient cosine {c:.6f}")
        for fused in (True, False):
            t = float(np.mean(ms[fused]))
            row = {"batch": b, "fused": fused, "ms": t, "turns": ms[fused], "peak_gib": mem[fused]}
            line = (f"phase 8 train step B={b} N={TRAIN_N} {'fused' if fused else 'unfused'}: "
                    f"kernels {t:.1f} ms/step (turns {ms[fused][0]:.1f}, {ms[fused][1]:.1f}; "
                    f"{b * TRAIN_N / t / 1e3:.3f} Mpts/s, peak {mem[fused]:.2f} GiB)")
            if b in (10, 16):
                model = make(fused)
                with plain_versions():
                    g_p = grads(model, batch)
                    plain_ms, plain_mem = timed(model, batch, 1)
                del model
                cp = cos(grad[fused], g_p)
                need(cp >= 0.999, f"B={b} fused={fused}: kernel/plain gradient cosine {cp:.6f}")
                line += (f", plain {plain_ms:.1f} ms/step ({b * TRAIN_N / plain_ms / 1e3:.3f} "
                         f"Mpts/s, peak {plain_mem:.2f} GiB), gradient cosine kernel/plain {cp:.6f}")
                row.update(plain_ms=plain_ms, cos_plain=cp)
            print(line)
            rows.append(row)
        print(f"phase 8 B={b}: gradient cosine fused/unfused {c:.6f}")
        del models, grad
        torch.cuda.empty_cache()
    return rows


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
        del model
        train_stats = phase_train_kernels(dev)
        stats.update(train_stats)
        launches.update({k: v for k, v in phase_fit(dev).items() if k in train_stats})
        phase_train_step(dev)
    except Exception:  # noqa: BLE001 - every phase failure ends the run
        traceback.print_exc()
        print("FAIL")
        return 1
    sources = {"K1": ("myria3d_tpu_torch/csrc/knn.cu", "myria3d_tpu/ops/pallas_knn.py:238"),
               "K2": ("myria3d_tpu_torch/csrc/lfa.cu", "myria3d_tpu/ops/pallas_lfa.py:106"),
               "K3": ("myria3d_tpu_torch/csrc/interp.cu", "myria3d_tpu/ops/pallas_knn.py:475"),
               "K4": ("myria3d_tpu_torch/csrc/gather_bwd.cu", "myria3d_tpu/ops/pallas_gather.py:65"),
               "K5": ("myria3d_tpu_torch/csrc/lfa_train.cu",
                      "myria3d_tpu/ops/pallas_lfa_train.py:162"),
               "K6": ("myria3d_tpu_torch/csrc/lfa_train.cu",
                      "myria3d_tpu/ops/pallas_lfa_train.py:192")}
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
