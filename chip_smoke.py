#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's predict, train and test paths
(one NVIDIA GPU).

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, one line each:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the kernels built from ``myria3d_tpu_torch/csrc`` (nvcc, sm_90a), and
   each kernel's registers, stack frame and spill bytes (``cuobjdump
   --dump-resource-usage`` of the library, ``ptxas -v``); every K1/K3
   instantiation, every width's K2/K6 instantiation, every K4
   instantiation and K5 must have neither a stack frame, local memory nor
   spills; K2's and K6's dynamic shared memory and blocks per SM at each
   width;
3. each kernel against its plain PyTorch version at the predict step's
   stage shapes (B=48 subtiles, N=12288 sampled, M=32768 full points):
   K1 (kNN) bit-equal on indices and d2, K2 (fused LFA) within 1e-4 and K3
   (fused interpolation, windowed and full scan) within 1e-5 of the plain
   version's scale (max |kernel - plain| / max |plain|);
4. the main path: ``myria3d_tpu_torch.predict.predict`` on the synthetic
   toy tile with the converted toy checkpoint; the output LAS is checked,
   every kernel must have launched, and the ground-truth accuracy must be
   within 0.02 of the plain path's accuracy on the CPU;
5. the predict step at the bench shape, kernel path against plain path:
   ms per batch, Mpts/s, argmax agreement (>= 0.999); then a
   ``torch.profiler`` trace of three kernel-path steps: device time per
   step by kernel and the device's idle share of the traced window;
6. the train kernels against their plain versions at the train step's
   stage shapes (B=16, N=12288 -> 3072 -> 768 -> 192, K=16, window 4608
   density-scaled per stage): K1 bit-equal on indices and d2 at the four
   self-kNN graphs and the four decoder searches, each timed; K4's inverse
   map equal to the plain version's (offsets, and perm over every range),
   both timed; K4 (gather VJP) within 1e-5 of scale and bit-equal on a
   second call, at the unfused route's eight gather widths and at the
   widths of K6's eight dx scatters, with the sums per train step; K5 (rel
   statistics) within 1e-5 of its float64 plain version, bit-equal on a
   second call, at most two launches and no copy a call, returning while
   the stream is still busy (no host synchronisation), with the variance
   it implies within 1e-4 of the unfused route's two-pass masked variance;
   K6 (fused LFA backward) within 1e-4 (dx) and 1e-3 (d(att_w), BN sums)
   of its float64 plain version;
7. the train path: the port's ``Trainer.fit`` on toy-tile subtiles
   (``overfit_batches: 1``, 20 steps) at a batch under each
   ``fused_train_lfa: auto`` route; finite losses whose last five average
   below the first five, K4 (both routes) and K5/K6 (fused) launched, and the
   port's ``predict()`` run with the checkpoint the fit wrote;
8. the train step at ``bench.py --train``'s shape (N=12288, uniform
   positions in [-25, 25], 7 classes): both routes timed in turns at B = 4,
   8, 10 (the base run's), 16 (the bench's) and 32 (the datamodule's
   default), with the plain path beside the kernel path at B=16 and 10:
   ms/step (updated parameters consumed), Mpts/s, peak memory, the launches
   per step (K4's kernel 8 on either route, K5 4 and K6 8 on the fused one,
   the inverse map 4), and the
   cosine of the whole-model gradient between the routes and between the
   paths (>= 0.999);
9. K7 (``knn_topk(variant="mxu")``, the expanded-score full scan): its path
   run at the full-scan shapes of the predict step (self 768 and self 192,
   B=48) and at a full-scan self 12288 (B=48); indices bit-equal to its
   plain version and d2 within 1e-6 relative; against K1's full scan on the
   same clouds, equal index sets wherever the gap between the k-th and
   (k+1)-th distances exceeds twice the expanded form's rounding bound
   (16 eps (|q|^2 + max |k|^2)) and d2 within that bound there; K7 and K1
   timed side by side;
10. the full-cloud test path: ``Trainer.test`` on the toy-tile subtiles
   (with their full-cloud copies) and phase 7's B=32 checkpoint; K1, K2 and
   K3 launched, ``test/loss_epoch`` and the mean IoU printed, and held
   against the same test on the plain versions (loss within 1e-3 relative,
   IoU within 0.01).

Every kernel line of phases 3, 6 and 9 carries ``bound_ms``: the larger of
the bytes its call must move (inputs read once, outputs written once) over
3.35 TB/s and its FP32 instructions over 33.5 T/s (the H100 SXM's 67
TFLOP/s FP32 counting an FMA as two), with the instructions counted from
this run's data (valid queries or points, the keys each window scans).
K2's and K6's also carry ``tc_bound_ms``, with their attention products
(the FMAs of one pass) at the dense TF32 tensor-core rate of 495 TFLOP/s
and the rest at the FP32 rate; it is the bound they are held to in the
kernels line, as they run those products on the tensor cores. K4's
carries ``library_ms``, the time of ``index_add_`` of the cotangent rows.
Then one JSON line with the kernels and, last, the device JSON line.
Any failure, a missing CUDA device, or a module of JAX or of the JAX
package loaded during the run exits nonzero without a result.
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
TOL = {"K2": 1e-4, "K3": 1e-5, "K4": 1e-5, "K5": 1e-5, "K6": 1e-4, "K6sum": 1e-3,
       "var": 1e-4}
TRAIN_N = 12_288                             # bench.py --train
FIT_STEPS = 20
TRAIN_REPS = 10                              # phase 8's steps per turn
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and FP32 instructions/s
# (67 TFLOP/s with an FMA counted as two flops)
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
TF32_FMA_PER_S = 495e12 / 2                  # dense TF32 tensor cores, FMA as two flops
PAIR_INSTR = 8                               # per (query, key) pair of a search


class PhaseError(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(instr: float, n_bytes: float):
    """(bound_ms, bound_by): the least time for ``instr`` FP32 instructions
    and ``n_bytes`` of device memory traffic on the H100 SXM."""
    t_ops, t_bytes = instr / FP32_INSTR_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tc_bound(fmas: float, instr: float, n_bytes: float):
    """(bound_ms, bound_by) of a kernel whose ``fmas`` product FMAs may run
    on the TF32 tensor cores (one pass) and whose other ``instr`` FP32
    instructions run on the CUDA cores, against ``n_bytes`` of traffic."""
    return bound(instr + fmas * FP32_INSTR_PER_S / TF32_FMA_PER_S, n_bytes)


def bounds_text(bnd, cuda_bnd=None) -> str:
    """A kernel line's bounds: ``bound_ms``, or for a tensor-core kernel the
    FP32 ``bound_ms`` (``cuda_bnd``) beside the ``tc_bound_ms`` it is held to."""
    if cuda_bnd is None:
        return f"bound_ms {bnd[0]:.4f} ({bnd[1]})"
    return f"bound_ms {cuda_bnd[0]:.4f} ({cuda_bnd[1]}), tc_bound_ms {bnd[0]:.4f} ({bnd[1]})"


def cuda_ms(fn, reps: int, warmup: int = 1, ahead: bool = False) -> float:
    """Mean device time of ``fn`` in ms (CUDA events over ``reps`` calls).
    ``ahead`` queues long matrix products first, so the host enqueues the
    calls while the card is still busy and the events see the card's time
    alone; without it a call that takes the host longer to enqueue than the
    card to run shows the host's time. The products must still be running
    when the last call is enqueued: if not, the turn is repeated behind
    more of them, and the run fails where the host never gets ahead."""
    import torch

    for _ in range(warmup):
        fn()
    plug = torch.zeros((8192, 8192), device="cuda") if ahead else None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for plugs in (1, 2, 4, 8) if ahead else (0,):
        torch.cuda.synchronize()
        for _ in range(plugs):
            plug @ plug
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        was_ahead = not start.query()
        end.synchronize()
        if was_ahead or not ahead:
            return start.elapsed_time(end) / reps
    raise PhaseError(f"the host did not enqueue {reps} calls within 8 long products' time")


def device_work(fn, counter) -> str:
    """What one warm call of ``fn`` puts on the stream: the launches of its
    own kernel (``counter.launches``) and every PyTorch operator it calls
    that is no allocation or view (each may launch or copy), from a
    dispatch trace. More than two in all, or a copy, fails the run."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    free = ("empty", "view", "alias", "detach", "as_strided", "reshape", "_unsafe_view")
    ops = []

    class Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    fn()
    before = counter.launches
    with Trace():
        fn()
    torch.cuda.synchronize()
    own = counter.launches - before
    other = [name for name in ops if not name.startswith(free)]
    copies = [name for name in other if "copy" in name or name == "to"]
    need(own >= 1 and own + len(other) <= 2 and not copies,
         f"{own} launches of the kernel and the operators {other} in one call")
    return f"{own} launch of its kernel and {len(other)} other operators a call"


def host_runs_ahead(fn, what: str) -> None:
    """``fn`` must return while the stream is still busy with work queued
    before it: a host-to-device copy from pageable memory, an ``.item()``
    or any other synchronisation inside it would drain the stream first."""
    import torch

    fn()
    a = torch.zeros((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    for _ in range(4):          # some 100 ms of products
        a @ a
    fn()
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    need(busy, f"{what}: the call waited for the stream (a host synchronisation inside it)")


def bench_subtiles(seed: int = 0):
    """Synthetic subtiles built as bench.py builds them: 30 000 raw points
    per 50 m subtile, GridSampling(0.25) on the host, x-sorted sampled and
    full clouds padded to N and M."""
    from myria3d_tpu_torch.pctl.transforms.transforms import CopyFullPos, GridSampling

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

    # the wrappers' arguments that only the kernels read (the inverse map,
    # the marked indices) are dropped
    def lfa_train_bwd_plain(x, pos, idx, nv, inv, *rest):
        return cuda_lfa_train.lfa_train_bwd_plain(x, pos, idx, nv, *rest[:6])

    def gather_neighbors_plain(payload, idx, nv, inv=None):
        return cuda_gather.gather_neighbors_plain(payload, idx, nv)

    def lfa_attention_plain(*args, idx_marked=None):
        return cuda_lfa.lfa_attention_plain(*args[:7])

    def rel_stats_plain(pos, idx, nv, idx_marked=None):
        return cuda_lfa_train.rel_stats_plain(pos, idx, nv)

    patches = [(knn, "knn_topk", cuda_knn.knn_topk_plain),
               (nn1, "knn_topk", cuda_knn.knn_topk_plain),
               (interpolate, "knn_interp", cuda_interp.knn_interp_plain),
               (randla_net, "lfa_attention", lfa_attention_plain),
               (randla_net, "gather_neighbors", gather_neighbors_plain),
               (randla_net, "inverse_map", cuda_gather.inverse_map_plain),
               (randla_net, "rel_stats", rel_stats_plain),
               (cuda_lfa_train, "inverse_map", cuda_gather.inverse_map_plain),
               (cuda_lfa_train, "lfa_attention", lfa_attention_plain),
               (cuda_lfa_train, "rel_stats", rel_stats_plain),
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


# kernels that must have no stack frame, local memory or spills, and how
# many instantiations each family has: K1/K3 (topk.cuh's search), K2 and K6
# (lfa_tile.cuh's edge tile, one per width), K4 (float4 and scalar rows)
# and K5
CLEAN_KERNELS = {"knn_topk_kernel<": 3, "knn_interp_kernel<": 2, "lfa_kernel<": 6,
                 "lfa_bwd_kernel<": 6, "gather_bwd_kernel<": 2, "relstats_kernel<": 2}


def phase_build():
    from myria3d_tpu_torch import _ext

    t0 = time.perf_counter()
    path = _ext.build()
    _ext.lib()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path, ROOT)}")
    usage = _ext.resource_usage(path)
    for name, u in sorted(usage.items()):
        print(f"phase 2 resources {name}: {u.get('reg')} registers, stack frame {u.get('stack')} B, "
              f"local {u.get('local')} B, spill stores {u.get('spill_stores')} B, "
              f"spill loads {u.get('spill_loads')} B")
    for family, count in CLEAN_KERNELS.items():
        found = sorted(n for n in usage if n.startswith(family))
        need(len(found) == count, f"expected {count} {family}...> instantiations, found {found}")
    clean = {n: u for n, u in usage.items() if n.startswith(tuple(CLEAN_KERNELS))}
    bad = [n for n, u in clean.items()
           if any(u.get(key) != 0 for key in ("stack", "local", "spill_stores", "spill_loads"))]
    need(not bad, f"K1-K6 instantiations with a stack frame, local memory or spills: {bad}")
    from myria3d_tpu_torch.ops.cuda_lfa import WIDTHS, launch_info
    from myria3d_tpu_torch.ops.cuda_lfa_train import bwd_launch_info

    for name, info_of in (("K2", launch_info), ("K6", bwd_launch_info)):
        for c in WIDTHS:
            info = info_of(c)
            print(f"phase 2 {name} C={c}: {info['points_per_tile']} points a tile, "
                  f"{info['bands']} d(att_w) band(s), dynamic shared memory "
                  f"{info['smem_bytes']} B, {info['blocks_per_sm']} block(s) per SM")


def check_k1(idx_k, d2_k, idx_p, d2_p, what: str) -> float:
    """The kernel's indices and d2 bit-equal to the plain version's."""
    import torch

    need(bool(torch.equal(d2_k, d2_p)), f"K1 {what}: d2 differs from the plain version")
    need(bool(torch.equal(idx_k, idx_p)), f"K1 {what}: indices differ from the plain version "
         f"at {int((idx_k != idx_p).sum())} slots")
    return float((d2_k - d2_p).abs().max())


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
    from myria3d_tpu_torch.ops.cuda_knn import _windows, knn_topk, knn_topk_plain, stage_window
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

    def record(name, label, err, fn_k, fn_p, bnd, reps_p=2, cuda_bnd=None):
        ms, plain_ms = cuda_ms(fn_k, 5), cuda_ms(fn_p, reps_p)
        stats[name].append((err, ms, plain_ms, bnd, None))
        print(f"phase 3 {name} {label}: max_abs_err {err:.3g}, {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              + bounds_text(bnd, cuda_bnd))

    k1_cases = [("K=16 self 12288", stages[0], stages[0], 16),
                ("K=16 self 3072", stages[1], stages[1], 16),
                ("K=1 12288<-3072", stages[0], stages[1], 1),
                ("K=1 768<-192", stages[2], stages[3], 1)]
    for label, (qp, qm), (kp, km), k in k1_cases:
        q4, k4 = centred_clouds(qp, kp, km)
        w = stage_window(WINDOW, kp.shape[1])
        idx_k, d2_k = knn_topk(q4, k4, k, window=w, query_mask=qm)
        idx_p, d2_p = knn_topk_plain(q4, k4, k, window=w, query_mask=qm)
        err = check_k1(idx_k, d2_k, idx_p, d2_p, label)
        scanned = _windows(q4, k4, w, qm)[1]
        bnd = bound(PAIR_INSTR * float(qm.sum()) * scanned, nbytes(q4, k4, idx_k, d2_k))
        record("K1", f"{label} (window {w})", err,
               lambda: knn_topk(q4, k4, k, window=w, query_mask=qm),
               lambda: knn_topk_plain(q4, k4, k, window=w, query_mask=qm), bnd)

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
                got = lfa_attention(*args)
                err = scale_err(got, lfa_attention_plain(*args),
                                TOL["K2"], f"K2 ({c_in},{2 * c_in})")
                # per valid point and slot: the attention product (C^2), the
                # encoder (10 per encoder channel) and the masked softmax
                # and pooling (~4 per channel), C = 2 c_in; the product on
                # the CUDA cores (bound_ms) or the TF32 tensor cores
                # (tc_bound_ms, which the kernel is held to)
                c = 2 * c_in
                slots = float(m.sum()) * 16
                n_bytes = nbytes(*args, got)
                cuda_bnd = bound(slots * (c * c + 10 * c_in + 4 * c), n_bytes)
                bnd = tc_bound(slots * c * c, slots * (10 * c_in + 4 * c), n_bytes)
                record("K2", f"({c_in},{2 * c_in}) N={p.shape[1]}", err,
                       lambda: lfa_attention(*args), lambda: lfa_attention_plain(*args), bnd,
                       cuda_bnd=cuda_bnd)

    logits = torch.randn((B, N, 7), generator=gen, device=dev) * 3
    q4, k4 = centred_clouds(full_pos, pos, mask)
    args = (logits, q4, k4, 10)
    # the windowed search of the shipped config, then the full scan that
    # predict.sorted_window=0 takes
    for w in (stage_window(WINDOW, N), 0):
        kw = dict(window=w, query_mask=full_mask)
        got = knn_interp(*args, **kw)
        err = scale_err(got, knn_interp_plain(*args, **kw), TOL["K3"], "K3")
        # the scan's pairs, plus the weighting of k payload rows per query
        n_q = float(full_mask.sum())
        bnd = bound(PAIR_INSTR * n_q * _windows(q4, k4, w, full_mask)[1] + n_q * 10 * (2 * 7 + 4),
                    nbytes(logits, q4, k4, full_mask, got))
        record("K3", f"k=10 32768<-12288 ({f'window {w}' if w else 'full scan'})", err,
               lambda: knn_interp(*args, **kw), lambda: knn_interp_plain(*args, **kw), bnd,
               reps_p=2 if w else 1)
    return stats


def launch_counters():
    from myria3d_tpu_torch.ops.cuda_gather import gather_bwd, inverse_map
    from myria3d_tpu_torch.ops.cuda_interp import knn_interp
    from myria3d_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_mxu
    from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention
    from myria3d_tpu_torch.ops.cuda_lfa_train import lfa_train_bwd, rel_stats

    # K4 counts its kernel's every launch: the gathers' VJP and K6's dx
    # scatter; inverse_map is K4's map, built by the kernels beside it
    return {"K1": knn_topk, "K2": lfa_attention, "K3": knn_interp, "K4": gather_bwd,
            "K5": rel_stats, "K6": lfa_train_bwd, "K7": knn_topk_mxu,
            "inverse_map": inverse_map}


def phase_main_path(dev):
    """The port's predict() on the toy tile, through the kernels."""
    from myria3d_tpu_torch.pctl.io.las import read_las
    from myria3d_tpu_torch.predict import predict
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config

    tile = os.path.join(ASSETS, "toy_tile.las")
    with tempfile.TemporaryDirectory(prefix="m3d_predict_") as out_dir:
        cfg = compose_config(CONFIG_DIR, "config.yaml", [
            "task.task_name=predict", f"predict.src_las={tile}", f"predict.ckpt_path={ASSETS}",
            f"predict.output_dir={out_dir}", "datamodule.batch_size=4",
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
    start = {n: fn.launches for n, fn in counters.items()}
    ms, out_k = wall_ms(5)
    # the host's share: enqueueing steps without waiting for the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()
    before = {n: fn.launches for n, fn in counters.items()}
    per_step = {n: (before[n] - start[n]) / 9 for n in counters if before[n] > start[n]}
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
          f"argmax agreement {agree:.6f}, launches per step {per_step}; host enqueue "
          f"{host_ms:.1f} ms/step")
    print(f"phase 5 profile: {profile_steps(step)}")


def profile_steps(step, reps: int = 3) -> str:
    """Device time per step by kernel and the device's idle share between
    the first and the last device activity of a ``torch.profiler`` trace of
    ``reps`` steps; "not measured" with the reason if the trace holds no
    device activity (the profile reports, it does not decide the run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
        spans, by_name = [], {}
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            t0, t1 = ev.time_range.start, ev.time_range.end
            spans.append((t0, t1))
            name = ev.name.split("(")[0].replace("void ", "").replace("m3d::", "")
            by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3 / reps
    except Exception as e:  # noqa: BLE001 - a profiler fault leaves the numbers unmeasured
        return f"not measured ({type(e).__name__}: {e})"
    if not spans:
        return "not measured (no device activity in the trace)"
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for t0, t1 in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    window = end - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    rest = sum(v for _, v in top[10:])
    return (f"{reps} steps, device busy {busy / 1e3 / reps:.2f} ms/step of a "
            f"{window / 1e3 / reps:.2f} ms/step window, idle {100 * (1 - busy / window):.2f} %; "
            "ms/step by kernel: " + ", ".join(f"{n} {v:.3f}" for n, v in top[:10])
            + f", other {rest:.3f}")


def train_batch(b: int, seed: int = 0):
    """``bench.py --train``'s batch: N=12288 uniform positions in [-25, 25],
    uniform features, random labels over 7 classes."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (b, TRAIN_N, 9)).astype(np.float32),
            rng.uniform(-25, 25, (b, TRAIN_N, 3)).astype(np.float32),
            rng.integers(0, 7, (b, TRAIN_N)).astype(np.int64),
            np.ones((b, TRAIN_N), bool))


def phase_train_kernels(dev):
    """K1 and K4/K5/K6 against their plain versions at the train stage
    shapes."""
    import torch

    from myria3d_tpu_torch.ops.cuda_gather import (
        gather_bwd,
        gather_bwd_plain,
        inverse_map,
        inverse_map_plain,
    )
    from myria3d_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_plain, stage_window
    from myria3d_tpu_torch.ops.cuda_lfa import idx_with_invalid
    from myria3d_tpu_torch.ops.cuda_lfa_train import (
        lfa_train_bwd,
        lfa_train_bwd_plain,
        locse,
        moments,
        rel_stats,
        rel_stats_plain,
    )
    from myria3d_tpu_torch.ops.knn import centred_clouds, gather_rows, knn_graph
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

    # K1 at the train step's searches (B=16): the four self-kNN graphs and
    # the four decoder searches, the last into a fifth stage of 48 points
    # (drawn from its own generator: ``gen`` keeps feeding K4-K6 the inputs
    # it fed them before)
    idx, m5 = random_decimation(stages[3][1], 4, torch.Generator(device=dev).manual_seed(1))
    s48 = (gather_rows(stages[3][0], idx), m5)
    searches = [(f"K=16 self {p.shape[1]}", (p, m), (p, m), 16) for p, m in stages]
    searches += [(f"K=1 {q[0].shape[1]}<-{kk[0].shape[1]}", q, kk, 1)
                 for q, kk in zip(stages, stages[1:] + [s48])]
    k1_ms = 0.0
    for label, (qp, qm), (kp, km), k in searches:
        q4, k4 = centred_clouds(qp, kp, km)
        w = stage_window(WINDOW, kp.shape[1])
        check_k1(*knn_topk(q4, k4, k, window=w, query_mask=qm),
                 *knn_topk_plain(q4, k4, k, window=w, query_mask=qm), label)
        ms = cuda_ms(lambda: knn_topk(q4, k4, k, window=w, query_mask=qm), 5)
        k1_ms += ms
        print(f"phase 6 K1 {label} B=16 (window {w}): bit-equal to the plain version, {ms:.3f} ms")
    print(f"phase 6 K1 per B=16 train step ({len(searches)} searches): {k1_ms:.3f} ms")

    stats = {"K4": [], "K5": [], "K6": []}

    def record(name, label, err, fn_k, fn_p, bnd, reps=5, reps_p=2, fn_lib=None, cuda_bnd=None,
               ahead=False):
        """``ahead`` (K4, K5: calls the host takes longer to enqueue than
        the card to run): the card's time with the host running ahead, and the
        time as enqueued on an idle stream beside it."""
        ms, plain_ms = cuda_ms(fn_k, 20 if ahead else reps, ahead=ahead), cuda_ms(fn_p, reps_p)
        lib_ms = cuda_ms(fn_lib, reps, ahead=ahead) if fn_lib is not None else None
        stats[name].append((err, ms, plain_ms, bnd, lib_ms))
        print(f"phase 6 {name} {label}: max_abs_err {err:.3g}, {ms:.4f} ms"
              + (f" ({cuda_ms(fn_k, 20):.4f} ms as enqueued)" if ahead else "")
              + f", plain {plain_ms:.3f} ms, " + bounds_text(bnd, cuda_bnd)
              + (f", library_ms {lib_ms:.3f} (index_add_)" if lib_ms is not None else ""))

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    step_ms = {"map": 0.0, "map_plain": 0.0, "gathers": 0.0, "dx": 0.0}
    gen_dx = torch.Generator(device=dev).manual_seed(2)   # ``gen`` keeps its sequence of draws
    for d_out, (p, m) in zip((32, 128, 256, 512), stages):
        n = p.shape[1]
        w = stage_window(WINDOW, n)
        idx, _, nv = knn_graph(p, m, 16, window=w)
        # K4's inverse map: the kernels' against the stable sort's
        inv, inv_p = inverse_map(idx, nv, n), inverse_map_plain(idx, nv, n)
        n_valid = int(inv_p.offsets[-1])
        need(n_valid == int(nv.sum()), f"inverse map N={n}: offsets end at {n_valid}")
        need(bool(torch.equal(inv.offsets, inv_p.offsets)), f"inverse map N={n}: offsets differ")
        need(bool(torch.equal(inv.perm[:n_valid], inv_p.perm[:n_valid])),
             f"inverse map N={n}: perm differs from the stable sort's")
        map_ms, map_plain_ms = (cuda_ms(lambda: fn(idx, nv, n), 20, ahead=True)
                                for fn in (inverse_map, inverse_map_plain))
        step_ms["map"] += map_ms
        step_ms["map_plain"] += map_plain_ms
        print(f"phase 6 inverse_map N={n} B=16 K=16 ({n_valid} valid slots): equal to the plain "
              f"version, {map_ms:.4f} ms ({cuda_ms(lambda: inverse_map(idx, nv, n), 20):.4f} ms as "
              f"enqueued), plain {map_plain_ms:.3f} ms "
              f"({cuda_ms(lambda: inverse_map_plain(idx, nv, n), 20):.3f} as enqueued; stable sort, "
              "searchsorted)")
        # index_add_'s operands: the cotangent rows of the valid slots and
        # their global key rows (built outside its timing)
        rows_key = (idx.long() + torch.arange(idx.shape[0], device=dev)[:, None, None] * n).reshape(-1)

        def k4_case(width, gen=gen):
            dout = torch.randn((16, n, 16, width), generator=gen, device=dev)
            got = gather_bwd(dout, idx, nv, inv, n)
            need(bool(torch.equal(got, gather_bwd(dout, idx, nv, inv, n))),
                 f"K4 P={width} N={n}: a second call differs")
            err = scale_err(got, gather_bwd_plain(dout, idx, nv, n), TOL["K4"], f"K4 P={width}")
            # the kernel reads the cotangents and the map, and writes the sums
            bnd = bound(float(nv.sum()) * width, nbytes(dout, inv.perm, inv.offsets, got))
            return dout, got, err, bnd

        for width in (3 + d_out // 8, d_out // 4):      # the wide gather, lfa2's gather
            dout, got, err, bnd = k4_case(width)
            rows = torch.where(nv[..., None], dout, 0.0).reshape(-1, width)
            target = torch.zeros((16 * n, width), device=dev)
            record("K4", f"P={width} N={n}", err, lambda: gather_bwd(dout, idx, nv, inv, n),
                   lambda: gather_bwd_plain(dout, idx, nv, n), bnd,
                   fn_lib=lambda: target.index_add_(0, rows_key, rows), ahead=True)
            step_ms["gathers"] += stats["K4"][-1][1]
        for width in (d_out // 8, d_out // 4):          # K6's dx scatter of lfa1, lfa2
            dout, got, err, bnd = k4_case(width, gen_dx)
            ms = cuda_ms(lambda: gather_bwd(dout, idx, nv, inv, n), 20, ahead=True)
            step_ms["dx"] += ms
            print(f"phase 6 K4 as K6's dx scatter P={width} N={n}: max_abs_err {err:.3g}, bit-equal "
                  f"on a second call, {ms:.4f} ms, " + bounds_text(bnd))
        del dout, got, rows, target

        # as the train block calls it: on the marked indices it made already
        marked = idx_with_invalid(idx, nv)
        got = rel_stats(p, idx, nv, marked)
        need(bool(torch.equal(got, rel_stats(p, idx, nv, marked))), f"K5 N={n}: a second call differs")
        need(bool(torch.equal(got, rel_stats(p, idx, nv))),
             f"K5 N={n}: the call that marks the indices itself gives other sums")
        err = scale_err(got, rel_stats_plain(p.double(), idx, nv), TOL["K5"], "K5")
        # the encoder variance the moments imply against the unfused route's
        # two-pass masked variance over the edges
        w_e, b_e = rnd(d_out // 4, 10, scale=0.3), rnd(d_out // 4, scale=0.3)
        _, var, _, _, _ = moments(got, w_e, b_e)
        e = locse(p, gather_rows(p, idx)) @ w_e.T + b_e
        two_pass = masked_var(e, nv[..., None], dim=(0, 1, 2))
        var_err = scale_err(var, two_pass, TOL["var"], "K5 variance vs two-pass")
        # per valid slot: the 10 rel features (~20) and 66 product sums
        bnd = bound(float(nv.sum()) * (20 + 66), nbytes(p, idx, nv, got))
        record("K5", f"N={n} (window {w}; variance vs two-pass {var_err:.3g} of "
               f"{float(two_pass.abs().max()):.3g}; "
               f"{device_work(lambda: rel_stats(p, idx, nv, marked), rel_stats)})",
               err, lambda: rel_stats(p, idx, nv, marked), lambda: rel_stats_plain(p, idx, nv), bnd,
               ahead=True)
        host_runs_ahead(lambda: rel_stats(p, idx, nv, marked), f"K5 N={n}")
        print(f"phase 6 K5 N={n}: bit-equal on a second call and where it marks the indices "
              "itself; returns while the stream is still busy with earlier work")

        for c_in in (d_out // 8, d_out // 4):           # lfa1, lfa2
            args = (rnd(16, n, c_in), p, idx, nv, rnd(c_in, 10, scale=0.3), rnd(c_in, scale=0.3),
                    1.0 + rnd(c_in, scale=0.2), rnd(c_in, scale=0.2),
                    rnd(2 * c_in, 2 * c_in, scale=(2 * c_in) ** -0.5), rnd(16, n, 2 * c_in))
            got = lfa_train_bwd(*args[:4], inv, *args[4:])
            want = lfa_train_bwd_plain(*(a.double() if a.is_floating_point() else a for a in args))
            errs = [scale_err(a, b.float(), tol, f"K6 C_in={c_in} {what}") for a, b, tol, what in
                    zip(got, want, (TOL["K6"], TOL["K6sum"], TOL["K6sum"]), ("dx", "d_att_w", "sums"))]
            # per valid point and slot: the forward's attention product, its
            # transpose and d(att_w) (3 C^2, C = 2 c_in), plus the encoder,
            # softmax and BN-sum terms (~40 per channel); the products on
            # the CUDA cores (bound_ms) or the TF32 tensor cores
            # (tc_bound_ms, which the kernel is held to)
            c = 2 * c_in
            slots = float(m.sum()) * 16
            n_bytes = nbytes(*args, *got)
            cuda_bnd = bound(slots * (3 * c * c + 40 * c), n_bytes)
            bnd = tc_bound(slots * 3 * c * c, slots * 40 * c, n_bytes)
            record("K6", f"C_in={c_in} N={n} (dx/d_att_w/sums errs "
                   + "/".join(f"{e:.3g}" for e in errs) + " of scales "
                   + "/".join(f"{float(b.abs().max()):.3g}" for b in want) + ")", errs[0],
                   lambda: lfa_train_bwd(*args[:4], inv, *args[4:]),
                   lambda: lfa_train_bwd_plain(*args), bnd, reps_p=1, cuda_bnd=cuda_bnd)
    print(f"phase 6 K4 per B=16 train step (the card's time, host ahead): the 8 gathers' VJP "
          f"{step_ms['gathers']:.4f} ms (unfused route), K6's 8 dx scatters {step_ms['dx']:.4f} ms "
          f"(fused route); the 4 inverse maps {step_ms['map']:.4f} ms, plain "
          f"{step_ms['map_plain']:.4f} ms (either route)")
    return stats


class TileDataModule:
    """Toy-tile subtiles for ``Trainer.fit`` and ``Trainer.test``, read
    straight from the LAS file: the card has no ``h5py`` for the HDF5
    sample cache, so the train and eval transforms of the config run on
    ``TileSampleStream`` samples of the committed tile (the test split is
    the tile again, with its full-cloud copies)."""

    def __init__(self, cfg: dict):
        from myria3d_tpu_torch.train import port_targets
        from myria3d_tpu_torch.utils.config import instantiate

        dm = cfg["datamodule"]        # its own target needs h5py: not redirected
        t = port_targets(dm["transforms"])
        # the layout of HDF5LidarDataModule._stages, which Trainer.test
        # extends with the x-sort
        self._stages = {phase: [instantiate(x) for x in t[key]] for phase, key in (
            ("train", "preparations_train_list"), ("eval", "preparations_eval_list"),
            ("normalize", "normalizations_list"), ("augment", "augmentations_list"))}
        self._dataset = None
        self.dm = dm
        self.batch_size = int(dm["batch_size"])
        self.pre_transform = instantiate(port_targets(dm["points_pre_transform"]))
        self.pre_filter = instantiate(port_targets(dm.get("pre_filter")))

    def prepare_data(self, stage=None):
        pass

    def setup(self, stage=None):
        pass

    def _loader(self, phase, seed=None):
        from myria3d_tpu_torch.pctl.dataset.tile_stream import TileSampleStream
        from myria3d_tpu_torch.pctl.loader import PaddedBatchLoader
        from myria3d_tpu_torch.pctl.transforms.compose import CustomCompose

        stages = self._stages[phase] + self._stages["normalize"]
        if phase == "train":
            stages += self._stages["augment"]
        stream = TileSampleStream(
            os.path.join(ASSETS, "toy_tile.las"), self.dm.get("epsg"),
            self.dm["tile_width"], self.dm["subtile_width"], 0, self.pre_transform,
            pre_filter=self.pre_filter, transform=CustomCompose(stages))
        return PaddedBatchLoader(stream, batch_size=self.batch_size, num_workers=1,
                                 seed=seed, process_index=0, process_count=1)

    def train_dataloader(self, seed=None):
        return self._loader("train", seed)

    def val_dataloader(self):
        return self._loader("eval")

    def test_dataloader(self):
        return self._loader("eval")


def phase_fit(dev, work: str):
    """The port's Trainer.fit on toy-tile subtiles under each auto route,
    then predict() with the checkpoint it wrote. Returns the launches and
    the (config, last checkpoint) of each fit."""
    from myria3d_tpu_torch.models.modules.randla_net import FUSED_TRAIN_MIN_BATCH
    from myria3d_tpu_torch.pctl.io.las import read_las
    from myria3d_tpu_torch.predict import predict
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config
    from myria3d_tpu_torch.train import build_trainer

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    runs = []
    # 16 m subtiles: the 100 m toy tile gives 49 of up to ~1.5k points
    for batch in (4, FUSED_TRAIN_MIN_BATCH):
        run_dir = os.path.join(work, f"b{batch}")
        cfg = compose_config(CONFIG_DIR, "config.yaml", [
            "task.task_name=fit", "dataset_description=toy_synthetic", "logger=csv",
            f"hydra.run.dir={run_dir}", "trainer.overfit_batches=1",
            f"trainer.max_epochs={FIT_STEPS}", f"trainer.min_epochs={FIT_STEPS}",
            f"datamodule.batch_size={batch}", "datamodule.subtile_width=16",
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
        f"predict.output_dir={work}/pred", "datamodule.batch_size=4"])
    out = predict(pcfg)
    res = read_las(out).points
    names = list(pcfg["predict"]["interpolator"]["classification_dict"].values())
    probas = np.stack([np.asarray(res[n], np.float64) for n in names], axis=1)
    need(len(res) == len(read_las(tile).points), "predict output point count")
    need(bool(np.isfinite(probas).all()), "NaN in the predicted probabilities")
    acc = float((np.asarray(res["PredictedClassification"]) == np.asarray(res["Classification"])).mean())
    print(f"phase 7 predict with the fit checkpoint: {len(res)} points, GT accuracy {acc:.4f}")
    return launches, runs


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

    counters = launch_counters()

    def timed(model, batch, reps):
        """ms per step over ``reps`` steps, each reading the parameters the
        last one wrote (the sync comes after the last update), and the peak
        memory; the kernel launches per step land in ``per_step``."""
        def step(i):
            return model.train_step(*batch, torch.Generator(device=dev).manual_seed(i))
        start = {n: fn.launches for n, fn in counters.items()}
        step(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for i in range(reps):
            loss, _ = step(i + 1)
        chk = sum(float(p.detach().sum()) for p in model.net.parameters())
        dt = (time.perf_counter() - t0) * 1e3 / reps
        need(np.isfinite(float(loss)) and np.isfinite(chk), "non-finite train step")
        per_step.clear()
        per_step.update({n: (fn.launches - start[n]) / (reps + 1) for n, fn in counters.items()
                         if fn.launches > start[n]})
        return dt, torch.cuda.max_memory_allocated(dev) / 2**30

    def cos(a, b):
        return float((a.double() @ b.double()) / (a.double().norm() * b.double().norm()))

    rows = []
    per_step: dict = {}
    for b in (4, 8, 10, 16, 32):
        batch = [torch.from_numpy(a).to(dev) for a in train_batch(b)]
        models = {True: make(True), False: make(False)}
        grad = {f: grads(m, batch) for f, m in models.items()}
        ms = {True: [], False: []}
        mem = {}
        launches = {}
        for fused in (True, False, False, True):
            dt, mem[fused] = timed(models[fused], batch, TRAIN_REPS)
            ms[fused].append(dt)
            launches[fused] = dict(per_step)
        # per step: K4's kernel 8 times on either route (the gathers' VJP, or
        # K6's dx scatters), K5 once per block, the inverse map once per block
        want = {True: {"K4": 8, "K5": 4, "K6": 8, "inverse_map": 4},
                False: {"K4": 8, "inverse_map": 4}}
        for fused, counts in want.items():
            got = {name: launches[fused].get(name, 0) for name in ("K4", "K5", "K6", "inverse_map")}
            need(got == {"K4": 0, "K5": 0, "K6": 0, "inverse_map": 0, **counts},
                 f"B={b} fused={fused}: launches per step {got}")
        c = cos(grad[True], grad[False])
        need(c >= 0.999, f"B={b}: fused/unfused gradient cosine {c:.6f}")
        for fused in (True, False):
            t = float(np.mean(ms[fused]))
            row = {"batch": b, "fused": fused, "ms": t, "turns": ms[fused], "peak_gib": mem[fused]}
            line = (f"phase 8 train step B={b} N={TRAIN_N} {'fused' if fused else 'unfused'}: "
                    f"kernels {t:.1f} ms/step (turns {ms[fused][0]:.1f}, {ms[fused][1]:.1f}; "
                    f"{b * TRAIN_N / t / 1e3:.3f} Mpts/s, peak {mem[fused]:.2f} GiB)")
            if b == 16:
                line += f", launches per step {launches[fused]}"
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


def phase_knn_mxu(dev):
    """K7: its path run, then held against its plain version and K1's full
    scan, and timed beside K1."""
    import torch

    from myria3d_tpu_torch.ops.cuda_knn import BINS, knn_topk, knn_topk_mxu, knn_topk_plain
    from myria3d_tpu_torch.ops.knn import centred_clouds, gather_rows
    from myria3d_tpu_torch.ops.sampling import random_decimation

    _, pos, mask, _, _ = (torch.from_numpy(a).to(dev) for a in bench_subtiles(2))
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = [(pos, mask)]
    for _ in range(3):
        p, m = stages[-1]
        idx, m2 = random_decimation(m, 4, gen)
        stages.append((gather_rows(p, idx), m2))
    cases = [(f"K=16 self {stages[i][0].shape[1]}", *centred_clouds(stages[i][0], stages[i][0],
                                                                      stages[i][1]), stages[i][1])
             for i in (2, 3, 0)]

    knn_topk_mxu.launches = 0
    for _, q4, k4, _ in cases:        # the path: the wrapper, variant="mxu"
        knn_topk(q4, k4, 16, variant="mxu")
    torch.cuda.synchronize()
    launches = knn_topk_mxu.launches
    need(launches == len(cases), f"K7 launched {launches} times for {len(cases)} searches")

    eps = float(torch.finfo(torch.float32).eps)
    stats = []
    for label, q4, k4, qm in cases:
        idx7, d7 = knn_topk(q4, k4, 16, variant="mxu")
        idx_p, d_p = knn_topk_plain(q4, k4, 16, variant="mxu")
        need(bool(torch.equal(idx7, idx_p)), f"K7 {label}: indices differ from the plain version")
        err = float((d7 - d_p).abs().max())
        need(bool(((d7 - d_p).abs() <= 1e-6 * d_p.abs().clamp(min=1.0)).all()),
             f"K7 {label}: d2 differs from the plain version by {err:.3g}")
        # against K1's exact difference form: where the k-th and (k+1)-th
        # true distances are further apart than twice the expanded form's
        # rounding, the index sets agree and d2 is within the bound
        idx1, d1 = knn_topk(q4, k4, 17)
        kmax = torch.where(k4[..., 3:] == 0, k4[..., :3], 0.0).square().sum(-1).amax(1)
        tol = 16 * eps * (q4[..., :3].square().sum(-1) + kmax[:, None])
        clear = ((d1[..., 16] - d1[..., 15]) > 2 * tol) & qm
        same = (idx7.sort(-1).values == idx1[..., :16].sort(-1).values).all(-1)
        need(bool(same[clear].all()), f"K7 {label}: {int((~same & clear).sum())} index sets "
             "differ from K1's outside the rounding bound")
        d_err = ((d7 - d1[..., :16]).abs() - tol[..., None])[clear]
        need(bool((d_err <= 0).all()), f"K7 {label}: d2 off K1's by more than the bound")
        ms = cuda_ms(lambda: knn_topk(q4, k4, 16, variant="mxu"), 5)
        k1_ms = cuda_ms(lambda: knn_topk(q4, k4, 16), 5)
        plain_ms = cuda_ms(lambda: knn_topk_plain(q4, k4, 16, variant="mxu"), 1)
        pairs = q4.shape[0] * q4.shape[1] * (-(-k4.shape[1] // BINS) * BINS)
        bnd = bound(PAIR_INSTR * pairs, nbytes(q4, k4, idx7, d7))
        stats.append((err, ms, plain_ms, bnd, None))
        print(f"phase 9 K7 {label} B={q4.shape[0]} (full scan): max_abs_err {err:.3g}, "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound_ms {bnd[0]:.4f} ({bnd[1]}); "
              f"K1 full scan {k1_ms:.3f} ms; vs K1: {int(clear.sum())} of {int(qm.sum())} valid "
              f"queries checked (k-th gap above twice the bound, max {float(tol.max()):.3g})")
    return stats, launches


def phase_test(dev, cfg: dict, ckpt: str):
    """``Trainer.test`` on the toy-tile subtiles with the fit checkpoint,
    through K1-K3, held against the same test on the plain versions."""
    from myria3d_tpu_torch.train import build_trainer

    counters = {k: v for k, v in launch_counters().items() if k in ("K1", "K2", "K3")}
    # every subtile of the tile (the debug experiment tests one batch)
    cfg = {**cfg, "trainer": {**cfg["trainer"], "limit_test_batches": None}}

    def run():
        trainer, model = build_trainer(cfg)
        t0 = time.perf_counter()
        out = trainer.test(model, TileDataModule(cfg), ckpt_path=ckpt)
        return out, time.perf_counter() - t0

    for fn in counters.values():
        fn.launches = 0
    out, dt = run()
    launches = {name: fn.launches for name, fn in counters.items()}
    need(all(v > 0 for v in launches.values()), f"test: kernels not launched: {launches}")
    with plain_versions():
        ref, _ = run()
    loss, iou = out["test/loss_epoch"], out["test/iou"]
    need(np.isfinite(loss) and 0.0 < iou <= 1.0, f"test: loss {loss}, IoU {iou}")
    need(abs(loss - ref["test/loss_epoch"]) <= 1e-3 * abs(ref["test/loss_epoch"]),
         f"test loss {loss:.6f} vs plain {ref['test/loss_epoch']:.6f}")
    need(abs(iou - ref["test/iou"]) <= 0.01, f"test IoU {iou:.4f} vs plain {ref['test/iou']:.4f}")
    per_class = " ".join(f"{k.split('/')[-1]}={v:.3f}" for k, v in out.items()
                         if k.startswith("test/iou/"))
    print(f"phase 10 test (full cloud): {dt:.1f} s, test/loss_epoch {loss:.6f} (plain "
          f"{ref['test/loss_epoch']:.6f}), mean IoU {iou:.4f} (plain {ref['test/iou']:.4f}), "
          f"per class {per_class}, launches {launches}")


def foreign_modules() -> list:
    """Modules of JAX, flax or the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "myria3d_tpu"))


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
        with tempfile.TemporaryDirectory(prefix="m3d_fit_") as work:
            fit_launches, runs = phase_fit(dev, work)
            launches.update({k: v for k, v in fit_launches.items() if k in train_stats})
            phase_train_step(dev)
            with torch.inference_mode():
                stats["K7"], launches["K7"] = phase_knn_mxu(dev)
            phase_test(dev, *runs[-1])
    except Exception:  # noqa: BLE001 - every phase failure ends the run
        traceback.print_exc()
        print("FAIL")
        return 1
    foreign = foreign_modules()
    if foreign:
        print(f"FAIL: modules of JAX or of the JAX package were loaded: {foreign}")
        return 1
    sources = {"K1": ("myria3d_tpu_torch/csrc/knn.cu", "myria3d_tpu/ops/pallas_knn.py:238"),
               "K2": ("myria3d_tpu_torch/csrc/lfa.cu", "myria3d_tpu/ops/pallas_lfa.py:106"),
               "K3": ("myria3d_tpu_torch/csrc/interp.cu", "myria3d_tpu/ops/pallas_knn.py:475"),
               "K4": ("myria3d_tpu_torch/csrc/gather_bwd.cu", "myria3d_tpu/ops/pallas_gather.py:65"),
               "K5": ("myria3d_tpu_torch/csrc/lfa_train.cu",
                      "myria3d_tpu/ops/pallas_lfa_train.py:162"),
               "K6": ("myria3d_tpu_torch/csrc/lfa_train.cu",
                      "myria3d_tpu/ops/pallas_lfa_train.py:192"),
               "K7": ("myria3d_tpu_torch/csrc/knn.cu", "myria3d_tpu/ops/pallas_knn.py:115")}
    kernels = []
    for name, (src, rep) in sources.items():
        rows = stats[name]
        bounds = [s[3] for s in rows]
        libs = [s[4] for s in rows]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": max(s[0] for s in rows),
            "ms": sum(s[1] for s in rows),
            "plain_ms": sum(s[2] for s in rows),
            "bound_ms": sum(b[0] for b in bounds),
            # what bounds the largest share of the summed bound
            "bound_by": max(bounds, key=lambda b: b[0])[1],
            "library_ms": sum(libs) if all(v is not None for v in libs) else None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
