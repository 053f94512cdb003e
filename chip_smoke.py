#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port's predict, train, test and
finetune paths, its two nets in f32 and 16-bit compute, and its parity
harness (one NVIDIA GPU).

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 22     # phases 1, 2 and 22 alone
    python3 chip_smoke.py --phase 23     # phases 1, 2 and 23 alone
    python3 chip_smoke.py --phase 24     # phases 1, 2 and 24 alone

Run from the repository root on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, one line each:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the kernels built from ``myria3d_tpu_torch/csrc`` (nvcc, sm_90a), and
   each kernel's registers, stack frame and spill bytes (``cuobjdump
   --dump-resource-usage`` of the library, ``ptxas -v``); every K1/K3/K7
   instantiation (K1: K = 1, 4, 16, the generic 32 and the ball route's 32;
   K7: K = 1, 16 and the generic 32), every width's K2
   (f32, and K2_16's bfloat16 and float16 x) and K6 instantiation, every
   K4 instantiation, K5 and every K8 instantiation
   (1, 2, 3, 4, 6, 8, 12 and 14 points a thread in registers) must have
   neither a stack frame, local memory nor spills; K2's and K6's dynamic
   shared memory and blocks per SM at each width; K8's routes at phase
   16a's shapes (threads, points a thread, cluster size, skip) with the
   clusters the card holds at once (``cudaOccupancyMaxActiveClusters``),
   which must be at least the case's batch; K9's five instantiations, with
   no stack frame, local memory or spills but C = 32's stated 64 bytes
   (``K9_SPILL``);
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
9. K7 (``knn_topk(variant="mxu")``, the expanded-score full scan on K1's
   search): its path run at the full-scan shapes of the predict step (self
   768 and self 192, B=48) and at a full-scan self 12288 (B=48); indices
   and d2 bit-equal to its plain version (which scans every padded
   position); against K1's full scan on the
   same clouds, equal index sets wherever the gap between the k-th and
   (k+1)-th distances exceeds twice the expanded form's rounding bound
   (16 eps (|q|^2 + max |k|^2)) and d2 within that bound there; K7 and K1's
   full scan timed side by side (the card's time, the host running ahead;
   K7 also as enqueued), K7's bound on the positions it scans
   (``mxu_scan_len``: the keys and k virtual pad rows) at 5 instructions a
   pair, its filter (the exact score of the few pairs that pass is not
   counted);
10. the full-cloud test path: ``Trainer.test`` on the toy-tile subtiles
   (with their full-cloud copies) and phase 7's B=16 checkpoint; K1, K2 and
   K3 launched, ``test/loss_epoch`` and the mean IoU printed, and held
   against the same test on the plain versions (loss within 1e-3 relative,
   IoU within 0.01);
11. finetuning: ``Trainer.fit(..., finetune=True)`` from phase 7's B=16
   checkpoint with the ``finetuning`` callbacks (``overfit_batches: 1``, 4
   epochs, B=16): after each epoch its seconds and the largest |change| of
   each group's parameters from the checkpoint (the last FC, the rest of
   the FC head, the decoder, the encoder); the last FC moves from epoch 0,
   the FC head from epoch 1, the decoder from epoch 3, the encoder never
   (bit-equal); finite losses, K1, K4, K5 and K6 launched;
12. the LR range test (``train.lr_range_test`` at its defaults: 100 steps
   from 1e-4 to 3.0) on phase 7's B=16 toy subtiles: the suggestion, the
   steps taken before its stop and the seconds; a suggestion in the range,
   the net's state dict bit-equal after the sweep, K1, K4, K5, K6 launched;
13. ``model.grad_microbatch`` at ``bench.py --train``'s shape: B=32 at
   mb=16 (fused chunks) and B=16 at mb=8 (unfused chunks); one microbatched
   grad step against a manual accumulation of the same chunks on the same
   generators (loss within 1e-5 relative, every gradient within 1e-5 of
   the largest, BN running stats within 1e-6 relative of the chunks'
   mean), its launches (twice a chunk's), then ms/step, peak memory and
   device kernels and copies a step (a ``torch.profiler`` trace) of the
   microbatched train step beside the monolithic one at the same B;
14. the profiler: a 3-step fit with ``trainer.profiler=torch``; the Chrome
   trace under ``$LOGS_DIR/profile`` must name K1's and K4's kernels and
   hold the three "train_step" regions; its size and the hand kernels it
   names are printed;
15. data parallel (``myria3d_tpu_torch/parallel``), at full width with
   deterministic decimation and no dropout: (a) two gloo ranks sharing the
   card (``parallel.spawn`` over ``["cuda:0", "cuda:0"]``), B=32 split
   16/16 on the fused route, one DDP grad step with sync BN against the
   one-process B=32 step and with local BN against the mean of two
   one-process B=16 steps on the halves (loss within 1e-5 relative, each
   gradient's cosine >= 0.999 where it is not analytically zero, BN stats
   within 1e-5 of scale, both ranks' gradients equal), then each rank's
   ms per train step and the bytes it all-reduces a step; (b) one NCCL
   rank with the whole batch, sync BN, against the one-process step; (c)
   ``Trainer.fit`` over two ranks on the toy-tile subtiles (16 a rank,
   early stopping after the second epoch), rank 0 writing each checkpoint
   once and rank 1 none, both ranks taking the same steps and losses,
   then ``Trainer.test`` of the last checkpoint over the ranks, its IoU
   within 0.01 of a one-process test; (d) ``predict()`` with its rows
   split over two replicas on the card (batch 5, padded to 6) against the
   one-device predict: argmax agreement >= 0.999 and the largest logit
   difference against the logits' scale. The ranks run in processes of
   their own, joined with a timeout; each reads its launch counts around
   its own path (K1, K2, K4, K5 and K6 must launch there; K1-K3 in (d)).

16. PointNet++ (``models/modules/pointnet2.py``, full width: 64/128/256/512,
   32 neighbours, radii 0.05-0.4, decimation 4, 9 features, 7 classes,
   random weights from a seed): (a) K8 (farthest-point sampling) bit-equal
   to its plain version at the set abstractions' shapes (N -> m = 12288 ->
   3072 -> 768 -> 192 -> 48) at B=16 and 48, and at 40960 -> 10240,
   clouds with an all-pad cloud and one with fewer valid points than m;
   the x-sorted bench subtiles (B=48, 12288 -> 3072, as predict's sa1 takes them)
   and a mask that is no prefix; each case's route from the wrapper's rule
   (``cuda_fps.route``), the card's time with the host ahead and the us a
   round, the plain version's time, the bound and the rounds; (b) K1 at the PointNet++ searches
   (full scans, B=48 and 16): the four K=32 ball queries on K1's ball route
   (lists from r^2, centroids walked in x order where they fill more than
   one tile) and the four k=3 feature propagation searches on the 4-slot
   list (row order), each bit-equal to its plain version and timed with the
   host ahead beside the generic 32-slot list at the same shape (the route
   before the ball route), which is held bit-equal to its plain version
   there too; (c) ``Model.interp_step`` at
   the bench shape (B=48, N=12288, M=32768; x-sorted subtiles in
   normalized units, window 4608) against the plain path (argmax agreement
   >= 0.999), ms per batch, Mpts/s, host enqueue, launches per step (K1 8:
   4 on the ball route, 4 on the 4-slot list; K3 1, K8 4), turns against
   the generic searches (new, generic, generic, new; the outputs equal) and
   a profile; (d) the train step at B=16, N=12288: the
   gradient's cosine against the plain path (>= 0.999), ms per step, peak
   memory, launches per step (K1 8 as in (c), K4 8, K8 4), the same turns
   and a profile (both
   profiles give K8's device ms per step wherever it ranks); then ``Trainer.fit`` with
   ``model=pointnet2_model`` on the toy-tile subtiles (20 steps; the loss
   must fall) and ``predict()`` with its checkpoint on the card and on the
   CPU: GT accuracy within 0.02 and class maps agreeing >= 0.999;
15b. PointNet++ (full width) on two gloo ranks sharing the card, B=16
   split 8/8: one DDP grad step with sync BN against the one-process step
   and with local BN against the mean of the halves' steps, phase 15 (a)'s
   bars, then each rank's ms per train step;
17. the parity harness (``parity.run_parity``) on the toy tile with a
   synthetic Lightning checkpoint on the card and on the CPU: class-map
   agreement >= 0.999 and mIoU within 0.01 (RandLA-Net's decimation made
   deterministic in both runs), K1 and K2 launched on the card;
18. the compute dtype: (a) K2_16, K2 reading bfloat16 and float16
   features, against its plain version on the same values widened to f32
   (within 1e-4 of scale) at the predict stage shapes, timed beside K2's
   f32 instantiation on those values, its bound with 2-byte x rows; (b)
   the RandLA-Net predict step (toy checkpoint) and (c) the PointNet++ one
   at the bench shape in f32 and bf16 (turns f32, bf16, bf16, f32): ms per
   batch, Mpts/s, argmax agreement bf16/f32 >= 0.99; (d) the train step of
   both families at B=16, N=12288 in f32 and bf16 from the same weights:
   ms per step, peak memory, the losses, the gradient cosine bf16/f32 (>=
   0.99 for RandLA-Net; for PointNet++ at least the JAX package's own bf16
   step's at B=4, ``scripts/bf16_gradient_reference.py``; ``DTYPE_COS``)
   and the launches (bf16 RandLA-Net takes the
   unfused route: no K5, no K6); (e) ``predict()`` on the toy tile with
   ``predict.compute_dtype=bfloat16``, K2_16's main path: K1, K2_16 and K3
   launched, K2's f32 instantiation not, GT accuracy within 0.02 of the CPU
   plain path's;
19. ``return_logits: false`` through ``predict()`` on the toy tile against
   the logits run: probabilities within 1e-3, the class map equal but at
   near-ties (top two within 2e-3), on at least 0.999 of the points; the
   RandLA-Net train step at B=16 with ``remat: true`` against ``false``:
   gradients within 1e-6 of the net's largest, BN running stats equal, ms
   per step and peak memory of both;
20. the exact_knn RandLA-Net (full width, ``knn_window: 4608`` and
   ``exact_knn: true`` in its hparams, random weights from seed 0): (a) K1
   at its searches at B=48 (the encoder graphs K=16 self 12288, 3072, 768,
   192 and the decoder's k=1, every one a full scan), bit-equal to the
   plain version and timed beside it; then the predict step at the bench
   shape (sorted window 4608): its net's logits bit-equal to the same
   weights' with ``knn_window: 0``, the full-cloud argmax of its K3 step
   (windowed) against its exact two-op step (>= 0.999), K1's launches per
   step by instantiation (``cuda_knn.scans``: full scans only, K=16 and
   k=1), K2 and K3 launched, ms per batch and host enqueue in turns (exact,
   windowed, windowed, exact) beside the windowed net's; (b) the train step
   at B=16, N=12288 (x-sorted) on the unfused route, as the JAX package
   routes exact_knn: K4 and no K5/K6, K1 full scans only, the gradient's
   cosine against the same weights with ``knn_window: 0`` (>= 0.999999)
   and its largest gap, ms per step and peak memory beside the windowed
   net's fused step; (c) ``predict()`` on the toy tile with a checkpoint
   whose hparams carry ``exact_knn: true`` and with ``predict.exact_knn=
   true`` on the toy checkpoint: K1 full scans only, K2 and K3 launched,
   GT accuracy within 0.02 of the CPU plain path's; (d) a two-step
   ``Trainer.fit`` with ``logger=comet`` and no credentials (a stand-in
   ``comet_ml`` module records any call): it fits and no Comet call is
   made;
21. the CLI: ``python -m myria3d_tpu_torch.run`` (run as ``-m`` runs it,
   through ``runpy``) predicts the toy tile in a subprocess on the card
   from a temporary cwd whose ``.env`` sets ``LOGS_DIR`` (removed from the
   subprocess's environment), with ``--config-path=`` and
   ``--config-name=``, ``experiment=predict`` and ``predict.output_dir=out``:
   it exits 0 with no FAIL line, the LAS lands in
   ``<LOGS_DIR>/runs/<date>/<time>/out/``, its GT accuracy is within 0.005
   of phase 4's, and the subprocess's own counts show K1, K2 and K3
   launched; the wall time is printed beside the card's name and power
   limit;
22. a whole 1 km² tile through the CLI: (a) ``python -m
   myria3d_tpu_torch.run`` (``experiment=predict``, batch 48,
   ``datamodule.epsg=2154 datamodule.tile_width=1000``, the toy
   checkpoint) predicts ``bench_e2e.py``'s synthetic tile (17.18 M points
   over 1000 m, production GridSampling statistics, the port's
   ``write_production_tile``, cached under ``build/myria3d_tpu_torch/tiles``):
   the wall clock, Mpts/s, predict()'s logged line, its ``phases`` dict
   (the ``finalize_*`` phases among them), K1/K2/K3 launched, the peak
   device memory and the host's cores; the output LAS as phase 4 checks it,
   and the covered points' classes within the class dict; (b) the tile's
   batches rebuilt as predict() makes them (``predict.tile_loader``): the
   (B, N_pad, M_pad) histogram, whose count must be (a)'s, and
   ``Model.interp_step`` on the first batch at each distinct (N_pad,
   M_pad) (at most three) on the kernels and on their plain versions from
   one generator seed: argmax agreement >= 0.999 over the valid full
   points, the ms of both; (c) a dense crop (800 000 points over 100 m)
   whose subtiles MaximumNumNodes caps: its batch must pad to N=40064 and
   to a full bucket past 131072 (the overflow quantum), held as in (b) and
   predicted through the CLI with (a)'s checks; (d) the crop predicted
   again with ``predict.subtile_overlap=25``, (a)'s checks, its wall clock
   beside the overlap-0 run's;
23. K9, Point Transformer's vector attention at eval (the published net,
   ``perfbench/configs/point_transformer.json``, random weights): (a) at
   the predict step's five stages (B=48, N = 16384 -> 64, each cloud's
   first 85-100 % of the slots real, the stage's K1 self graph, BatchNorm
   statistics away from the identity) K9 bit-equal to its plain version
   (``vector_attention_plain``) with pad queries 0, each timed beside the
   plain version, with the byte bound of the attention reader; (b) the
   net's eval forward at B=48, N=16384: 18 K9 launches a step, ms a step
   beside K9's plain version in its place, and the logits bit-equal;
24. Point Transformer V3 (``model=point_transformer_v3_model``, default
   initialisation seeded with the predict config's seed) predicts phase
   22's 17.18 M-point tile through the CLI, with (a)'s checks and its
   prints, and the net's ``pt3_*`` counters among the phases.

Phases 11-22 each set the launch counts to 0 before their path and read
them after it (phases 21-22 in their subprocesses, whose counts start at
0; phase 21's stay out of the kernels line, phase 22's predicts' are added
to K1's, K2's and K3's entries); the kernels line's K8 launches are phase
16's predict and train steps', K2_16's phase 18e's; phase 20's K2, K3 and K4 launches are
added to those entries, and its K1 launches (every one a full scan) are
the ``K1_full`` entry's, with phase 20a's times. Every number of phases
15b and 18-22 is printed beside the card's name and power limit.

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
K1's PointNet++ routes have entries of their own, ``K1_ball`` (the ball
route) and ``K1_small`` (the 4-slot list): phase 16b's B=48 times, and the
launches of phase 16's predict and train steps; ``K1``'s entry is as
before.
K2_16 has its own entry in the kernels line (phase 18a's times at bf16,
the bound with 2-byte x rows); K2's stays its f32 instantiation.
K9's entry sums phase 23a's stages, each counted once a layer (blocks
2/3/4/6/3), so that its ms and its ``bound_ms`` (bytes only: q, k, v, y,
the int32 index and the positions once at real points) are one step's 18
layers; its launches are phase 23b's.
Any failure, a missing CUDA device, or a module of JAX or of the JAX
package loaded during the run exits nonzero without a result.
"""

from __future__ import annotations

import contextlib
import glob
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
MXU_PAIR_INSTR = 5                           # K7's filter a pair: a product, 3 FMAs, compare


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
    from myria3d_tpu_torch.models.modules import point_transformer, pointnet2, randla_net
    from myria3d_tpu_torch.ops import (
        cuda_fps,
        cuda_gather,
        cuda_interp,
        cuda_knn,
        cuda_lfa,
        cuda_lfa_train,
        cuda_vector_attention,
        fps,
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

    def vector_attention_plain(*args, packed=None):
        return cuda_vector_attention.vector_attention_plain(*args[:7])

    patches = [(knn, "knn_topk", cuda_knn.knn_topk_plain),
               (nn1, "knn_topk", cuda_knn.knn_topk_plain),
               (interpolate, "knn_interp", cuda_interp.knn_interp_plain),
               (randla_net, "lfa_attention", lfa_attention_plain),
               (randla_net, "gather_neighbors", gather_neighbors_plain),
               (randla_net, "inverse_map", cuda_gather.inverse_map_plain),
               (randla_net, "rel_stats", rel_stats_plain),
               (fps, "fps", cuda_fps.farthest_point_sampling_plain),
               (pointnet2, "gather_neighbors", gather_neighbors_plain),
               (pointnet2, "inverse_map", cuda_gather.inverse_map_plain),
               (cuda_lfa_train, "inverse_map", cuda_gather.inverse_map_plain),
               (cuda_lfa_train, "lfa_attention", lfa_attention_plain),
               (cuda_lfa_train, "rel_stats", rel_stats_plain),
               (cuda_lfa_train, "lfa_train_bwd", lfa_train_bwd_plain),
               (point_transformer, "vector_attention", vector_attention_plain)]
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
# many instantiations each family has: K1/K3/K7 (topk.cuh's search), K2 (one
# per width and x's element type: f32, and bfloat16 / float16 for K2_16) and
# K6 (lfa_tile.cuh's edge tile, one per width), K4 (float4 and scalar rows),
# K5 and K8 (points a thread: cuda_fps.PTS)
CLEAN_KERNELS = {"knn_topk_kernel<": 4, "knn_ball_kernel<": 1, "knn_interp_kernel<": 2,
                 "knn_topk_mxu_kernel<": 3,
                 "lfa_kernel<": 18, "lfa_bwd_kernel<": 6, "gather_bwd_kernel<": 2,
                 "relstats_kernel<": 2, "fps_kernel<": 8}


# K9's five instantiations (C, K, N = C / s, P) and the bytes of stack frame,
# local memory and spills each may have: none, but at C = 32, whose four
# blocks an SM leave 64 registers a thread (a 32-byte stack frame, 64 bytes
# of spill stores and 32 of loads on the H100, CUDA 12.8)
K9_SPILL = {"vector_attention_kernel<32,8,4,32>": 64, "vector_attention_kernel<64,16,8,8>": 0,
            "vector_attention_kernel<128,16,16,4>": 0, "vector_attention_kernel<256,16,32,2>": 0,
            "vector_attention_kernel<512,16,64,1>": 0}


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
    need(not bad, f"K1-K8 instantiations with a stack frame, local memory or spills: {bad}")
    k9 = sorted(n for n in usage if n.startswith("vector_attention_kernel<"))
    need(k9 == sorted(K9_SPILL), f"expected K9's instantiations {sorted(K9_SPILL)}, found {k9}")
    bad = [n for n in k9 if any(usage[n].get(key) > K9_SPILL[n]
                                for key in ("stack", "local", "spill_stores", "spill_loads"))]
    need(not bad, f"K9 instantiations past their stated spill ({K9_SPILL}): {bad}")
    from myria3d_tpu_torch.ops.cuda_lfa import WIDTHS, launch_info
    from myria3d_tpu_torch.ops.cuda_lfa_train import bwd_launch_info

    for name, info_of in (("K2", launch_info), ("K6", bwd_launch_info)):
        for c in WIDTHS:
            info = info_of(c)
            print(f"phase 2 {name} C={c}: {info['points_per_tile']} points a tile, "
                  f"{info['bands']} d(att_w) band(s), dynamic shared memory "
                  f"{info['smem_bytes']} B, {info['blocks_per_sm']} block(s) per SM")
    for c in WIDTHS:
        # lfa_kernel<C, P, NT, DEPTH, XT>: XT 0 f32 (K2), 1 bfloat16, 2 float16
        regs = {name: u.get("reg") for name, u in usage.items()
                if name.startswith(f"lfa_kernel<{c},")}
        print(f"phase 2 K2 and K2_16 C={c}: registers {regs}")
    import torch

    from myria3d_tpu_torch.ops import cuda_fps

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, n, _, label in fps_cases():
        rt = cuda_fps.route(b, n, sms)
        u = usage[f"fps_kernel<{rt.pt}>"]
        fits = cuda_fps.max_active_clusters(rt)
        print(f"phase 2 K8 B={b} n={n} {label}: fps_kernel<{rt.pt}> ({u.get('reg')} registers), "
              f"{rt.threads} threads, cluster of {rt.cluster}, skip {int(rt.skip)}; "
              f"{fits} clusters at once for {b}")
        need(fits >= b, f"K8 B={b} n={n}: {fits} clusters of the route {tuple(rt)} fit at once, "
             f"fewer than the batch's {b}")


def check_k1(idx_k, d2_k, idx_p, d2_p, what: str) -> float:
    """The kernel's indices and d2 bit-equal to the plain version's."""
    import torch

    need(bool(torch.equal(d2_k, d2_p)), f"K1 {what}: d2 differs from the plain version")
    need(bool(torch.equal(idx_k, idx_p)), f"K1 {what}: indices differ from the plain version "
         f"at {int((idx_k != idx_p).sum())} slots")
    # equal slots count 0 (the ball route's unfilled slots are +inf on both)
    return float(torch.where(d2_k == d2_p, 0.0, (d2_k - d2_p).abs()).max())


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
    from myria3d_tpu_torch.ops.cuda_fps import fps
    from myria3d_tpu_torch.ops.cuda_gather import gather_bwd, inverse_map
    from myria3d_tpu_torch.ops.cuda_interp import knn_interp
    from myria3d_tpu_torch.ops.cuda_knn import ball_route, knn_topk, knn_topk_mxu, small_list
    from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention, lfa_attention_x16
    from myria3d_tpu_torch.ops.cuda_lfa_train import lfa_train_bwd, rel_stats
    from myria3d_tpu_torch.ops.cuda_vector_attention import vector_attention

    # K4 counts its kernel's every launch: the gathers' VJP and K6's dx
    # scatter; inverse_map is K4's map, built by the kernels beside it; K2
    # counts its f32 instantiations, K2_16 its bfloat16 and float16 ones;
    # K1 every launch of K1, K1_ball its ball route's and K1_small its 4-slot
    # list's
    return {"K1": knn_topk, "K1_ball": ball_route, "K1_small": small_list, "K2": lfa_attention,
            "K2_16": lfa_attention_x16, "K3": knn_interp,
            "K4": gather_bwd, "K5": rel_stats, "K6": lfa_train_bwd, "K7": knn_topk_mxu, "K8": fps,
            "K9": vector_attention, "inverse_map": inverse_map}


def check_predicted_las(res, n_points: int, cfg: dict) -> float:
    """The output LAS of a predict: the input's point count, every
    dimension present and finite, probabilities that sum to 1 within 1e-3
    or are null (uncovered points: dropped artefacts), more than 0.9 of the
    points covered, and the covered points' classes within the class
    dict. Returns the covered share."""
    need(len(res) == n_points, f"output has {len(res)} points, input {n_points}")
    classes = cfg["predict"]["interpolator"]["classification_dict"]
    names = list(classes.values())
    dims = set(res.dtype.names)
    need({"PredictedClassification", "entropy", *names} <= dims, f"missing dims in {sorted(dims)}")
    for name in res.dtype.names:
        col = np.asarray(res[name])
        need(col.dtype.kind != "f" or bool(np.isfinite(col).all()),
             f"NaN or inf in the output's {name}")
    sums = np.zeros(len(res), np.float64)
    for name in names:
        sums += np.asarray(res[name], np.float64)
    covered = np.abs(sums - 1.0) <= 1e-3
    need(bool((covered | (sums == 0.0)).all()), "probabilities neither sum to 1 nor are null")
    need(covered.mean() > 0.9, f"only {covered.mean():.3f} of the points are predicted")
    codes = np.unique(np.asarray(res["PredictedClassification"])[covered])
    need(set(codes.tolist()) <= {int(c) for c in classes},
         f"predicted classes {codes.tolist()} outside the class dict {sorted(classes)}")
    return float(covered.mean())


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

    covered = check_predicted_las(res, len(read_las(tile).points), cfg)
    acc = float((np.asarray(res["PredictedClassification"]) == np.asarray(res["Classification"])).mean())
    need(abs(acc - CPU_PLAIN_ACCURACY) <= ACCURACY_MARGIN,
         f"GT accuracy {acc:.4f} vs CPU plain {CPU_PLAIN_ACCURACY:.4f}")
    print(f"phase 4 main path: predict() {dt:.2f} s, {len(res)} points, covered {covered:.4f}, "
          f"GT accuracy {acc:.4f} (CPU plain {CPU_PLAIN_ACCURACY:.4f}), launches {launches}")
    return launches, acc


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
    need(not {"K1_ball", "K1_small"} & set(per_step),
         f"RandLA-Net's predict step ran a PointNet++ route of K1: {per_step}")
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


def device_profile(step, reps: int = 3):
    """A ``torch.profiler`` trace of ``reps`` steps after one untraced
    step: the device's busy ms per step, the window between its first and
    last activity (ms per step), and by kernel name the device ms per step
    and the launches traced (a trace at times misses a launch: the count
    shows it). Raises if the trace holds no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    events = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA)
    if not events:
        raise RuntimeError("no device activity in the trace")
    by_name, count = {}, {}
    for t0, t1, name in events:
        name = name.split("(")[0].replace("void ", "").replace("m3d::", "")
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3 / reps
        count[name] = count.get(name, 0) + 1
    busy, end = 0.0, events[0][0]
    for t0, t1, _ in events:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy / 1e3 / reps, (end - events[0][0]) / 1e3 / reps, by_name, count


def profile_steps(step, reps: int = 3, keep: tuple = ()) -> str:
    """``device_profile`` as text: the device's idle share, the ten kernels
    that take most of a step, and every kernel whose name starts with one
    of ``keep`` (summed under that prefix, with the launches traced)
    wherever it ranks; "not measured" with the reason if there is no trace
    (the profile reports, it does not decide the run)."""
    try:
        busy, window, by_name, count = device_profile(step, reps)
    except Exception as e:  # noqa: BLE001 - a profiler fault leaves the numbers unmeasured
        return f"not measured ({type(e).__name__}: {e})"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    rest = sum(v for _, v in top[10:])
    kept = [f"{k}* {sum(v for n, v in by_name.items() if n.startswith(k)):.3f} ("
            f"{sum(v for n, v in count.items() if n.startswith(k))} launches traced)"
            for k in keep]
    return (f"{reps} steps, device busy {busy:.2f} ms/step of a {window:.2f} ms/step window, "
            f"idle {100 * (1 - busy / window):.2f} %; ms/step by kernel: "
            + ", ".join(f"{n} {v:.3f}" for n, v in top[:10]) + f", other {rest:.3f}"
            + "".join(f"; {k}" for k in kept))


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
        # the fused route's variance (raw moments, f32 covariance) against
        # the float64 two-pass variance of the same encoder outputs
        e64 = locse(p.double(), gather_rows(p, idx).double()) @ w_e.double().T + b_e.double()
        var64 = masked_var(e64, nv[..., None], dim=(0, 1, 2))
        gap = (var.double() - var64).abs()
        print(f"phase 6 K5 N={n} fused-route BN variance vs float64 two-pass: max abs gap "
              f"{float(gap.max()):.3g} of {float(var64.abs().max()):.3g}, largest relative gap "
              f"{float((gap / var64.clamp(min=1e-30)).max()):.3g} (f32 two-pass: "
              f"{float((two_pass.double() - var64).abs().max()):.3g})")
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
    the tile again, with its full-cloud copies). ``shard``: the samples are
    listed first, so the loader shards them over the ranks of a process
    group."""

    def __init__(self, cfg: dict, shard: bool = False):
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
        self.shard = shard
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
        if self.shard:
            return PaddedBatchLoader(list(stream), batch_size=self.batch_size, num_workers=1,
                                     seed=seed)
        return PaddedBatchLoader(stream, batch_size=self.batch_size, num_workers=1,
                                 seed=seed, process_index=0, process_count=1)

    def train_dataloader(self, seed=None):
        return self._loader("train", seed)

    def val_dataloader(self):
        return self._loader("eval")

    def test_dataloader(self):
        return self._loader("eval")


# phase 11's groups of the net, by top-level module (the finetuning
# callback's: the last FC, the rest of the FC head, the decoder)
FT_GROUPS = {"fc_classif": ("fc_classif",), "FC head": ("mlp_classif",),
             "decoder": ("fp1", "fp2", "fp3", "fp4", "mlp_summit"),
             "encoder": ("fc0", "block1", "block2", "block3", "block4")}
FT_UNFROZEN_FROM = {"fc_classif": 0, "FC head": 1, "decoder": 3}   # configs/callbacks/finetuning.yaml
FT_EPOCHS = 4
MICROBATCH_CASES = ((32, 16, "fused"), (16, 8, "unfused"))          # (B, grad_microbatch, chunk route)
HAND_KERNELS = ("knn_topk_kernel", "knn_topk_mxu_kernel", "knn_interp_kernel", "lfa_kernel",
                "gather_bwd_kernel", "inverse_count_kernel", "inverse_fill_kernel",
                "inverse_order_kernel", "relstats_kernel", "reduce_chunks_kernel",
                "lfa_bwd_kernel")


def fit_config(run_dir: str, batch: int, *overrides: str) -> dict:
    """The toy-tile train config at ``batch``, writing under ``run_dir``
    (16 m subtiles: the 100 m toy tile gives 49 of up to ~1.5k points)."""
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config

    return compose_config(CONFIG_DIR, "config.yaml", [
        "dataset_description=toy_synthetic", "logger=csv", f"hydra.run.dir={run_dir}",
        f"datamodule.batch_size={batch}", "datamodule.subtile_width=16",
        f"callbacks.model_checkpoint.dirpath={run_dir}/checkpoints", *overrides])


def reset_launches() -> dict:
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def phase_fit(dev, work: str):
    """The port's Trainer.fit on toy-tile subtiles under each auto route,
    then predict() with the checkpoint it wrote. Returns the launches and
    the (config, last checkpoint) of each fit."""
    from myria3d_tpu_torch.models.modules.randla_net import FUSED_TRAIN_MIN_BATCH
    from myria3d_tpu_torch.pctl.io.las import read_las
    from myria3d_tpu_torch.predict import predict
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config
    from myria3d_tpu_torch.train import build_trainer

    counters = reset_launches()
    runs = []
    for batch in (4, FUSED_TRAIN_MIN_BATCH):
        cfg = fit_config(os.path.join(work, f"b{batch}"), batch, "task.task_name=fit",
                         "trainer.overfit_batches=1", f"trainer.max_epochs={FIT_STEPS}",
                         f"trainer.min_epochs={FIT_STEPS}")
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
            got = {name: launches[fused].get(name, 0)
                   for name in ("K4", "K5", "K6", "inverse_map", "K1_ball", "K1_small")}
            need(got == {"K4": 0, "K5": 0, "K6": 0, "inverse_map": 0, "K1_ball": 0,
                         "K1_small": 0, **counts},
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


def knn_mxu_stages(dev):
    """Phase 9's clouds: [(pos, mask)] of B=48 bench subtiles (seed 2) at
    12288 points and three random decimations by 4 (3072, 768, 192)."""
    import torch

    from myria3d_tpu_torch.ops.knn import gather_rows
    from myria3d_tpu_torch.ops.sampling import random_decimation

    _, pos, mask, _, _ = (torch.from_numpy(a).to(dev) for a in bench_subtiles(2))
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = [(pos, mask)]
    for _ in range(3):
        p, m = stages[-1]
        idx, m2 = random_decimation(m, 4, gen)
        stages.append((gather_rows(p, idx), m2))
    return stages


def phase_knn_mxu(dev):
    """K7: its path run, then held against its plain version and K1's full
    scan, and timed beside K1."""
    import torch

    from myria3d_tpu_torch.ops.cuda_knn import knn_topk, knn_topk_mxu, knn_topk_plain, mxu_scan_len
    from myria3d_tpu_torch.ops.knn import centred_clouds

    stages = knn_mxu_stages(dev)
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
        need(bool(torch.equal(d7, d_p)),
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
        ms = cuda_ms(lambda: knn_topk(q4, k4, 16, variant="mxu"), 5, ahead=True)
        enqueued_ms = cuda_ms(lambda: knn_topk(q4, k4, 16, variant="mxu"), 5)
        k1_ms = cuda_ms(lambda: knn_topk(q4, k4, 16), 5, ahead=True)
        plain_ms = cuda_ms(lambda: knn_topk_plain(q4, k4, 16, variant="mxu"), 1)
        pairs = q4.shape[0] * q4.shape[1] * mxu_scan_len(k4.shape[1], 16)
        bnd = bound(MXU_PAIR_INSTR * pairs, nbytes(q4, k4, idx7, d7))
        stats.append((err, ms, plain_ms, bnd, None))
        print(f"phase 9 K7 {label} B={q4.shape[0]} (full scan): max_abs_err {err:.3g}, "
              f"{ms:.4f} ms ({enqueued_ms:.4f} ms as enqueued), plain {plain_ms:.3f} ms, "
              f"bound_ms {bnd[0]:.4f} ({bnd[1]}); "
              f"K1 full scan {k1_ms:.4f} ms; vs K1: {int(clear.sum())} of {int(qm.sum())} valid "
              f"queries checked (k-th gap above twice the bound, max {float(tol.max()):.3g})")
    return stats, launches


def phase_test(dev, cfg: dict, ckpt: str, kernels=("K1", "K2", "K3"), label: str = "phase 10"):
    """``Trainer.test`` on the toy-tile subtiles with the fit checkpoint,
    through ``kernels``, held against the same test on the plain versions."""
    from myria3d_tpu_torch.train import build_trainer

    counters = {k: v for k, v in launch_counters().items() if k in kernels}
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
    print(f"{label} test (full cloud): {dt:.1f} s, test/loss_epoch {loss:.6f} (plain "
          f"{ref['test/loss_epoch']:.6f}), mean IoU {iou:.4f} (plain {ref['test/iou']:.4f}), "
          f"per class {per_class}, launches {launches}")


def phase_finetune(dev, work: str, ckpt: str, groups=None, unfrozen_from=None,
                   kernels=("K1", "K4", "K5", "K6"), label: str = "phase 11", *overrides: str):
    """``task.task_name=finetune`` from phase 7's B=16 checkpoint (or
    another net's, with ``overrides``) with the ``finetuning`` callbacks,
    across both unfreeze epochs: after each epoch the largest |change| of
    each group's parameters from the checkpoint; a group moves exactly from
    its unfreeze epoch, the encoder never."""
    import torch

    from myria3d_tpu_torch.models.modules.randla_net import FUSED_TRAIN_MIN_BATCH
    from myria3d_tpu_torch.train import build_trainer
    from myria3d_tpu_torch.utils.checkpoint import load_state_dict

    groups, unfrozen_from = groups or FT_GROUPS, unfrozen_from or FT_UNFROZEN_FROM
    batch = FUSED_TRAIN_MIN_BATCH
    cfg = fit_config(os.path.join(work, f"finetune_{label.replace(' ', '_')}"), batch,
                     "task.task_name=finetune", "callbacks=finetuning",
                     "trainer.overfit_batches=1", f"trainer.max_epochs={FT_EPOCHS}",
                     f"trainer.min_epochs={FT_EPOCHS}", *overrides)
    trainer, model = build_trainer(cfg)
    need(trainer.finetune_cb is not None, "the finetuning callback was not built")
    start = load_state_dict(ckpt, dev)
    names = [k for k, _ in model.net.named_parameters()]
    epochs = []

    class EpochProbe:
        """The trainer's logger: reads the parameters at each epoch's end."""

        def log_metrics(self, metrics, step=None):
            if "epoch" not in metrics:
                return
            now = model.net.state_dict()
            delta = {g: max(float((now[k] - start[k]).abs().max()) for k in names
                            if k.split(".")[0] in tops) for g, tops in groups.items()}
            epochs.append((int(metrics["epoch"]), time.perf_counter(), delta))

    trainer.logger = EpochProbe()
    counters = reset_launches()
    t0 = time.perf_counter()
    trainer.fit(model, TileDataModule(cfg), ckpt_path=ckpt, finetune=True)
    torch.cuda.synchronize()
    used = {n: fn.launches for n, fn in counters.items()}
    losses = trainer.train_losses
    need(len(epochs) == FT_EPOCHS and len(losses) == FT_EPOCHS and all(np.isfinite(losses)),
         f"finetune: {len(epochs)} epochs, losses {losses}")
    need(all(used[k] > 0 for k in kernels), f"finetune: launches {used}")
    last = t0
    for epoch, t, delta in epochs:
        for group, d in delta.items():
            moves = epoch >= unfrozen_from.get(group, FT_EPOCHS)
            need((d > 0) == moves, f"finetune epoch {epoch}: {group} moved by {d:.3g}")
        print(f"{label} finetune B={batch} epoch {epoch}: {t - last:.2f} s, "
              "max |change| from the checkpoint: "
              + ", ".join(f"{g} {d:.3g}" for g, d in delta.items()))
        last = t
    print(f"{label} finetune: {FT_EPOCHS} epochs in {last - t0:.2f} s "
          f"({(last - t0) / FT_EPOCHS:.2f} s an epoch), losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f", launches {used}")


def phase_lr_range(dev, cfg: dict):
    """``lr_range_test`` at its defaults (100 steps, 1e-4 to 3.0) on the
    toy subtiles of phase 7's B=16 fit: a finite suggestion in the range,
    and the net's state dict as it was before the sweep."""
    import torch

    from myria3d_tpu_torch.train import build_trainer, lr_range_test

    _, model = build_trainer(cfg)
    model.to(dev)
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    steps = []
    step = model.train_step
    model.train_step = lambda *a: (steps.append(1), step(*a))[1]
    counters = reset_launches()
    t0 = time.perf_counter()
    lr = lr_range_test(model, TileDataModule(cfg), seed=int(cfg["seed"]))
    dt = time.perf_counter() - t0
    used = {n: fn.launches for n, fn in counters.items()}
    need(np.isfinite(lr) and 1e-4 <= lr <= 3.0, f"LR range test suggested {lr}")
    after = model.net.state_dict()
    need(all(torch.equal(before[k], after[k]) for k in before),
         "the LR range test left the net's state changed")
    need(all(used[k] > 0 for k in ("K1", "K4", "K5", "K6")), f"LR range test: launches {used}")
    print(f"phase 12 LR range test B={cfg['datamodule']['batch_size']}: suggested lr {lr:.6g} "
          f"after {len(steps)} of 100 steps in {dt:.2f} s; state dict bit-equal after; "
          f"launches {used}")


def device_ops_per_step(step, reps: int = 2):
    """Device kernels and copies per call of ``step`` in a ``torch.profiler``
    trace (None when the trace holds no device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    n = sum(ev.device_type == DeviceType.CUDA for ev in prof.events())
    return n / reps if n else None


def phase_microbatch(dev):
    """``model.grad_microbatch`` at ``bench.py --train``'s shape: one
    microbatched grad step against a manual accumulation of the same chunks
    on the same generators, then the microbatched train step timed beside
    the monolithic one at the same B."""
    import torch

    from myria3d_tpu_torch.models.model import build_model, chunk_generator

    def make(mb):
        torch.manual_seed(0)
        model = build_model("RandLANet", {
            "num_features": 9, "num_classes": 7, "num_neighbors": 16, "decimation": 4,
            "knn_window": WINDOW, "sort_inputs": True, "fused_train_lfa": "auto"}, lr=0.001,
            grad_microbatch=mb)
        model.to(dev)
        model.init_train_state()
        return model

    def timed(model, batch, reps=5):
        def step(i):
            return model.train_step(*batch, torch.Generator(device=dev).manual_seed(i))
        step(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for i in range(reps):
            loss, _ = step(i + 1)
        chk = sum(float(p.detach().sum()) for p in model.net.parameters())
        ms = (time.perf_counter() - t0) * 1e3 / reps
        need(np.isfinite(float(loss)) and np.isfinite(chk), "non-finite train step")
        ops = device_ops_per_step(lambda: step(0))
        return ms, torch.cuda.max_memory_allocated(dev) / 2**30, ops

    for b, mb, route in MICROBATCH_CASES:
        batch = [torch.from_numpy(a).to(dev) for a in train_batch(b, seed=3)]
        x, pos, y, mask = batch
        micro, ref = make(mb), make(0)
        gen = torch.Generator(device=dev).manual_seed(11)
        counters = reset_launches()
        loss, logits = micro.grad_step(x, pos, y, mask, gen)
        torch.cuda.synchronize()
        used = {n: fn.launches for n, fn in counters.items() if fn.launches}
        want = ({"K4": 16, "K5": 8, "K6": 16} if route == "fused" else {"K4": 16, "K5": 0, "K6": 0})
        got = {k: used.get(k, 0) for k in want}
        need(got == want, f"B={b} grad_microbatch={mb}: launches {used}")

        # the same chunks, one after another from the same BN stats
        stats = [t for t in ref.net.buffers() if t.is_floating_point()]
        start = [t.clone() for t in stats]
        ref.net.train()
        losses, outs, grads, chunk_stats = [], [], [], []
        for i in range(b // mb):
            for t, s0 in zip(stats, start):
                t.copy_(s0)
            ref.optimizer.zero_grad(set_to_none=True)
            rows = slice(i * mb, (i + 1) * mb)
            out = ref.net(x[rows], pos[rows], mask[rows], chunk_generator(gen, i))
            chunk_loss = ref.criterion(out, y[rows])
            chunk_loss.backward()
            losses.append(float(chunk_loss.detach()))
            outs.append(out.detach())
            grads.append([p.grad.clone() for p in ref.net.parameters()])
            chunk_stats.append([t.clone() for t in stats])
        k = b // mb
        mean_loss = sum(losses) / k
        need(abs(float(loss) - mean_loss) <= 1e-5 * abs(mean_loss),
             f"B={b}: loss {float(loss)} vs the chunks' mean {mean_loss}")
        need(logits.shape == (b, TRAIN_N, 7), f"B={b}: logits shape {tuple(logits.shape)}")
        mean_grads = [sum(g) / k for g in zip(*grads)]
        scale = max(float(g.abs().max()) for g in mean_grads)
        g_err = max(float((p.grad - g).abs().max()) for p, g in zip(micro.net.parameters(),
                                                                     mean_grads))
        need(g_err <= 1e-5 * scale, f"B={b}: gradients off the chunks' mean by {g_err:.3g} "
             f"(scale {scale:.3g})")
        s_err = 0.0
        for t, *per_chunk in zip([t for t in micro.net.buffers() if t.is_floating_point()],
                                 *chunk_stats):
            want_t = sum(per_chunk) / k
            s_err = max(s_err, float((t - want_t).abs().max()) / float(want_t.abs().max()))
        need(s_err <= 1e-6, f"B={b}: BN running stats off the chunks' mean by {s_err:.3g}")
        l_err = float((logits - torch.cat(outs)).abs().max())
        del ref, grads, chunk_stats, outs

        micro.optimizer.zero_grad(set_to_none=True)
        ms, mem, ops = timed(micro, batch)
        mono = make(0)
        mono_ms, mono_mem, mono_ops = timed(mono, batch)
        print(f"phase 13 grad_microbatch B={b} mb={mb} ({route} chunks): loss {float(loss):.6f} "
              f"= the chunks' mean, gradients within {g_err / scale:.3g} of scale, BN stats "
              f"within {s_err:.3g}, logits within {l_err:.3g}; microbatched {ms:.1f} ms/step, "
              f"peak {mem:.2f} GiB, {ops} device kernels and copies a step, launches {used}; "
              f"monolithic {mono_ms:.1f} ms/step, peak {mono_mem:.2f} GiB, {mono_ops} a step")
        del micro, mono, batch
        torch.cuda.empty_cache()


def phase_profiler(dev, work: str):
    """A 3-step fit with ``trainer.profiler=torch``: the Chrome trace of
    epoch 0's train loop under ``$LOGS_DIR/profile`` names the hand kernels
    the fit launched and the "train_step" regions, and the fit logs the
    host's time in those steps (``StageTimer``)."""
    import re

    from myria3d_tpu_torch.models.modules.randla_net import FUSED_TRAIN_MIN_BATCH
    from myria3d_tpu_torch.train import build_trainer

    logs = os.path.join(work, "logs")
    cfg = fit_config(os.path.join(work, "profiled"), FUSED_TRAIN_MIN_BATCH, "trainer.profiler=torch",
                     "trainer.max_epochs=1", "trainer.limit_train_batches=3",
                     "trainer.limit_val_batches=1")
    trainer, model = build_trainer(cfg)
    rows = []

    class Rows:
        """The trainer's logger: keeps every row."""

        def log_metrics(self, metrics, step=None):
            rows.append(metrics)

    trainer.logger = Rows()
    saved = os.environ.get("LOGS_DIR")
    os.environ["LOGS_DIR"] = logs
    try:
        counters = reset_launches()
        t0 = time.perf_counter()
        trainer.fit(model, TileDataModule(cfg))
        dt = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("LOGS_DIR")
        else:
            os.environ["LOGS_DIR"] = saved
    used = {n: fn.launches for n, fn in counters.items() if fn.launches}
    need(trainer.global_step == 3, f"profiled fit took {trainer.global_step} steps")
    files = [os.path.join(logs, "profile", f) for f in os.listdir(os.path.join(logs, "profile"))]
    need(len(files) == 1 and files[0].endswith(".json"), f"profile files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {ev.get("name", "") for ev in events}
    kernels = sorted({m.group(1) for n in names for m in [re.search(r"(\w+_kernel)\b", n)]
                      if m and m.group(1) in HAND_KERNELS})
    regions = sum(ev.get("name") == "train_step" for ev in events)
    need({"knn_topk_kernel", "gather_bwd_kernel"} <= set(kernels),
         f"the trace names the hand kernels {kernels}")
    need(regions >= 3, f"the trace holds {regions} train_step regions")
    timed = [r["profile/train_step_mean_s"] for r in rows if "profile/train_step_mean_s" in r]
    need(len(timed) == 1 and timed[0] > 0, f"the profiled epoch logged the step time {timed}")
    print(f"phase 14 profiler: 3-step fit in {dt:.2f} s, trace {os.path.getsize(files[0]) / 2**20:.2f} "
          f"MiB, {len(events)} events, {regions} train_step regions, hand kernels {kernels}; "
          f"host {1e3 * timed[0]:.1f} ms a traced step; launches {used}")


# ---------------------------------------------------------------------------
# phase 15: data parallel (parallel/ddp.py)
# ---------------------------------------------------------------------------

DP_BATCH = 32                  # split 16/16 over the two ranks
DP_REPS = 5                    # timed train steps a rank
DP_TIMEOUT = 300               # seconds for a spawn of ranks to finish
DP_HPARAMS = {"num_features": 9, "num_classes": 7, "num_neighbors": 16, "decimation": 4,
              "knn_window": WINDOW, "sort_inputs": True, "fused_train_lfa": True}
DP_CARD2 = ["cuda:0", "cuda:0"]  # two ranks share the card (gloo)
DP_NCCL = ["cuda:0"]             # one rank with the card to itself (NCCL)


def det_decimation(mask, decimation, generator=None):
    """Deterministic decimation (the first ``max(1, valid // decimation)``
    slots of each cloud), as the parity tests use: the ranks' draws and the
    one-process draws cannot match otherwise."""
    import torch

    b, n = mask.shape
    n_out = n // decimation
    idx = torch.arange(n_out, device=mask.device).expand(b, n_out)
    valid = mask.sum(1)
    kept = torch.where(valid > 0, (valid // decimation).clamp(min=1), 0)
    new_mask = torch.arange(n_out, device=mask.device)[None, :] < kept[:, None]
    return torch.where(new_mask, idx, 0), new_mask


@contextlib.contextmanager
def deterministic_decimation():
    import myria3d_tpu_torch.models.modules.randla_net as rl

    real = rl.random_decimation
    rl.random_decimation = det_decimation
    try:
        yield
    finally:
        rl.random_decimation = real


def synchronize(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_model(state, dev, name: str = "RandLANet"):
    """Phase 15's net (15b's PointNet++ for ``name`` "PointNet2") from
    ``state`` (no dropout) with a fresh optimizer."""
    from myria3d_tpu_torch.models.model import build_model

    pn2 = name == "PointNet2"
    model = build_model(name, PN2_HPARAMS if pn2 else DP_HPARAMS, lr=0.001)
    model.net.load_state_dict(state, strict=True)
    if pn2:
        model.net.head.dropout = [0.0]
    else:
        model.net.mlp_classif.dropout = [0.0, 0.0]
    model.to(dev)
    model.init_train_state()
    return model


def dp_grads(model):
    """Copies of the gradients and BN buffers (later steps update both in place)."""
    return ({k: p.grad.detach().cpu().clone() for k, p in model.net.named_parameters()},
            {k: b.detach().cpu().clone() for k, b in model.net.named_buffers()})


def dp_step_rank(out: str, state, batch, modes, name: str = "RandLANet"):
    """A rank of phase 15 (a), (b) and 15b (``name``'s net): for each BN
    mode, one DDP grad step on this rank's rows (loss, gradients, BN
    buffers, launches), then ``DP_REPS`` timed train steps and the bytes
    all-reduced a step."""
    import torch

    from myria3d_tpu_torch.parallel import ParallelSteps, ddp

    r, world, dev = ddp.rank(), ddp.world_size(), ddp.device()
    rows = batch[0].shape[0] // world
    x, pos, y, mask = (torch.from_numpy(a[r * rows:(r + 1) * rows]).to(dev) for a in batch)
    res = {}
    with deterministic_decimation():
        for sync_bn in modes:
            model = dp_model(state, dev, name)
            par = ParallelSteps(model, sync_bn=sync_bn)
            counters = reset_launches()
            loss, _ = par.grad_step(x, pos, y, mask)
            synchronize(dev)
            launches = {n: fn.launches for n, fn in counters.items()}
            grads, stats = dp_grads(model)
            before = ddp.all_reduce.bytes
            par.train_step(x, pos, y, mask)
            step_bytes = ddp.all_reduce.bytes - before + par.grad_bytes
            synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(DP_REPS):
                par.train_step(x, pos, y, mask)
            synchronize(dev)
            res["sync" if sync_bn else "local"] = dict(
                loss=float(loss), grads=grads, stats=stats, launches=launches,
                ms=(time.perf_counter() - t0) * 1e3 / DP_REPS, bytes=step_bytes,
                backend=torch.distributed.get_backend())
    torch.save(res, f"{out}.rank{r}")


def dp_fit_rank(out: str, work: str):
    """A rank of phase 15 (c): ``Trainer.fit`` on its shard of the toy-tile
    subtiles (early stopping after the second epoch), the checkpoint writes
    recorded, then ``Trainer.test`` of the last checkpoint on its shard."""
    import torch

    from myria3d_tpu_torch.parallel import ddp
    from myria3d_tpu_torch.train import build_trainer
    from myria3d_tpu_torch.utils import checkpoint

    writes = []
    real_save = checkpoint.save_checkpoint

    def save(ckpt_dir, *args, **kwargs):
        writes.append(os.path.basename(ckpt_dir))
        return real_save(ckpt_dir, *args, **kwargs)

    checkpoint.save_checkpoint = save
    cfg = dp_fit_config(work)
    with deterministic_decimation():
        trainer, model = build_trainer(cfg)
        model.net.mlp_classif.dropout = [0.0, 0.0]
        counters = reset_launches()
        trainer.fit(model, TileDataModule(cfg, shard=True))
        launches = {n: fn.launches for n, fn in counters.items()}
        ckpt = os.path.abspath(trainer.checkpoint_cb.last_model_path)
        out_test = trainer.test(model, TileDataModule(cfg, shard=True), ckpt_path=ckpt)
    torch.save({"writes": writes, "steps": trainer.global_step, "losses": trainer.train_losses,
                "launches": launches, "ckpt": ckpt, "test": out_test}, f"{out}.rank{ddp.rank()}")


def dp_fit_config(work: str) -> dict:
    # 16 subtiles a rank (the fused route); the first epoch improves, the
    # second cannot (min_delta), so early stopping ends the fit after it;
    # every subtile tested
    from myria3d_tpu_torch.models.modules.randla_net import FUSED_TRAIN_MIN_BATCH

    return fit_config(os.path.join(work, "dp"), FUSED_TRAIN_MIN_BATCH, "task.task_name=fit",
                      "trainer.max_epochs=4", "trainer.limit_train_batches=1",
                      "trainer.limit_val_batches=1", "trainer.limit_test_batches=null",
                      "callbacks.early_stopping.patience=1",
                      "callbacks.early_stopping.min_delta=1000000.0")


def cosines(a: dict, b: dict) -> float:
    """The least cosine over the tensors of ``a`` against the reference
    ``b``. Tensors whose reference gradient is below 1e-6 of the largest
    tensor's norm are left out: the biases right before a BatchNorm have an
    exact-zero gradient, which both sides give as f32 noise (~1e-8 of it)."""
    top = max(float(g.double().norm()) for g in b.values())
    worst = 1.0
    for k, g in b.items():
        u, v = a[k].double().flatten(), g.double().flatten()
        if float(v.norm()) > 1e-6 * top:
            worst = min(worst, float(u @ v / (u.norm() * v.norm()).clamp(min=1e-300)))
    return worst


def scale_gap(a: dict, b: dict) -> float:
    """max |a - b| / max |b| over the tensors."""
    return max(float((a[k] - v).abs().max() / v.abs().max().clamp(min=1e-30)) for k, v in b.items())


def phase_data_parallel(dev, work: str):
    """Phase 15: data parallel over ranks sharing the card, one NCCL rank,
    a two-rank fit and test, and predict over two replicas."""
    import torch

    from myria3d_tpu_torch.parallel import spawn
    from myria3d_tpu_torch.pctl.io.las import read_las
    from myria3d_tpu_torch.predict import predict
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config
    from myria3d_tpu_torch.train import build_trainer

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    batch = train_batch(DP_BATCH)
    torch.manual_seed(0)
    from myria3d_tpu_torch.models.model import build_model

    state = {k: v.detach().clone() for k, v in
             build_model("RandLANet", DP_HPARAMS).net.state_dict().items()}
    half = DP_BATCH // 2
    with deterministic_decimation():
        def one(rows):
            model = dp_model(state, dev)
            x, pos, y, mask = (torch.from_numpy(a[rows]).to(dev) for a in batch)
            loss, _ = model.grad_step(x, pos, y, mask)
            return (float(loss),) + dp_grads(model)
        ref = {"sync": one(slice(0, DP_BATCH))}
        halves = [one(slice(0, half)), one(slice(half, DP_BATCH))]
    ref["local"] = (float(np.mean([h[0] for h in halves])),
                    {k: (halves[0][1][k] + halves[1][1][k]) / 2 for k in halves[0][1]},
                    {k: (halves[0][2][k] + halves[1][2][k]) / 2 for k in halves[0][2]})

    def held(res, mode, what):
        loss, grads, stats = ref[mode]
        got = res[mode]
        rel = abs(got["loss"] - loss) / abs(loss)
        cos, gap = cosines(got["grads"], grads), scale_gap(got["stats"], stats)
        need(rel <= 1e-5, f"{what} {mode} BN: loss {got['loss']:.7f} vs one process {loss:.7f}")
        need(cos >= 0.999, f"{what} {mode} BN: gradient cosine {cos:.6f}")
        need(gap <= 1e-5, f"{what} {mode} BN: BN running stats {gap:.3g} of scale")
        used = {k: v for k, v in got["launches"].items() if v}
        need(all(used.get(k, 0) > 0 for k in ("K1", "K2", "K4", "K5", "K6")),
             f"{what} {mode} BN: launches {used}")
        return (f"loss rel err {rel:.2e}, least gradient cosine {cos:.6f}, BN stats "
                f"{gap:.2e} of scale, {got['ms']:.1f} ms/step, {got['bytes'] / 2**20:.2f} MiB "
                f"all-reduced a step ({got['backend']}), launches {used}")

    # (a) two gloo ranks share the card, 16 clouds each
    out = os.path.join(work, "dp_step")
    t0 = time.perf_counter()
    spawn(dp_step_rank, DP_CARD2, args=(out, state, batch, (True, False)), timeout=DP_TIMEOUT)
    ranks = [torch.load(f"{out}.rank{r}", weights_only=True) for r in range(2)]
    for mode in ("sync", "local"):
        need(all(torch.equal(ranks[0][mode]["grads"][k], ranks[1][mode]["grads"][k])
                 for k in ranks[0][mode]["grads"]), f"(a) {mode} BN: the ranks' gradients differ")
        print(f"phase 15 (a) 2 gloo ranks on one card B={DP_BATCH} ({half} a rank, fused) {mode} "
              f"BN against one process: {held(ranks[0], mode, '(a)')}; rank 1 "
              f"{ranks[1][mode]['ms']:.1f} ms/step")
    print(f"phase 15 (a) spawn to exit: {time.perf_counter() - t0:.1f} s")

    # (b) one NCCL rank, the whole batch
    out = os.path.join(work, "dp_nccl")
    spawn(dp_step_rank, DP_NCCL, args=(out, state, batch, (True,)), timeout=DP_TIMEOUT)
    res = torch.load(f"{out}.rank0", weights_only=True)
    need(res["sync"]["backend"] == "nccl", f"(b) backend {res['sync']['backend']}")
    print(f"phase 15 (b) 1 NCCL rank B={DP_BATCH} sync BN against one process: "
          f"{held(res, 'sync', '(b)')}")

    # (c) two ranks fit and test on the toy-tile subtiles
    out = os.path.join(work, "dp_fit")
    t0 = time.perf_counter()
    spawn(dp_fit_rank, DP_CARD2, args=(out, work), timeout=DP_TIMEOUT)
    dt = time.perf_counter() - t0
    ranks = [torch.load(f"{out}.rank{r}", weights_only=False) for r in range(2)]
    need(ranks[1]["writes"] == [], f"(c) rank 1 wrote {ranks[1]['writes']}")
    writes = ranks[0]["writes"]
    need(writes.count("last") == 2 and len(writes) == len(set(writes)) + 1,
         f"(c) rank 0 writes {writes}")
    need(ranks[0]["steps"] == ranks[1]["steps"] == 2 and ranks[0]["losses"] == ranks[1]["losses"],
         f"(c) steps {ranks[0]['steps']}/{ranks[1]['steps']}, losses {ranks[0]['losses']} / "
         f"{ranks[1]['losses']}")
    need(all(np.isfinite(ranks[0]["losses"])), f"(c) losses {ranks[0]['losses']}")
    need(all(ranks[0]["launches"].get(k, 0) > 0 for k in ("K1", "K2", "K4", "K5", "K6")),
         f"(c) launches {ranks[0]['launches']}")
    cfg = dp_fit_config(work)
    with deterministic_decimation():
        trainer, model = build_trainer(cfg)
        one_test = trainer.test(model, TileDataModule(cfg), ckpt_path=ranks[0]["ckpt"])
    iou, one_iou = ranks[0]["test"]["test/iou"], one_test["test/iou"]
    need(ranks[1]["test"]["test/iou"] == iou, "(c) the ranks' test IoU differ")
    need(abs(iou - one_iou) <= 0.01, f"(c) test IoU {iou:.4f} vs one process {one_iou:.4f}")
    print(f"phase 15 (c) 2-rank fit + test: {dt:.1f} s, {ranks[0]['steps']} steps a rank (early "
          f"stop after epoch 1 on both), rank 0 wrote {writes}, rank 1 none; test IoU {iou:.4f} "
          f"(one process {one_iou:.4f}), launches {ranks[0]['launches']}")

    # (d) predict over two replicas on the card, batch 5 padded to 6
    tile = os.path.join(ASSETS, "toy_tile.las")
    from myria3d_tpu_torch.models.interpolation import Interpolator

    logits, classes = {}, {}
    real_store = Interpolator.store_predictions
    counters = launch_counters()
    for name, kw in (("one", {"device": DP_CARD2[0]}), ("two", {"devices": DP_CARD2})):
        seen = logits[name] = []

        def store(self, lg, idx, _seen=seen):
            _seen.append(np.asarray(lg, np.float32).copy())
            return real_store(self, lg, idx)

        pcfg = compose_config(CONFIG_DIR, "config.yaml", [
            "task.task_name=predict", f"predict.src_las={tile}", f"predict.ckpt_path={ASSETS}",
            f"predict.output_dir={work}/dp_pred_{name}", "datamodule.batch_size=5"])
        Interpolator.store_predictions = store
        for fn in counters.values():
            fn.launches = 0
        try:
            with deterministic_decimation():
                res = read_las(predict(pcfg, **kw)).points
        finally:
            Interpolator.store_predictions = real_store
        classes[name] = np.asarray(res["PredictedClassification"])
        if name == "two":
            used = {k: fn.launches for k, fn in counters.items() if fn.launches}
    pairs = list(zip(logits["two"], logits["one"]))
    need(len(logits["two"]) == len(logits["one"]) and all(a.shape == b.shape for a, b in pairs),
         f"(d) logits {[a.shape for a in logits['two']]} vs {[b.shape for b in logits['one']]}")
    diff = max(float(np.abs(a - b).max()) for a, b in pairs)
    scale = max(float(np.abs(b).max()) for _, b in pairs)
    agree = float((classes["one"] == classes["two"]).mean())
    need(agree >= 0.999, f"(d) argmax agreement {agree:.5f}")
    need(all(used.get(k, 0) > 0 for k in ("K1", "K2", "K3")), f"(d) launches {used}")
    print(f"phase 15 (d) predict over 2 replicas on one card (batch 5 -> 6 rows): argmax "
          f"agreement {agree:.6f}, max logit diff {diff:.3g} of scale {scale:.3g}, launches "
          f"{used}")


# PointNet++ (phases 16-17): the sampled counts of its set abstractions at
# N=12288 (decimation 4), and K8's shapes beside a cloud past the register
# route (its running distances in shared memory)
PN2_STAGES = (12_288, 3072, 768, 192, 48)
FPS_SHAPES = tuple(zip(PN2_STAGES[:-1], PN2_STAGES[1:]))
FPS_LARGE = (40_960, 10_240)                 # the largest bucket of pctl.batching
FPS_INSTR = 10                               # per point a round: 3 sub, 3 mul, 2 add, min, compare
PN2_HPARAMS = {"num_features": 9, "num_classes": 7}   # configs/model/pointnet2_model.yaml
PN2_RADII = (0.05, 0.1, 0.2, 0.4)            # PointNet2's defaults (pointnet2.py)
PN2_NEIGHBOURS = 32
PN2_TRAIN_B = 16
# the finetuning callback's groups on PointNet++ (its FC head is RandLA-Net's
# mlp_classif, as in the JAX package: PointNet++'s "head" stays frozen)
PN2_FT_GROUPS = {"fc_classif": ("fc_classif",), "head": ("head",),
                 "decoder": ("fp1", "fp2", "fp3", "fp4"),
                 "encoder": ("fc0", "sa1", "sa2", "sa3", "sa4")}
PN2_FT_UNFROZEN_FROM = {"fc_classif": 0, "decoder": 3}


def fps_clouds(b: int, n: int, m: int, seed: int = 0):
    """(pos, mask) of ``b`` clouds of ``n`` slots, uniform in [-1, 1]^3
    (normalized subtile units): cloud 0 all pads, cloud 1 with fewer valid
    points than ``m``, the others between ``m`` and ``n``; pads hold
    garbage."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    counts = rng.integers(m, n + 1, b)
    counts[0], counts[1] = 0, max(1, m // 2)
    mask = np.arange(n)[None, :] < counts[:, None]
    pos[~mask] = rng.uniform(-1e3, 1e3, (int((~mask).sum()), 3)).astype(np.float32)
    return pos, mask


def fps_scattered_clouds(b: int, n: int, m: int, seed: int = 0):
    """(pos, mask) as :func:`fps_clouds`, but the valid points scattered
    over the slots (a mask that is no prefix): cloud 0 all pads, cloud 1
    with ``m // 2`` valid points, the others ~70 % valid."""
    pos, _ = fps_clouds(b, n, m, seed)
    rng = np.random.default_rng(seed + 1)
    mask = rng.random((b, n)) < 0.7
    mask[0] = False
    mask[1] = False
    mask[1, rng.choice(n, max(1, m // 2), replace=False)] = True
    return pos, mask


def fps_sorted_clouds(seed: int = 0):
    """(pos, mask) of the B=48 bench subtiles' sampled clouds, x-sorted as
    ``SortPointsByX`` leaves the sa1 input of predict and test, in
    normalized units."""
    _, pos, mask, _, _ = bench_subtiles(seed)
    return normalized(pos), mask


def fps_bound(mask, m: int):
    """K8's bound from the data: FPS_INSTR a valid point a round over each
    cloud's min(valid, m) - 1 updates, against reading the cloud and
    writing the slots; and the rounds the batch runs."""
    valid = mask.sum(1).astype(np.float64)
    rounds = np.minimum(valid, m)
    instr = FPS_INSTR * float((np.maximum(rounds - 1, 0) * valid).sum())
    n_bytes = mask.size * (3 * 4 + 1) + mask.shape[0] * m * (4 + 1)
    return bound(instr, n_bytes), int(rounds.sum())


def fps_cases():
    """Phase 16a's K8 cases: (B, n, m, label), label "" for the uniform
    clouds of ``fps_clouds``."""
    cases = [(b, n, m, "") for b in (PN2_TRAIN_B, B) for n, m in FPS_SHAPES]
    cases.append((PN2_TRAIN_B, *FPS_LARGE, ""))
    cases.append((B, *FPS_SHAPES[0], "x-sorted"))
    cases.append((B, *FPS_SHAPES[0], "non-prefix"))
    return cases


def phase_fps(dev):
    """16a: K8 bit-equal to its plain version at the set abstractions'
    shapes (B=16 and 48), at 40960 -> 10240, on the x-sorted bench
    subtiles and on a mask that is no prefix; the route the wrapper's rule
    takes, the card's time with the host ahead and per round, the plain
    version's, the bound and the rounds."""
    import torch

    from myria3d_tpu_torch.ops import cuda_fps
    from myria3d_tpu_torch.ops.cuda_fps import farthest_point_sampling_plain, fps

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for b, n, m, label in fps_cases():
        if label == "x-sorted":
            pos_np, mask_np = fps_sorted_clouds()
        elif label == "non-prefix":
            pos_np, mask_np = fps_scattered_clouds(b, n, m, seed=7)
        else:
            pos_np, mask_np = fps_clouds(b, n, m, seed=n + b)
        what = f"K8 B={b} {n}->{m}{' ' + label if label else ''}"
        pos, mask = torch.from_numpy(pos_np).to(dev), torch.from_numpy(mask_np).to(dev)
        idx_k, nm_k = fps(pos, mask, m)
        idx_p, nm_p = farthest_point_sampling_plain(pos, mask, m)
        need(bool(torch.equal(nm_k, nm_p)), f"{what}: masks differ")
        need(bool(torch.equal(idx_k, idx_p)), f"{what}: indices differ at "
             f"{int((idx_k != idx_p).sum())} slots")
        ms = cuda_ms(lambda: fps(pos, mask, m), 5, ahead=True)
        plain_ms = cuda_ms(lambda: farthest_point_sampling_plain(pos, mask, m), 1, warmup=0)
        bnd, rounds = fps_bound(mask_np, m)
        chain = int(min(mask_np.sum(1).max(), m))    # the longest cloud's rounds
        rt = cuda_fps.route(b, n, sms)
        print(f"phase 16a {what} (route: {rt.threads} threads x {rt.pt} points, cluster of "
              f"{rt.cluster}, skip {int(rt.skip)}): bit-equal, {ms:.3f} ms, "
              f"{1e3 * ms / max(chain, 1):.3f} us a round, plain {plain_ms:.1f} ms, "
              f"{rounds} rounds, {bounds_text(bnd)}")
        if b == B and (n, m) in FPS_SHAPES and not label:
            rows.append((0.0, ms, plain_ms, bnd, None))
    return rows


def normalized(a: np.ndarray) -> np.ndarray:
    """Bench-subtile positions (metres in [0, 50]) in normalized subtile
    units, [-1, 1] (``NormalizePos``): the units of PointNet++'s radii. The
    map is increasing, so x-sorted clouds stay sorted."""
    return (a / 25.0 - 1.0).astype(np.float32)


def pn2_searches(dev, b: int = B, seed: int = 3):
    """The eight PointNet++ searches at full scale (16b), on the x-sorted
    bench subtiles in normalized units with K8's centroids: ``(label, q4,
    k4, query mask, k, r2)``, each set abstraction's ball query (its
    centroids into the stage's cloud, k = 32, ``r2`` its radius's f32
    square) and each feature propagation's k=3 search (the stage's cloud
    into its centroids, ``r2`` None)."""
    import torch

    from myria3d_tpu_torch.ops.cuda_fps import fps
    from myria3d_tpu_torch.ops.knn import ball_r2, centred_clouds, gather_rows

    _, pos, mask, _, _ = bench_subtiles(seed)
    pos = torch.from_numpy(normalized(pos[:b])).to(dev)
    mask = torch.from_numpy(mask[:b]).to(dev)
    stages = [(pos, mask)]
    for m in PN2_STAGES[1:]:
        p, v = stages[-1]
        sel, sel_mask = fps(p, v, m)
        stages.append((gather_rows(p, sel), sel_mask))
    out = []
    for (p, v), (c, cm), radius in zip(stages[:-1], stages[1:], PN2_RADII):
        out.append((f"K=32 ball query {c.shape[1]}<-{p.shape[1]}",
                    *centred_clouds(c, p, v), cm, PN2_NEIGHBOURS, ball_r2(radius)))
        out.append((f"k=3 FP {p.shape[1]}<-{c.shape[1]}", *centred_clouds(p, c, cm), v, 3, None))
    return out


def phase_pn2_searches(dev):
    """16b: K1 at the PointNet++ searches (full scans), B=48 and B=16: the
    ball route (lists from r^2) at the four ball queries and the 4-slot list
    at the four k=3 searches, as the model calls them (the ball queries
    walked in x order where they fill more than one tile, the k=3 searches
    in row order), bit-equal to their plain versions; timed with the host
    ahead beside the generic 32-slot list, the route before these, at the
    same shape (for a ball query, its 32 nearest keys before the radius), held
    bit-equal to its own plain version, all in this call. Returns the B=48
    rows of the kernels line, ball route and 4-slot list apart."""
    from myria3d_tpu_torch.ops.cuda_knn import (
        _windows,
        ball_walk,
        knn_topk,
        knn_topk_plain,
        launch,
    )

    rows = {"K1_ball": [], "K1_small": []}
    for b in (B, PN2_TRAIN_B):
        for label, q4, k4, qm, k, r2 in pn2_searches(dev, b):
            ball = r2 is not None
            idx_k, d2_k = knn_topk(q4, k4, k, query_mask=qm, r2=r2)
            idx_p, d2_p = knn_topk_plain(q4, k4, k, query_mask=qm, r2=r2)
            err = check_k1(idx_k, d2_k, idx_p, d2_p, label)
            kg = 32 if ball else k
            check_k1(*launch(q4, k4, kg, list_k=32), *knn_topk_plain(q4, k4, kg, query_mask=qm),
                     f"{label} on the generic 32-slot list")
            ms = cuda_ms(lambda: knn_topk(q4, k4, k, query_mask=qm, r2=r2), 5, ahead=True)
            generic_ms = cuda_ms(lambda: launch(q4, k4, kg, list_k=32), 5, ahead=True)
            plain_ms = cuda_ms(lambda: knn_topk_plain(q4, k4, k, query_mask=qm, r2=r2), 1,
                               warmup=0)
            bnd = bound(PAIR_INSTR * float(qm.sum()) * _windows(q4, k4, 0, qm)[1],
                        nbytes(q4, k4, idx_k, d2_k))
            walk = "x-ordered" if ball and ball_walk(q4) is not None else "row order"
            print(f"phase 16b K1 {label} B={b} ({'ball route' if ball else '4-slot list'}, "
                  f"{walk}): bit-equal, {ms:.3f} ms (generic 32-slot list, bit-equal to its "
                  f"plain version: {generic_ms:.3f} ms, {generic_ms / ms:.2f}x), plain "
                  f"{plain_ms:.1f} ms, {bounds_text(bnd)}")
            if b == B:
                rows["K1_ball" if ball else "K1_small"].append((err, ms, plain_ms, bnd, None))
    return rows


@contextlib.contextmanager
def generic_searches():
    """PointNet++'s searches as before the ball route (16c, 16d compare the
    steps):
    the ball query as the generic 32-slot list's 32 nearest keys filtered
    by the radius, the k=3 searches on the generic list."""
    from myria3d_tpu_torch.models.modules import pointnet2
    from myria3d_tpu_torch.ops import cuda_knn
    from myria3d_tpu_torch.ops import knn as knn_ops

    def ball(query_pos, key_pos, key_mask, k, radius, query_mask=None):
        idx, _, neigh_valid = knn_ops.ball_query(query_pos, key_pos, key_mask, k, radius,
                                                 query_mask)
        return idx, neigh_valid

    def generic(q4, k4, k, window=0, query_mask=None):
        return cuda_knn.launch(q4, k4, k, window, query_mask, list_k=32)

    saved = pointnet2.ball_neighbours, knn_ops.knn_topk
    pointnet2.ball_neighbours, knn_ops.knn_topk = ball, generic
    try:
        yield
    finally:
        pointnet2.ball_neighbours, knn_ops.knn_topk = saved


def pn2_model(dev, seed: int = 0):
    """A full-width PointNet++ (``configs/model/pointnet2_model.yaml``,
    9 features, 7 classes), random weights from ``seed``."""
    import torch

    from myria3d_tpu_torch.models.model import build_model

    torch.manual_seed(seed)
    return build_model("PointNet2", dict(PN2_HPARAMS)).to(dev)


def pn2_predict_step(dev):
    """16c's step: a full-width PointNet++ ``Model.interp_step`` over the
    x-sorted bench subtiles in normalized units (B=48, N=12288, M=32768,
    window 4608), as predict runs it; returns the step and the full
    clouds' mask."""
    import torch

    x, pos, mask, full_pos, full_mask = bench_subtiles(0)
    x, pos, mask, full_pos, full_mask = (torch.from_numpy(a).to(dev) for a in (
        x, normalized(pos), mask, normalized(full_pos), full_mask))
    model = pn2_model(dev).eval()
    model.set_sorted_window(WINDOW)

    def step():
        return model.interp_step(x, pos, mask, pos, full_pos, full_mask)

    step.model = model   # phase 18c sets its compute dtype
    return step, full_mask


def pn2_train_batch(dev):
    """16d's batch: ``bench.py --train``'s at B=16 in normalized units,
    unsorted, as fit hands it to the net."""
    import torch

    x, pos, y, mask = train_batch(PN2_TRAIN_B)
    return tuple(torch.from_numpy(a).to(dev) for a in (x, pos / 25.0, y, mask))


# launches per PointNet++ step (K1's ball route and 4-slot list are K1's
# launches too: four ball queries, four k=3 searches)
PN2_PREDICT_LAUNCHES = {"K1": 8, "K1_ball": 4, "K1_small": 4, "K3": 1, "K8": 4}
PN2_TRAIN_LAUNCHES = {"K1": 8, "K1_ball": 4, "K1_small": 4, "K4": 8, "K8": 4}


def pn2_turns(step, first_ms: float, reps: int) -> str:
    """The step on the generic searches (``generic_searches``) and on the
    new routes in turns after the new routes' first (new, generic,
    generic, new), ``reps`` steps a turn, wall clock around a
    synchronisation: the ms of each turn."""
    import torch

    def turn():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    with generic_searches():
        step()
        generic = [turn(), turn()]
    new = [first_ms, turn()]
    return (f"turns new {new[0]:.1f}, generic {generic[0]:.1f}, generic {generic[1]:.1f}, new "
            f"{new[1]:.1f} ms (generic / new {sum(generic) / sum(new):.3f})")


def phase_pn2_predict_step(dev):
    """16c: ``Model.interp_step`` of a full-width PointNet++ at the bench
    shape (B=48, N=12288, M=32768; x-sorted subtiles in normalized units,
    window 4608): kernel path against plain path."""
    import torch

    step, full_mask = pn2_predict_step(dev)

    counters = {k: v for k, v in launch_counters().items() if k in PN2_PREDICT_LAUNCHES}
    step()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out_k = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    launches = {n: fn.launches for n, fn in counters.items()}
    per_step = {n: v / reps for n, v in launches.items()}
    need(per_step == PN2_PREDICT_LAUNCHES, f"predict step launches per step {per_step}")
    turns = pn2_turns(step, ms, reps)
    with generic_searches():
        out_g = step()
    need(bool(torch.equal(out_g, out_k)), "PointNet++ predict step: the generic searches' "
         "output differs from the new routes'")
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()
    with plain_versions():
        t0 = time.perf_counter()
        out_p = step()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    need(bool(torch.isfinite(out_k).all()) and out_k.shape == (B, M, 7), "bad step output")
    agree = float((out_k.argmax(-1) == out_p.argmax(-1))[full_mask].float().mean())
    need(agree >= 0.999, f"PointNet++ predict step: argmax agreement {agree:.5f} < 0.999")
    print(f"phase 16c PointNet++ predict step B={B} N={N} M={M}: kernels {ms:.1f} ms/batch "
          f"({B * RAW / ms / 1e3:.3f} Mpts/s), plain {plain_ms:.1f} ms/batch, argmax agreement "
          f"{agree:.6f}, launches per step {per_step}; host enqueue {host_ms:.1f} ms/step; "
          f"{turns} [{CARD}]")
    print(f"phase 16c profile: {profile_steps(step, keep=('fps_kernel',))}")
    return launches


def phase_pn2_train_step(dev):
    """16d: a full-width PointNet++ train step at B=16, N=12288 (``bench.py
    --train``'s batch in normalized units): the gradient against the plain
    path's and bit-equal to the generic searches', ms per step, peak memory
    and the launches per step."""
    import torch

    x, pos, y, mask = pn2_train_batch(dev)
    counters = {k: v for k, v in launch_counters().items() if k in PN2_TRAIN_LAUNCHES}

    def grads(model):
        model.optimizer.zero_grad(set_to_none=True)
        model.grad_step(x, pos, y, mask, torch.Generator(device=dev).manual_seed(7))
        return torch.cat([p.grad.flatten() for p in model.net.parameters()])

    model = pn2_model(dev)
    model.init_train_state()
    g_k = grads(model)
    generic = pn2_model(dev)
    generic.init_train_state()
    with generic_searches():
        g_g = grads(generic)
    del generic
    need(bool(torch.equal(g_g, g_k)), "PointNet++ train step: the generic searches' gradient "
         "differs from the new routes'")
    plain = pn2_model(dev)
    plain.init_train_state()
    with plain_versions():
        g_p = grads(plain)
    del plain
    cos = float((g_k.double() @ g_p.double()) / (g_k.double().norm() * g_p.double().norm()))
    need(bool(torch.isfinite(g_k).all()) and cos >= 0.999,
         f"PointNet++ train step: gradient cosine kernel/plain {cos:.6f}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    reps = 5
    t0 = time.perf_counter()
    for i in range(reps):
        loss, _ = model.train_step(x, pos, y, mask, torch.Generator(device=dev).manual_seed(i))
    chk = sum(float(p.detach().sum()) for p in model.net.parameters())
    ms = (time.perf_counter() - t0) * 1e3 / reps
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {n: fn.launches for n, fn in counters.items()}
    per_step = {n: v / reps for n, v in launches.items()}
    need(np.isfinite(float(loss)) and np.isfinite(chk), "non-finite PointNet++ train step")
    need(per_step == PN2_TRAIN_LAUNCHES, f"train step launches per step {per_step}")

    def step():
        return model.train_step(x, pos, y, mask, torch.Generator(device=dev).manual_seed(0))

    turns = pn2_turns(step, ms, reps)
    print(f"phase 16d PointNet++ train step B={PN2_TRAIN_B} N={TRAIN_N}: {ms:.1f} ms/step "
          f"({PN2_TRAIN_B * TRAIN_N / ms / 1e3:.3f} Mpts/s), peak {peak:.2f} GiB, gradient "
          f"cosine kernel/plain {cos:.6f}, launches per step {per_step}; {turns} [{CARD}]")

    print(f"phase 16d profile: {profile_steps(step, keep=('fps_kernel',))}")
    return launches


def phase_pn2_fit(dev, work: str):
    """16d: ``Trainer.fit`` with ``model=pointnet2_model`` on the toy-tile
    subtiles (``overfit_batches: 1``, B=16), then ``predict()`` with its
    checkpoint on the card and on the CPU (plain versions)."""
    from myria3d_tpu_torch.pctl.io.las import read_las
    from myria3d_tpu_torch.predict import predict
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config
    from myria3d_tpu_torch.train import build_trainer

    counters = {k: v for k, v in launch_counters().items() if k in ("K1", "K4", "K8")}
    cfg = fit_config(os.path.join(work, "pn2"), PN2_TRAIN_B, "model=pointnet2_model",
                     "task.task_name=fit", "trainer.overfit_batches=1",
                     f"trainer.max_epochs={FIT_STEPS}", f"trainer.min_epochs={FIT_STEPS}")
    trainer, model = build_trainer(cfg)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer.fit(model, TileDataModule(cfg))
    dt = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    losses = trainer.train_losses
    need(len(losses) == FIT_STEPS and all(np.isfinite(losses)), f"PointNet++ fit losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    need(last < first, f"PointNet++ fit: loss did not fall ({first:.4f} -> {last:.4f})")
    need(all(v > 0 for v in launches.values()), f"PointNet++ fit launches {launches}")
    print(f"phase 16d PointNet++ fit B={PN2_TRAIN_B}: {FIT_STEPS} steps in {dt:.1f} s, loss first "
          f"five {first:.4f} -> last five {last:.4f}, launches {launches}")
    ckpt = trainer.checkpoint_cb.last_model_path
    phase_test(dev, cfg, ckpt, ("K1", "K3", "K8"), "phase 16d PointNet++")
    phase_finetune(dev, work, ckpt, PN2_FT_GROUPS, PN2_FT_UNFROZEN_FROM, ("K1", "K4", "K8"),
                   "phase 16d PointNet++", "model=pointnet2_model")

    tile = os.path.join(ASSETS, "toy_tile.las")
    acc, maps = {}, {}
    for device in ("cuda", "cpu"):
        pcfg = compose_config(CONFIG_DIR, "config.yaml", [
            "task.task_name=predict", f"predict.src_las={tile}",
            f"predict.ckpt_path={ckpt}",
            f"predict.output_dir={work}/pn2_pred_{device}", "datamodule.batch_size=16",
            "datamodule.subtile_width=16"])
        t0 = time.perf_counter()
        res = read_las(predict(pcfg, device=device)).points
        maps[device] = np.asarray(res["PredictedClassification"])
        acc[device] = (float((maps[device] == np.asarray(res["Classification"])).mean()),
                       time.perf_counter() - t0)
    # the eval forward draws nothing at random: the class maps agree too
    agree = float((maps["cuda"] == maps["cpu"]).mean())
    need(abs(acc["cuda"][0] - acc["cpu"][0]) <= ACCURACY_MARGIN and agree >= 0.999,
         f"PointNet++ predict: GT accuracy {acc['cuda'][0]:.4f} vs CPU plain {acc['cpu'][0]:.4f}, "
         f"class-map agreement {agree:.5f}")
    print(f"phase 16d PointNet++ predict() with the fit checkpoint: GT accuracy {acc['cuda'][0]:.4f} "
          f"in {acc['cuda'][1]:.1f} s (CPU plain {acc['cpu'][0]:.4f} in {acc['cpu'][1]:.1f} s), "
          f"class-map agreement {agree:.6f}")
    return launches


def phase_parity(dev, work: str):
    """17: ``parity.run_parity`` on the toy tile with a synthetic Lightning
    checkpoint, on the card and on the CPU: class-map agreement >= 0.999 and
    mIoU within 0.01; the card run through K1 and K2. RandLA-Net's
    decimation is deterministic in both runs (``det_decimation``): the
    card's and the CPU's generators draw different numbers from one seed."""
    import io

    from myria3d_tpu_torch.parity import run_parity
    from myria3d_tpu_torch.pctl.io.las import read_las
    from myria3d_tpu_torch.utils.checkpoint import make_synthetic_lightning_checkpoint

    ckpt = make_synthetic_lightning_checkpoint(os.path.join(work, "proto.ckpt"))
    tile = os.path.join(ASSETS, "toy_tile.las")
    counters = {k: v for k, v in launch_counters().items() if k in ("K1", "K2")}
    reports, secs = {}, {}
    for accel in ("auto", "cpu"):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        # the harness prints its own table and JSON line
        with contextlib.redirect_stdout(io.StringIO()), deterministic_decimation():
            reports[accel] = run_parity(ckpt, tile, output_dir=os.path.join(work, f"parity_{accel}"),
                                        epsg="2154", batch_size=4, accelerator=accel)
        secs[accel] = time.perf_counter() - t0
        if accel == "auto":
            launches = {n: fn.launches for n, fn in counters.items()}
    need(all(v > 0 for v in launches.values()), f"parity on the card: launches {launches}")
    maps = {a: np.asarray(read_las(r["predicted_las"]).points["PredictedClassification"])
            for a, r in reports.items()}
    agree = float((maps["auto"] == maps["cpu"]).mean())
    miou = {a: r["ours_vs_gt"]["miou"] for a, r in reports.items()}
    need(agree >= 0.999, f"parity: class-map agreement card/CPU {agree:.5f} < 0.999")
    need(abs(miou["auto"] - miou["cpu"]) <= 0.01, f"parity: mIoU {miou['auto']:.4f} vs CPU "
         f"{miou['cpu']:.4f}")
    print(f"phase 17 parity harness (synthetic Lightning checkpoint, toy tile): card mIoU "
          f"{miou['auto']:.4f} in {secs['auto']:.1f} s, CPU mIoU {miou['cpu']:.4f} in "
          f"{secs['cpu']:.1f} s, class-map agreement {agree:.6f}, verdict "
          f"{reports['auto']['verdict']}, launches {launches}")


# ---------------------------------------------------------------------------
# phase 15b: PointNet++ under DDP; phases 18-19: the compute dtype, log-softmax
# outputs and remat
# ---------------------------------------------------------------------------

CARD = ""                      # nvidia-smi's name and power limit (phase 1)
DTYPE_TOL = 0.99               # bf16 against f32: the predict steps' argmax agreement
# bf16 against f32: the train step's whole-gradient cosine. RandLA-Net's
# bar is 0.99. PointNet++'s is the JAX package's own: its bf16 step on this
# phase's weights and bench.py --train's batches at N=12288 and B=4 (the
# CPU's room; a quarter of this batch, so more bf16 noise a gradient) is
# 0.970790-0.972806 from its
# f32 step over three batch seeds, the least of which is the bar
# (scripts/bf16_gradient_reference.py; the port on the CPU there reads
# 0.968959-0.972576). The port's bf16 ops are JAX's op by op
# (tests/myria3d_tpu_torch/test_torch_mixed_precision.py): bf16 itself
# moves this gradient that far, most in sa1's BatchNorm parameters.
DTYPE_COS = {"RandLANet": 0.99, "PointNet2": 0.970790}
TOL["K2_16"] = 1e-4            # K2's: the same arithmetic on the widened values
REMAT_TOL = 1e-6               # remat against no remat: gradients, of scale


def phase_pn2_data_parallel(dev, work: str):
    """15b: PointNet++ (full width, B=16 split 8/8) on two gloo ranks that
    share the card, one DDP grad step with sync BN against the one-process
    step and with local BN against the mean of the halves' one-process
    steps (phase 15 (a)'s bars), then each rank's ms per train step."""
    import torch

    from myria3d_tpu_torch.parallel import spawn

    torch.cuda.empty_cache()
    x, pos, y, mask = (t.cpu().numpy() for t in pn2_train_batch(torch.device("cpu")))
    batch = (x, pos, y, mask)
    state = {k: v.detach().cpu().clone() for k, v in pn2_model("cpu").net.state_dict().items()}
    half = PN2_TRAIN_B // 2

    def one(rows):
        model = dp_model(state, dev, "PointNet2")
        loss, _ = model.grad_step(*(torch.from_numpy(a[rows]).to(dev) for a in batch))
        return (float(loss),) + dp_grads(model)

    ref = {"sync": one(slice(0, PN2_TRAIN_B))}
    halves = [one(slice(0, half)), one(slice(half, PN2_TRAIN_B))]
    ref["local"] = (float(np.mean([h[0] for h in halves])),
                    {k: (halves[0][1][k] + halves[1][1][k]) / 2 for k in halves[0][1]},
                    {k: (halves[0][2][k] + halves[1][2][k]) / 2 for k in halves[0][2]})
    out = os.path.join(work, "dp_pn2")
    t0 = time.perf_counter()
    spawn(dp_step_rank, DP_CARD2, args=(out, state, batch, (True, False), "PointNet2"),
          timeout=DP_TIMEOUT)
    ranks = [torch.load(f"{out}.rank{r}", weights_only=True) for r in range(2)]
    for mode in ("sync", "local"):
        loss, grads, stats = ref[mode]
        got = ranks[0][mode]
        need(all(torch.equal(got["grads"][k], ranks[1][mode]["grads"][k]) for k in got["grads"]),
             f"15b {mode} BN: the ranks' gradients differ")
        rel = abs(got["loss"] - loss) / abs(loss)
        cos, gap = cosines(got["grads"], grads), scale_gap(got["stats"], stats)
        used = {k: v for k, v in got["launches"].items() if v}
        need(rel <= 1e-5 and cos >= 0.999 and gap <= 1e-5,
             f"15b {mode} BN: loss rel err {rel:.3g}, gradient cosine {cos:.6f}, BN stats {gap:.3g}")
        need(all(used.get(k, 0) > 0 for k in ("K1", "K4", "K8")), f"15b {mode} BN: launches {used}")
        print(f"phase 15b PointNet++ 2 gloo ranks on one card B={PN2_TRAIN_B} ({half} a rank) "
              f"{mode} BN against one process: loss rel err {rel:.2e}, least gradient cosine "
              f"{cos:.6f}, BN stats {gap:.2e} of scale, {got['ms']:.1f} / "
              f"{ranks[1][mode]['ms']:.1f} ms/step (ranks 0 / 1), {got['bytes'] / 2**20:.2f} MiB "
              f"all-reduced a step ({got['backend']}), launches {used} [{CARD}]")
    print(f"phase 15b spawn to exit: {time.perf_counter() - t0:.1f} s")


def k2_16_cases(model, dev):
    """18a's K2 inputs: the toy checkpoint's eight folded LFAs at the predict
    stage shapes (B=48, N=12288 -> 3072 -> 768 -> 192, K=16, window 4608),
    random features in [-1, 1): [(label, (x, pos, idx, nv, enc_a, enc_c,
    att_w), valid points)]."""
    import torch

    from myria3d_tpu_torch.ops.cuda_knn import stage_window
    from myria3d_tpu_torch.ops.knn import gather_rows, knn_graph
    from myria3d_tpu_torch.ops.sampling import random_decimation

    _, pos, mask, _, _ = (torch.from_numpy(a).to(dev) for a in bench_subtiles(1))
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = [(pos, mask)]
    for _ in range(3):
        p, m = stages[-1]
        idx, m2 = random_decimation(m, 4, gen)
        stages.append((gather_rows(p, idx), m2))
    net, cases = model.net, []
    for blk, (p, m) in zip((net.block1, net.block2, net.block3, net.block4), stages):
        idx, _, nv = knn_graph(p, m, 16, window=stage_window(WINDOW, p.shape[1]))
        for lfa in (blk.lfa1, blk.lfa2):
            enc_a, enc_c = (t.contiguous() for t in lfa.folded_encoder())
            att_w = lfa.mlp_attention.lins[0].weight.T.contiguous()
            c_in = enc_a.shape[0]
            feats = torch.rand((B, p.shape[1], c_in), generator=gen, device=dev) * 2 - 1
            cases.append((f"({c_in},{2 * c_in}) N={p.shape[1]}",
                          (feats, p, idx, nv, enc_a, enc_c, att_w), float(m.sum())))
    return cases


def phase_k2_16(model, dev) -> list:
    """18a: K2 reading bfloat16 and float16 features against its plain
    version on the same values widened to f32 (within 1e-4 of scale), timed
    beside K2's f32 instantiation on those values; the bound with 2-byte x
    rows. Returns the kernels line's rows (bfloat16's times)."""
    import torch

    from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention, lfa_attention_plain

    rows = []
    for label, (feats, *rest), valid in k2_16_cases(model, dev):
        c_in = feats.shape[-1]
        c, slots = 2 * c_in, valid * 16
        errs, ms = {}, {}
        for dtype in (torch.bfloat16, torch.float16):
            x16 = feats.to(dtype)
            got = lfa_attention(x16, *rest)
            errs[dtype] = scale_err(got, lfa_attention_plain(x16.float(), *rest), TOL["K2_16"],
                                    f"K2_16 {dtype} {label}")
            ms[dtype] = cuda_ms(lambda: lfa_attention(x16, *rest), 5)
        x16 = feats.to(torch.bfloat16)
        xf = x16.float()
        f32_ms = cuda_ms(lambda: lfa_attention(xf, *rest), 5)
        plain_ms = cuda_ms(lambda: lfa_attention_plain(xf, *rest), 2)
        n_bytes = nbytes(x16, *rest, got)
        cuda_bnd = bound(slots * (c * c + 10 * c_in + 4 * c), n_bytes)
        bnd = tc_bound(slots * c * c, slots * (10 * c_in + 4 * c), n_bytes)
        rows.append((max(errs.values()), ms[torch.bfloat16], plain_ms, bnd, None))
        print(f"phase 18a K2_16 {label}: max_abs_err bf16 {errs[torch.bfloat16]:.3g}, f16 "
              f"{errs[torch.float16]:.3g}; bf16 {ms[torch.bfloat16]:.3f} ms, f16 "
              f"{ms[torch.float16]:.3f} ms, K2 f32 on the same values {f32_ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, {bounds_text(bnd, cuda_bnd)} (2-byte x) [{CARD}]")
    return rows


def timed_steps(step, reps: int):
    """(ms per call over ``reps`` calls after one warm call, last output)."""
    import torch

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def predict_steps_by_dtype(model, step, full_mask, what: str):
    """18b/c: the predict step in f32 and bfloat16 (f32, bf16, bf16, f32),
    the argmax agreement of the bf16 step with the f32 one (>= 0.99)."""
    ms = {"float32": [], "bfloat16": []}
    out = {}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        model.set_compute_dtype(dtype)
        t, out[dtype] = timed_steps(step, 3)
        ms[dtype].append(t)
    model.set_compute_dtype("float32")
    agree = float((out["float32"].argmax(-1) == out["bfloat16"].argmax(-1))[full_mask]
                  .float().mean())
    need(agree >= DTYPE_TOL, f"{what}: bf16/f32 argmax agreement {agree:.5f} < {DTYPE_TOL}")
    mean = {k: float(np.mean(v)) for k, v in ms.items()}
    print(f"phase 18 {what} predict step B={B} N={N} M={M}: f32 {mean['float32']:.1f} ms/batch "
          f"({B * RAW / mean['float32'] / 1e3:.3f} Mpts/s; turns {ms['float32'][0]:.1f}, "
          f"{ms['float32'][1]:.1f}), bf16 {mean['bfloat16']:.1f} ms/batch "
          f"({B * RAW / mean['bfloat16'] / 1e3:.3f} Mpts/s; turns {ms['bfloat16'][0]:.1f}, "
          f"{ms['bfloat16'][1]:.1f}), argmax agreement bf16/f32 {agree:.6f} [{CARD}]")


def train_steps_by_dtype(dev, name: str, make, batch):
    """18d: one family's train step at B=16, N=12288 in f32 and bfloat16 from
    the same weights on the same batch and generators: ms/step, peak memory,
    the loss, the gradient cosine bf16/f32 (>= 0.99) and the route's
    launches (a 16-bit RandLA-Net takes the unfused one: no K5, no K6)."""
    import torch

    counters = launch_counters()
    grads, named, res = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        model = make()
        model.set_compute_dtype(dtype)
        model.init_train_state()
        model.optimizer.zero_grad(set_to_none=True)
        model.grad_step(*batch, torch.Generator(device=dev).manual_seed(7))
        named[dtype] = {k: p.grad.detach().clone() for k, p in model.net.named_parameters()}
        grads[dtype] = torch.cat([g.flatten() for g in named[dtype].values()])
        model.train_step(*batch, torch.Generator(device=dev).manual_seed(0))   # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        start = {n: fn.launches for n, fn in counters.items()}
        reps = 3
        t0 = time.perf_counter()
        for i in range(reps):
            loss, _ = model.train_step(*batch, torch.Generator(device=dev).manual_seed(i))
        chk = sum(float(p.detach().sum()) for p in model.net.parameters())
        ms = (time.perf_counter() - t0) * 1e3 / reps
        per_step = {n: (fn.launches - start[n]) / reps for n, fn in counters.items()
                    if fn.launches > start[n]}
        need(np.isfinite(float(loss)) and np.isfinite(chk), f"{name} {dtype}: non-finite step")
        res[dtype] = (ms, torch.cuda.max_memory_allocated(dev) / 2**30, float(loss), per_step)
        del model
        torch.cuda.empty_cache()
    a, b = grads["bfloat16"].double(), grads["float32"].double()
    cos = float(a @ b / (a.norm() * b.norm()))
    top = max(float(v.double().norm()) for v in named["float32"].values())
    kept = [k for k, v in named["float32"].items() if float(v.double().norm()) > 1e-6 * top]
    a2 = torch.cat([named["bfloat16"][k].double().flatten() for k in kept])
    b2 = torch.cat([named["float32"][k].double().flatten() for k in kept])
    cos_kept = float(a2 @ b2 / (a2.norm() * b2.norm()))
    per = sorted((float(u.double().flatten() @ v.double().flatten()
                        / (u.double().norm() * v.double().norm()).clamp(min=1e-300)), k,
                  float(v.double().norm()), float(u.double().norm()))
                 for k, u, v in ((k, named["bfloat16"][k], named["float32"][k]) for k in kept))
    least = ", ".join(f"{k} {c:.4f}" for c, k, _, _ in per[:3])
    print(f"phase 18d {name}: gradient cosine bf16/f32 over the tensors above 1e-6 of the "
          f"largest norm (not the Linear biases before a BatchNorm, analytically zero) "
          f"{cos_kept:.6f}; the least per tensor: {least}")
    need(bool(torch.isfinite(grads["bfloat16"]).all()) and cos >= DTYPE_COS[name],
         f"{name} train step: bf16/f32 gradient cosine {cos:.6f} < {DTYPE_COS[name]}")
    route = ""
    if name == "RandLANet":
        used = res["bfloat16"][3]
        need(not used.get("K5") and not used.get("K6") and used.get("K4", 0) > 0,
             f"RandLA-Net bf16 train step: launches per step {used} (the unfused route has "
             f"K4 and no K5/K6)")
        route = " (bf16: the unfused route; f32: the fused route)"
    b16 = res["bfloat16"]
    print(f"phase 18d {name} train step B={PN2_TRAIN_B} N={TRAIN_N}{route}: f32 "
          f"{res['float32'][0]:.1f} ms/step, peak {res['float32'][1]:.2f} GiB, loss "
          f"{res['float32'][2]:.4f}; bf16 {b16[0]:.1f} ms/step, peak {b16[1]:.2f} GiB, loss "
          f"{b16[2]:.4f}; gradient cosine bf16/f32 {cos:.6f} (bar {DTYPE_COS[name]}); "
          f"launches per step f32 "
          f"{res['float32'][3]}, bf16 {b16[3]} [{CARD}]")


def randla_train_model(dev, **hp):
    """Phase 8's full-width RandLA-Net (``fused_train_lfa: auto``, window
    4608, in-model sort), random weights from seed 0."""
    import torch

    from myria3d_tpu_torch.models.model import build_model

    torch.manual_seed(0)
    return build_model("RandLANet", {
        "num_features": 9, "num_classes": 7, "num_neighbors": 16, "decimation": 4,
        "knn_window": WINDOW, "sort_inputs": True, **hp}, lr=0.001).to(dev)


def phase_compute_dtype(model, dev, work: str):
    """Phase 18 (a)-(e): K2_16, both families' predict steps and train steps
    in bf16 against f32, and ``predict()`` on the toy tile with
    ``predict.compute_dtype=bfloat16`` (the K2_16 main path). Returns the
    K2_16 rows and that run's launches."""
    import torch

    from myria3d_tpu_torch.pctl.io.las import read_las
    from myria3d_tpu_torch.predict import predict
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config

    with torch.inference_mode():
        rows = phase_k2_16(model, dev)
        x, pos, mask, full_pos, full_mask = (torch.from_numpy(a).to(dev) for a in bench_subtiles(0))
        model.set_sorted_window(WINDOW)

        def step():
            return model.interp_step(x, pos, mask, pos, full_pos, full_mask,
                                     torch.Generator(device=dev).manual_seed(1))

        predict_steps_by_dtype(model, step, full_mask, "18b RandLA-Net")
        step_pn2, full_mask = pn2_predict_step(dev)
        predict_steps_by_dtype(step_pn2.model, step_pn2, full_mask, "18c PointNet++")
        del step_pn2
    torch.cuda.empty_cache()
    batch = tuple(torch.from_numpy(a).to(dev) for a in train_batch(PN2_TRAIN_B))
    train_steps_by_dtype(dev, "RandLANet", lambda: randla_train_model(dev), batch)
    train_steps_by_dtype(dev, "PointNet2", lambda: pn2_model(dev), pn2_train_batch(dev))

    # (e) the main path of the 16-bit kernel: predict() in bf16
    tile = os.path.join(ASSETS, "toy_tile.las")
    cfg = compose_config(CONFIG_DIR, "config.yaml", [
        "task.task_name=predict", f"predict.src_las={tile}", f"predict.ckpt_path={ASSETS}",
        f"predict.output_dir={work}/pred_bf16", "datamodule.batch_size=4",
        "predict.compute_dtype=bfloat16"])
    counters = reset_launches()
    t0 = time.perf_counter()
    res = read_las(predict(cfg)).points
    dt = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items() if fn.launches}
    need(all(launches.get(k, 0) > 0 for k in ("K1", "K2_16", "K3")) and not launches.get("K2"),
         f"bf16 predict(): launches {launches} (K2_16, never K2's f32 instantiation)")
    acc = float((np.asarray(res["PredictedClassification"]) == np.asarray(res["Classification"])).mean())
    need(abs(acc - CPU_PLAIN_ACCURACY) <= ACCURACY_MARGIN,
         f"bf16 predict(): GT accuracy {acc:.4f} vs CPU plain {CPU_PLAIN_ACCURACY:.4f}")
    print(f"phase 18e predict() predict.compute_dtype=bfloat16 on the toy tile: {dt:.2f} s, GT "
          f"accuracy {acc:.4f} (CPU plain f32 {CPU_PLAIN_ACCURACY:.4f}), launches {launches} "
          f"[{CARD}]")
    return rows, launches


def phase_log_probs_and_remat(dev, work: str):
    """Phase 19: ``return_logits: false`` through ``predict()`` on the toy
    tile against the logits run, and the RandLA-Net train step at B=16 with
    ``remat: true`` against ``false``."""
    import shutil

    import torch

    from myria3d_tpu_torch.pctl.io.las import read_las
    from myria3d_tpu_torch.predict import predict
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config

    ckpt = os.path.join(work, "log_probs_ckpt")
    shutil.copytree(ASSETS, ckpt)
    with open(os.path.join(ckpt, "hparams.json")) as f:
        hp = json.load(f)
    hp["neural_net_hparams"]["return_logits"] = False
    with open(os.path.join(ckpt, "hparams.json"), "w") as f:
        json.dump(hp, f)
    tile = os.path.join(ASSETS, "toy_tile.las")
    probs, maps = {}, {}
    for name, path in (("logits", ASSETS), ("log_probs", ckpt)):
        cfg = compose_config(CONFIG_DIR, "config.yaml", [
            "task.task_name=predict", f"predict.src_las={tile}", f"predict.ckpt_path={path}",
            f"predict.output_dir={work}/pred_{name}", "datamodule.batch_size=4"])
        res = read_las(predict(cfg)).points
        names = list(cfg["predict"]["interpolator"]["classification_dict"].values())
        probs[name] = np.stack([np.asarray(res[n], np.float64) for n in names], axis=1)
        maps[name] = np.asarray(res["PredictedClassification"])
    diff = float(np.abs(probs["logits"] - probs["log_probs"]).max())
    differ = maps["logits"] != maps["log_probs"]
    best_two = np.sort(probs["logits"][differ], axis=1)[:, -2:]
    gap = float((best_two[:, 1] - best_two[:, 0]).max()) if differ.any() else 0.0
    need(diff <= 1e-3 and differ.mean() <= 1e-3 and gap <= 2e-3,
         f"return_logits false: probabilities {diff:.3g} apart, {int(differ.sum())} class changes, "
         f"widest top-two gap among them {gap:.3g}")
    print(f"phase 19 predict() with return_logits: false on the toy tile: probabilities within "
          f"{diff:.3g} of the logits run's, class map equal at {1 - float(differ.mean()):.6f} of "
          f"{len(differ)} points (the {int(differ.sum())} others near-ties, top two within "
          f"{gap:.3g})")

    batch = tuple(torch.from_numpy(a).to(dev) for a in train_batch(PN2_TRAIN_B))
    res = {}
    for remat in (False, True):
        model = randla_train_model(dev, remat=remat)
        model.init_train_state()
        model.optimizer.zero_grad(set_to_none=True)
        model.grad_step(*batch, torch.Generator(device=dev).manual_seed(7))
        grads = {k: p.grad.detach().clone() for k, p in model.net.named_parameters()}
        stats = {k: b.detach().clone() for k, b in model.net.named_buffers()}
        model.train_step(*batch, torch.Generator(device=dev).manual_seed(0))   # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reps = 3
        t0 = time.perf_counter()
        for i in range(reps):
            loss, _ = model.train_step(*batch, torch.Generator(device=dev).manual_seed(i))
        chk = sum(float(p.detach().sum()) for p in model.net.parameters())
        ms = (time.perf_counter() - t0) * 1e3 / reps
        need(np.isfinite(float(loss)) and np.isfinite(chk), f"remat={remat}: non-finite step")
        res[remat] = (grads, stats, ms, torch.cuda.max_memory_allocated(dev) / 2**30)
        del model
        torch.cuda.empty_cache()
    # of the net's largest gradient: the biases before a BatchNorm have an
    # exact-zero gradient, f32 noise in both runs (torch's scatter-adds of
    # the decimation gathers' backward are not deterministic on the card)
    top = max(float(v.abs().max()) for v in res[False][0].values())
    gap = max(float((res[True][0][k] - v).abs().max()) for k, v in res[False][0].items()) / top
    stats_gap = max(float((res[True][1][k] - v).abs().max()) for k, v in res[False][1].items())
    need(gap <= REMAT_TOL and stats_gap == 0.0,
         f"remat: gradients {gap:.3g} of scale apart, BN running stats {stats_gap:.3g}")
    print(f"phase 19 RandLA-Net train step B={PN2_TRAIN_B} N={TRAIN_N} remat true against false: "
          f"gradients {gap:.3g} of scale apart, BN running stats equal; remat "
          f"{res[True][2]:.1f} ms/step, peak {res[True][3]:.2f} GiB; no remat {res[False][2]:.1f} "
          f"ms/step, peak {res[False][3]:.2f} GiB [{CARD}]")


# phase 20: the exact_knn RandLA-Net (model.neural_net_hparams.exact_knn,
# predict.exact_knn) and logger=comet
EXACT_GRAD_COS = 0.999999       # the exact net's gradient against knn_window 0's


def enqueue_ms(step, reps: int = 3) -> float:
    """The host's time to enqueue ``reps`` steps without waiting for the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def phase_exact_k1(dev):
    """20 (a): K1 at the exact predict step's searches (B=48, every one a
    full scan): the encoder graphs K=16 and the decoder's k=1, each
    bit-equal to its plain version and timed beside it. The rows of the
    kernels line's ``K1_full`` entry."""
    import torch

    from myria3d_tpu_torch.ops.cuda_knn import _windows, knn_topk, knn_topk_plain
    from myria3d_tpu_torch.ops.knn import centred_clouds, gather_rows
    from myria3d_tpu_torch.ops.sampling import random_decimation

    _, pos, mask, _, _ = (torch.from_numpy(a).to(dev) for a in bench_subtiles(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = [(pos, mask)]
    for _ in range(4):
        p, m = stages[-1]
        idx, m2 = random_decimation(m, 4, gen)
        stages.append((gather_rows(p, idx), m2))
    cases = [(f"K=16 self {stages[i][0].shape[1]}", stages[i], stages[i], 16) for i in range(4)]
    cases += [(f"K=1 {stages[i][0].shape[1]}<-{stages[i + 1][0].shape[1]}", stages[i],
               stages[i + 1], 1) for i in range(3, -1, -1)]
    rows = []
    for label, (qp, qm), (kp, km), k in cases:
        q4, k4 = centred_clouds(qp, kp, km)
        idx_k, d2_k = knn_topk(q4, k4, k, query_mask=qm)
        err = check_k1(idx_k, d2_k, *knn_topk_plain(q4, k4, k, query_mask=qm), label)
        bnd = bound(PAIR_INSTR * float(qm.sum()) * _windows(q4, k4, 0, qm)[1],
                    nbytes(q4, k4, idx_k, d2_k))
        ms = cuda_ms(lambda: knn_topk(q4, k4, k, query_mask=qm), 5, ahead=True)
        plain_ms = cuda_ms(lambda: knn_topk_plain(q4, k4, k, query_mask=qm), 1)
        rows.append((err, ms, plain_ms, bnd, None))
        print(f"phase 20a K1 full scan {label} B={B}: bit-equal, {ms:.3f} ms (host ahead), "
              f"plain {plain_ms:.3f} ms, {bounds_text(bnd)} [{CARD}]")
    return rows


def phase_exact_knn(dev, work: str):
    """Phase 20: the full-width RandLA-Net with ``knn_window: 4608`` and
    ``exact_knn: true`` in its hparams. (a) the predict step at the bench
    shape: its logits bit-equal to the same weights' with ``knn_window:
    0``, its full-cloud argmax against the exact two-op step, K1's
    launches by instantiation (full scans only), ms/batch and host enqueue
    in turns beside the windowed step; (b) the train step at B=16 on the
    unfused route: its gradient against ``knn_window: 0``'s on that route,
    ms/step and peak memory beside the windowed (fused) step; (c)
    ``predict()`` on the toy tile with a checkpoint whose hparams carry
    ``exact_knn: true`` and with ``predict.exact_knn=true``; (d) a two-step
    ``Trainer.fit`` with ``logger=comet`` and no credentials. Returns the
    ``K1_full`` rows and the launches of (a)-(c)."""
    import shutil
    import types

    import torch

    from myria3d_tpu_torch.ops.cuda_knn import scans
    from myria3d_tpu_torch.pctl.io.las import read_las
    from myria3d_tpu_torch.predict import predict
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config
    from myria3d_tpu_torch.train import build_trainer

    with torch.inference_mode():
        rows = phase_exact_k1(dev)
    counters = reset_launches()
    scans.clear()   # K1's kNN-route launches by (list size, window or full scan)
    total = {}

    def add(used):
        for name, v in used.items():
            total[name] = total.get(name, 0) + v

    # (a) the predict step
    exact, full, windowed = (randla_train_model(dev, **hp) for hp in (
        {"exact_knn": True}, {"knn_window": 0}, {}))
    for model in (exact, full, windowed):
        model.set_sorted_window(WINDOW if model is not full else 0)
    need(exact.net.exact_knn and exact.net.knn_window == WINDOW and exact.exact_knn,
         "the exact_knn hparam did not reach the net")
    x, pos, mask, full_pos, full_mask = (torch.from_numpy(a).to(dev) for a in bench_subtiles(0))

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    with torch.inference_mode():
        exact.net.eval()
        full.net.eval()
        logits_e, logits_f = exact.net(x, pos, mask, gen(1)), full.net(x, pos, mask, gen(1))
        need(bool(torch.equal(logits_e, logits_f)),
             f"exact_knn logits differ from knn_window 0's by "
             f"{float((logits_e - logits_f).abs().max()):.3g}")

        def steps(model, fused=True):
            return lambda: model.interp_step(x, pos, mask, pos, full_pos, full_mask, gen(1),
                                             fused=fused)

        out_k3, out_two_op = steps(exact)(), steps(exact, False)()
        agree = float((out_k3.argmax(-1) == out_two_op.argmax(-1))[full_mask].float().mean())
        need(agree >= 0.999, f"exact_knn: K3 / two-op full-cloud argmax agreement {agree:.5f}")
        step_e, step_w = steps(exact), steps(windowed)
        step_e()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        scans.clear()
        for _ in range(3):
            step_e()
        torch.cuda.synchronize()
        per_step = {n: fn.launches / 3 for n, fn in counters.items() if fn.launches}
        by_list = {f"K={kl} {kind}": v / 3 for (kl, kind), v in sorted(scans.items())}
        add({n: fn.launches for n, fn in counters.items()})
        need(not any(kind == "window" for _, kind in scans) and scans.get((16, "full scan"))
             and scans.get((1, "full scan")) and per_step.get("K2") and per_step.get("K3"),
             f"exact_knn predict step: K1 {by_list}, launches per step {per_step}")
        ms = {"exact": [], "windowed": []}
        host = {"exact": [], "windowed": []}
        for name in ("exact", "windowed", "windowed", "exact"):
            step = step_e if name == "exact" else step_w
            ms[name].append(timed_steps(step, 3)[0])
            host[name].append(enqueue_ms(step))
    mean = {k: float(np.mean(v)) for k, v in ms.items()}
    print(f"phase 20a exact_knn predict step B={B} N={N} M={M} (knn_window {WINDOW}, exact_knn "
          f"true, sorted window {WINDOW}): logits bit-equal to knn_window 0's; full-cloud "
          f"argmax K3 (windowed) / exact two-op {agree:.6f}; K1 per step {by_list}, launches "
          f"per step {per_step}")
    print(f"phase 20a exact_knn predict step: {mean['exact']:.1f} ms/batch "
          f"({B * RAW / mean['exact'] / 1e3:.3f} Mpts/s; turns {ms['exact'][0]:.1f}, "
          f"{ms['exact'][1]:.1f}; host enqueue {np.mean(host['exact']):.1f} ms), windowed "
          f"{mean['windowed']:.1f} ms/batch ({B * RAW / mean['windowed'] / 1e3:.3f} Mpts/s; turns "
          f"{ms['windowed'][0]:.1f}, {ms['windowed'][1]:.1f}; host enqueue "
          f"{np.mean(host['windowed']):.1f} ms) [{CARD}]")
    del exact, full, windowed, out_k3, out_two_op
    torch.cuda.empty_cache()

    # (b) the train step on the route JAX takes under exact_knn (unfused);
    # clouds x-sorted, so the in-model sort of the windowed nets is the
    # identity and every net draws the same decimations
    xs, ps, ys, ms_ = train_batch(PN2_TRAIN_B)
    order = np.argsort(ps[..., 0], axis=1, kind="stable")
    batch = tuple(torch.from_numpy(np.take_along_axis(a, order[..., None] if a.ndim == 3 else order,
                                                      axis=1)).to(dev) for a in (xs, ps, ys, ms_))
    grads, res = {}, {}
    for name, hp in (("exact", {"exact_knn": True}),
                     ("full", {"knn_window": 0, "fused_train_lfa": False}), ("windowed", {})):
        model = randla_train_model(dev, **hp)
        model.init_train_state()
        model.optimizer.zero_grad(set_to_none=True)
        for fn in counters.values():
            fn.launches = 0
        scans.clear()
        model.grad_step(*batch, gen(7))
        torch.cuda.synchronize()
        used = {n: fn.launches for n, fn in counters.items() if fn.launches}
        if name == "exact":
            add(used)
            need(not used.get("K5") and not used.get("K6") and used.get("K4")
                 and not any(kind == "window" for _, kind in scans),
                 f"exact_knn train step: launches {used}, K1 {scans} (the unfused route, "
                 f"full scans)")
            train_used = (used, dict(scans))
        grads[name] = torch.cat([p.grad.detach().flatten() for p in model.net.parameters()])
        if name != "full":
            model.train_step(*batch, gen(0))   # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            for i in range(3):
                loss, _ = model.train_step(*batch, gen(i))
            chk = sum(float(p.detach().sum()) for p in model.net.parameters())
            res[name] = ((time.perf_counter() - t0) * 1e3 / 3,
                         torch.cuda.max_memory_allocated(dev) / 2**30)
            need(np.isfinite(float(loss)) and np.isfinite(chk), f"{name}: non-finite train step")
        del model
        torch.cuda.empty_cache()
    a, b = grads["exact"].double(), grads["full"].double()
    cos = float(a @ b / (a.norm() * b.norm()))
    gap = float((a - b).abs().max() / b.abs().max())
    need(cos >= EXACT_GRAD_COS, f"exact_knn gradient cosine {cos:.9f} against knn_window 0's "
         f"< {EXACT_GRAD_COS}")
    print(f"phase 20b exact_knn train step B={PN2_TRAIN_B} N={TRAIN_N} (unfused route): gradient "
          f"cosine against knn_window 0's {cos:.9f}, largest gap {gap:.3g} of the largest "
          f"gradient; launches {train_used[0]}, K1 {train_used[1]}; {res['exact'][0]:.1f} ms/step, "
          f"peak {res['exact'][1]:.2f} GiB; windowed (fused route) {res['windowed'][0]:.1f} "
          f"ms/step, peak {res['windowed'][1]:.2f} GiB [{CARD}]")

    # (c) predict() on the toy tile: exact_knn from the checkpoint, and
    # predict.exact_knn on the default checkpoint
    ckpt = os.path.join(work, "exact_knn_ckpt")
    shutil.copytree(ASSETS, ckpt)
    with open(os.path.join(ckpt, "hparams.json")) as f:
        hp = json.load(f)
    hp["neural_net_hparams"]["exact_knn"] = True
    with open(os.path.join(ckpt, "hparams.json"), "w") as f:
        json.dump(hp, f)
    tile = os.path.join(ASSETS, "toy_tile.las")
    for label, path, extra in (("checkpoint hparam exact_knn: true", ckpt, []),
                               ("predict.exact_knn=true", ASSETS, ["predict.exact_knn=true"])):
        cfg = compose_config(CONFIG_DIR, "config.yaml", [
            "task.task_name=predict", f"predict.src_las={tile}", f"predict.ckpt_path={path}",
            f"predict.output_dir={work}/pred_exact_{len(extra)}", "datamodule.batch_size=4",
            *extra])
        for fn in counters.values():
            fn.launches = 0
        scans.clear()
        t0 = time.perf_counter()
        res_las = read_las(predict(cfg)).points
        dt = time.perf_counter() - t0
        used = {n: fn.launches for n, fn in counters.items() if fn.launches}
        add(used)
        need(not any(kind == "window" for _, kind in scans) and all(
            used.get(k, 0) > 0 for k in ("K1", "K2", "K3")),
            f"predict() {label}: launches {used}, K1 {scans}")
        acc = float((np.asarray(res_las["PredictedClassification"])
                     == np.asarray(res_las["Classification"])).mean())
        need(abs(acc - CPU_PLAIN_ACCURACY) <= ACCURACY_MARGIN,
             f"predict() {label}: GT accuracy {acc:.4f} vs CPU plain {CPU_PLAIN_ACCURACY:.4f}")
        print(f"phase 20c predict() {label} on the toy tile: {dt:.2f} s, GT accuracy {acc:.4f} "
              f"(CPU plain {CPU_PLAIN_ACCURACY:.4f}), launches {used}, K1 "
              f"{dict(sorted(scans.items()))} [{CARD}]")

    # (d) logger=comet without credentials: the fit runs, no Comet call
    stand_in = types.ModuleType("comet_ml")
    stand_in.calls = []

    class Experiment:
        def __init__(self, *args, **kwargs):
            stand_in.calls.append("Experiment")

    stand_in.Experiment = Experiment
    token = os.environ.pop("COMET_API_TOKEN", None)   # no credentials
    previous = sys.modules.get("comet_ml")
    sys.modules["comet_ml"] = stand_in
    try:
        run_dir = os.path.join(work, "comet")
        cfg = compose_config(CONFIG_DIR, "config.yaml", [
            "dataset_description=toy_synthetic", "logger=comet", f"hydra.run.dir={run_dir}",
            "datamodule.batch_size=4", "datamodule.subtile_width=16", "task.task_name=fit",
            f"callbacks.model_checkpoint.dirpath={run_dir}/checkpoints",
            "trainer.max_epochs=1", "trainer.limit_train_batches=2", "trainer.limit_val_batches=1"])
        trainer, model = build_trainer(cfg)
        t0 = time.perf_counter()
        trainer.fit(model, TileDataModule(cfg))
        dt = time.perf_counter() - t0
    finally:
        if token is not None:
            os.environ["COMET_API_TOKEN"] = token
        if previous is None:
            sys.modules.pop("comet_ml", None)
        else:
            sys.modules["comet_ml"] = previous
    logger = trainer.logger
    need(type(logger).__name__ == "CometLogger" and logger.experiment is None
         and not stand_in.calls and trainer.global_step == 2
         and all(np.isfinite(trainer.train_losses)),
         f"logger=comet fit: {type(logger).__name__}, steps {trainer.global_step}, Comet calls "
         f"{stand_in.calls}")
    print(f"phase 20d Trainer.fit with logger=comet and no credentials: {trainer.global_step} "
          f"steps in {dt:.1f} s, losses {[round(v, 4) for v in trainer.train_losses]}, no Comet "
          f"call")
    return rows, total


# phases 21-22: the CLI, ``python -m myria3d_tpu_torch.run``, as a user runs
# it. The module runs as ``-m`` runs it (``runpy``, ``__main__``), with
# ``predict()`` wrapped so that it prints its ``phases`` dict and logs its
# line per tile, and the Interpolator's finalize timed on the wrapper's own
# clock (the dict's ``finalize_write_s`` is the LAS write alone, as in the
# JAX package); the wrapper then prints the launch counts of its process,
# which start at 0 there, and its peak device memory.
CLI_WRAPPER = r'''
import json, logging, runpy, sys, time
import myria3d_tpu_torch.predict as predict_module
from myria3d_tpu_torch.models.interpolation import Interpolator
predict = predict_module.predict
finalize = Interpolator.reduce_predictions_and_save

def predict_with_phases(config, *args, **kwargs):
    phases = {}
    out = predict(config, *args, phases=phases, **kwargs)
    print("CLI phases " + json.dumps(phases), flush=True)
    return out

def timed_finalize(self, *args, **kwargs):
    t0 = time.perf_counter()
    out = finalize(self, *args, **kwargs)
    print(f"CLI finalize+write {time.perf_counter() - t0:.3f} s", flush=True)
    return out

predict_module.predict = predict_with_phases
Interpolator.reduce_predictions_and_save = timed_finalize
log = logging.getLogger("myria3d_tpu_torch.predict")
log.setLevel(logging.INFO)
log.addHandler(logging.StreamHandler(sys.stdout))
try:
    runpy.run_module("myria3d_tpu_torch.run", run_name="__main__", alter_sys=True)
finally:
    import torch
    from myria3d_tpu_torch.ops.cuda_interp import knn_interp
    from myria3d_tpu_torch.ops.cuda_knn import knn_topk
    from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention
    print("CLI launches " + json.dumps({"K1": knn_topk.launches, "K2": lfa_attention.launches,
                                        "K3": knn_interp.launches}))
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0
    print(f"CLI peak device memory {peak / 2**30:.3f} GiB")
'''
CLI_ACCURACY_MARGIN = 0.005    # the CLI's GT accuracy against phase 4's


def run_cli(argv: list, cwd: str, env: dict, timeout: int = 600,
            launched=("K1", "K2", "K3")) -> dict:
    """``python -m myria3d_tpu_torch.run <argv>`` through ``CLI_WRAPPER`` in
    a subprocess: it must exit 0 with no FAIL line, print one ``phases``
    dict per tile, and launch the kernels ``launched`` (RandLA-Net's K1, K2
    and K3 by default). Returns its wall seconds, output lines, launch
    counts, phases dicts and peak device GiB."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", CLI_WRAPPER, *argv], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    lines = (res.stdout + res.stderr).splitlines()
    need(res.returncode == 0, f"the CLI exited {res.returncode}: {res.stderr[-3000:]}")
    need(not any(line.startswith("FAIL") for line in lines), "the CLI printed a FAIL line")

    def tagged(tag):
        return [line[len(tag):] for line in lines if line.startswith(tag)]

    counts = [json.loads(v) for v in tagged("CLI launches ")]
    need(len(counts) == 1 and all(counts[0][k] > 0 for k in launched),
         f"the CLI's launches: {counts}")
    phases = [json.loads(v) for v in tagged("CLI phases ")]
    need(len(phases) >= 1, "the CLI's predict printed no phases")
    return {"s": dt, "lines": lines, "launches": counts[0], "phases": phases,
            "finalize_s": [float(v.split()[0]) for v in tagged("CLI finalize+write ")],
            "peak_gib": float(tagged("CLI peak device memory ")[0].split()[0])}


def cli_env(cwd: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "LOGS_DIR"}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return env


def phase_cli(main_acc: float) -> None:
    """Phase 21: ``python -m myria3d_tpu_torch.run`` predicts the toy tile
    on the card in a subprocess, from a temporary cwd whose ``.env`` sets
    ``LOGS_DIR`` (unset in the subprocess's environment), with the ``=``
    forms of the config flags and a relative ``predict.output_dir``: the LAS
    lands in ``<LOGS_DIR>/runs/<date>/<time>/out/``, its GT accuracy within
    0.005 of phase 4's, K1, K2 and K3 launched, and no FAIL line."""
    from myria3d_tpu_torch.pctl.io.las import read_las

    with tempfile.TemporaryDirectory(prefix="m3d_cli_") as cwd:
        with open(os.path.join(cwd, ".env"), "w") as f:
            f.write(f"LOGS_DIR={cwd}/logs_env\n")
        argv = [f"--config-path={os.path.join(ROOT, 'configs')}", "--config-name=config",
                "task.task_name=predict", "experiment=predict",
                f"predict.src_las={os.path.join(ASSETS, 'toy_tile.las')}",
                f"predict.ckpt_path={ASSETS}", "predict.output_dir=out"]
        run = run_cli(argv, cwd, cli_env(cwd))
        outs = glob.glob(os.path.join(cwd, "logs_env", "runs", "*", "*", "out", "toy_tile.las"))
        need(len(outs) == 1, f"the CLI's LAS is not under the .env's LOGS_DIR run directory: "
             f"{glob.glob(os.path.join(cwd, '**', '*.las'), recursive=True)}")
        las = read_las(outs[0]).points
    acc = float((np.asarray(las["PredictedClassification"])
                 == np.asarray(las["Classification"])).mean())
    need(abs(acc - main_acc) <= CLI_ACCURACY_MARGIN,
         f"the CLI's GT accuracy {acc:.4f} against phase 4's {main_acc:.4f}")
    print(f"phase 21 CLI: python -m myria3d_tpu_torch.run predict (.env LOGS_DIR, "
          f"--config-path=, experiment=predict, batch 48) {run['s']:.2f} s wall, the LAS in "
          f"{os.path.relpath(outs[0], cwd)}, GT accuracy {acc:.4f} (phase 4 {main_acc:.4f}), "
          f"launches {run['launches']} [{CARD}]")


# phase 22: a whole 1 km² Lidar HD tile, bench_e2e.py's synthetic one
# (17.18 M points, production GridSampling statistics), and a dense crop
# whose subtiles reach the loader's largest buckets
TILE_POINTS, TILE_EXTENT = 17_180_000, 1000
CROP_POINTS, CROP_EXTENT = 800_000, 100      # ~80 points/m²: MaximumNumNodes caps its subtiles
TILE_DIR = os.path.join(ROOT, "build", "myria3d_tpu_torch", "tiles")
TILE_SEED = 12345                            # the predict config's seed: the generator of (b)
HELD_BUCKETS = 3                             # (N_pad, M_pad) buckets held against the plain path
SAMPLED_CAP = 40_064                         # MaximumNumNodes(40000) rounded up to 128
FULL_LADDER_TOP = 131_072                    # pctl/batching.py DEFAULT_FULL_BUCKETS[-1]
OVERFLOW_QUANTUM = 16_384                    # pctl/batching.py _OVERFLOW_QUANTUM


def production_tile(n_points: int, extent: int) -> str:
    """The cached tile of ``write_production_tile`` (written to a temporary
    name first, so a run cut while writing leaves no partial tile)."""
    from myria3d_tpu_torch.pctl.dataset.synthetic_tile import write_production_tile

    path = os.path.join(TILE_DIR, f"production_{n_points}_{extent}m.las")
    if not os.path.isfile(path):
        os.makedirs(TILE_DIR, exist_ok=True)
        t0 = time.perf_counter()
        write_production_tile(path + ".tmp", n_points, extent)
        os.replace(path + ".tmp", path)
        print(f"phase 22 tile: {n_points} points over {extent} m written in "
              f"{time.perf_counter() - t0:.1f} s to {os.path.relpath(path, ROOT)}")
    return path


def tile_overrides(tile: str, extent: int, *extra: str) -> list:
    return ["task.task_name=predict", "experiment=predict", f"predict.src_las={tile}",
            f"predict.ckpt_path={ASSETS}", "datamodule.epsg=2154",
            f"datamodule.tile_width={extent}", *extra]


def predict_tile(tile: str, extent: int, label: str, *extra: str, phase: str = "22",
                 launched=("K1", "K2", "K3")) -> dict:
    """The CLI predicts ``tile`` (one subprocess, experiment=predict, batch
    48); its output LAS passes ``check_predicted_las``. Prints the wall
    clock, predict()'s line and phases, Mpts/s, the launches, the peak
    device memory and the host's cores."""
    from myria3d_tpu_torch.pctl.io.las import read_las, read_las_header
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config

    n_points = read_las_header(tile).point_count
    with tempfile.TemporaryDirectory(prefix="m3d_tile_") as cwd:
        argv = tile_overrides(tile, extent, f"predict.output_dir={cwd}/out",
                              f"hydra.run.dir={cwd}/run", *extra)
        run = run_cli(argv, cwd, cli_env(cwd), timeout=900, launched=launched)
        need(len(run["phases"]) == 1, f"{len(run['phases'])} phases dicts for one tile")
        out = os.path.join(cwd, "out", os.path.basename(tile))
        t0 = time.perf_counter()
        covered = check_predicted_las(read_las(out).points, n_points,
                                      compose_config(CONFIG_DIR, "config.yaml", argv))
        dt_check = time.perf_counter() - t0
    phases = run["phases"][0]
    line = [v for v in run["lines"] if v.startswith("predict phases:")]
    need(len(line) == 1, "predict() logged no line of phases")
    print(f"phase {phase}{label} CLI predict of {n_points} points ({' '.join(extra) or 'overlap 0'}): "
          f"{run['s']:.2f} s wall, {n_points / run['s'] / 1e6:.3f} Mpts/s, "
          f"{phases['n_batches']} batches [{CARD}]")
    print(f"phase {phase}{label} {line[0]}")
    print(f"phase {phase}{label} phases {json.dumps(phases)}; finalize+write "
          f"{run['finalize_s'][0]:.3f} s on the wrapper's clock")
    print(f"phase {phase}{label} launches {run['launches']}, peak device memory "
          f"{run['peak_gib']:.3f} GiB, host cores {os.cpu_count()}; output LAS checked in "
          f"{dt_check:.1f} s, covered {covered:.4f}")
    return {"s": run["s"], "phases": phases, "launches": run["launches"]}


def tile_batches(tile: str, extent: int, n_batches: int) -> list:
    """The tile's batches as ``predict()`` makes them (``tile_loader``: the
    predict transforms with SortPointsByX, ``_buckets``, batch 48): prints
    the (B, N_pad, M_pad) histogram, which must count ``n_batches``, and
    returns the first batch at each distinct (N_pad, M_pad), at most
    ``HELD_BUCKETS``: the step's arrays, then the subtiles' indices into
    the tile."""
    from collections import Counter

    from myria3d_tpu_torch.pctl.batching import pad_full_cloud, pad_sampled_pos
    from myria3d_tpu_torch.pctl.dataset.utils import read_las_array
    from myria3d_tpu_torch.predict import tile_loader
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config

    cfg = compose_config(CONFIG_DIR, "config.yaml", tile_overrides(tile, extent))
    t0 = time.perf_counter()
    points, _ = read_las_array(tile, "2154")
    hist, picks = Counter(), {}
    for batch in tile_loader(cfg, points):
        full = pad_full_cloud(batch.copies)
        sampled_pos = pad_sampled_pos(batch.copies, batch.num_points)
        if full is None or sampled_pos is None:
            continue          # predict() skips these too
        shape = (batch.x.shape[0], batch.x.shape[1], full["full_pos"].shape[1])
        hist[shape] += 1
        if shape[1:] not in picks and len(picks) < HELD_BUCKETS:
            picks[shape[1:]] = (batch.x, batch.pos, batch.mask, sampled_pos, full["full_pos"],
                                full["full_mask"], batch.idx_in_original_cloud)
    dt = time.perf_counter() - t0
    need(sum(hist.values()) == n_batches,
         f"the loader made {sum(hist.values())} batches, predict() {n_batches}")
    print(f"phase 22 batches (B, N_pad, M_pad): "
          f"{ {str(k): v for k, v in sorted(hist.items())} } ({dt:.1f} s to read and cook); "
          f"{len(picks)} of {len({k[1:] for k in hist})} buckets held")
    return list(picks.values())


def hold_tile_batch(model, dev, arrays, label: str) -> tuple:
    """``Model.interp_step`` on one of the tile's batches, on the kernels
    and on their plain versions from the same generator seed: argmax
    agreement >= 0.999 over the valid full points. Returns the kernels'
    logits."""
    import torch

    *tensors, _ = arrays
    x, pos, mask, sampled_pos, full_pos, full_mask = (torch.from_numpy(a).to(dev)
                                                      for a in tensors)

    def step():
        gen = torch.Generator(device=dev).manual_seed(TILE_SEED)
        out = model.interp_step(x, pos, mask, sampled_pos, full_pos, full_mask, gen)
        torch.cuda.synchronize()
        return out

    counters = {k: v for k, v in launch_counters().items() if k in ("K1", "K2", "K3")}
    start = {k: fn.launches for k, fn in counters.items()}
    step()
    t0 = time.perf_counter()
    out_k = step()
    ms = (time.perf_counter() - t0) * 1e3
    launched = {k: (fn.launches - start[k]) // 2 for k, fn in counters.items()}
    need(all(v > 0 for v in launched.values()), f"kernels not launched: {launched}")
    with plain_versions():
        t0 = time.perf_counter()
        out_p = step()
        plain_ms = (time.perf_counter() - t0) * 1e3
    b, n_pad, m_pad = x.shape[0], x.shape[1], full_pos.shape[1]
    need(bool(torch.isfinite(out_k).all()) and out_k.shape == (b, m_pad, 7), "bad step output")
    agree = float((out_k.argmax(-1) == out_p.argmax(-1))[full_mask].float().mean())
    need(agree >= 0.999, f"argmax agreement {agree:.5f} < 0.999")
    n_full = int(full_mask.sum())
    print(f"phase 22{label} step B={b} N_pad={n_pad} (largest cloud {int(mask.sum(1).max())}) "
          f"M_pad={m_pad}: "
          f"kernels {ms:.1f} ms ({n_full / ms / 1e3:.3f} Mpts/s), plain {plain_ms:.1f} ms, "
          f"argmax agreement {agree:.6f}, launches a step {launched} [{CARD}]")
    return out_k


def merge_ms(logits, idx_list: list, n_points: int) -> str:
    """The Interpolator's merge of one batch into a (tile, C) plane whose
    pages are touched first, the subtiles' indices in the x order that
    SortPointsByX leaves them in: a subtile at a time through ``np.add.at``,
    then the whole batch through the one native call that
    ``Interpolator.store_predictions`` makes; the two planes bit-equal."""
    from myria3d_tpu_torch.pctl.native import native_scatter_add_rows

    planes = [np.ones((n_points, logits.shape[-1]), np.float32) for _ in range(2)]
    rows = [(i, np.asarray(idx, np.int64)) for i, idx in enumerate(idx_list) if idx is not None]
    t0 = time.perf_counter()
    for i, idx in rows:
        np.add.at(planes[0], idx, logits[i, :len(idx)])
    add_at_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    native_scatter_add_rows(planes[1], [idx for _, idx in rows],
                            [np.ascontiguousarray(logits[i, :len(idx)]) for i, idx in rows])
    native_ms = (time.perf_counter() - t0) * 1e3
    need(np.array_equal(*planes), "the native scatter's plane differs from np.add.at's")
    return (f"x order np.add.at {add_at_ms:.1f} ms, native batch scatter {native_ms:.1f} ms "
            f"(bit-equal), for {sum(len(i) for _, i in rows)} rows")


def phase_tile(dev) -> dict:
    """Phase 22: (a) the CLI predicts bench_e2e.py's 17.18 M-point 1 km²
    tile; (b) ``Model.interp_step`` on the first batch at each of its
    buckets against the plain path; (c) a dense crop whose batch pads to
    N=40064 and a full bucket past 131072, held the same way and predicted;
    (d) the crop predicted again with ``predict.subtile_overlap=25``.
    Returns the K1/K2/K3 launches of (a), (c) and (d)'s predicts."""
    import torch

    from myria3d_tpu_torch.utils.checkpoint import load_checkpoint

    tile = production_tile(TILE_POINTS, TILE_EXTENT)
    full = predict_tile(tile, TILE_EXTENT, "a")
    launches = dict(full["launches"])
    model = load_checkpoint(ASSETS, dev)
    model.set_sorted_window(WINDOW)
    with torch.inference_mode():
        for i, arrays in enumerate(tile_batches(tile, TILE_EXTENT, full["phases"]["n_batches"])):
            logits = hold_tile_batch(model, dev, arrays, "b")
            if i == 0:
                print(f"phase 22b merge of one batch on the host: "
                      f"{merge_ms(logits.cpu().numpy(), arrays[-1], TILE_POINTS)}")

        crop = production_tile(CROP_POINTS, CROP_EXTENT)
        print(f"phase 22c dense crop: {CROP_POINTS} points over {CROP_EXTENT} m "
              f"({CROP_POINTS / CROP_EXTENT ** 2:.0f} points/m²)")
        arrays = tile_batches(crop, CROP_EXTENT, 1)
        need(len(arrays) == 1, f"the crop met {len(arrays)} buckets")
        largest = int(arrays[0][2].sum(1).max())
        need(largest >= 40_000, f"no crop subtile reached MaximumNumNodes: {largest} sampled "
             f"points at most")
        logits = hold_tile_batch(model, dev, arrays[0], "c")
        n_pad, m_pad = arrays[0][0].shape[1], logits.shape[1]
        need(n_pad == SAMPLED_CAP and m_pad > FULL_LADDER_TOP
             and (m_pad - FULL_LADDER_TOP) % OVERFLOW_QUANTUM == 0,
             f"the crop's batch pads to N={n_pad}, M={m_pad}")
    del model
    crop_run = predict_tile(crop, CROP_EXTENT, "c")
    overlap_run = predict_tile(crop, CROP_EXTENT, "d", "predict.subtile_overlap=25")
    print(f"phase 22d subtile_overlap=25: {overlap_run['s']:.2f} s wall against overlap 0's "
          f"{crop_run['s']:.2f} s ({overlap_run['s'] / crop_run['s']:.2f}x), "
          f"{overlap_run['phases']['n_batches']} batches against "
          f"{crop_run['phases']['n_batches']} [{CARD}]")
    for run in (crop_run, overlap_run):
        for k, v in run["launches"].items():
            launches[k] += v
    return launches


def phase_pt3_tile(dev) -> None:
    """Phase 24: Point Transformer V3 predicts phase 22's tile through the
    CLI, from a checkpoint of its published net (default initialisation,
    seeded)."""
    import torch

    from myria3d_tpu_torch.models.model import build_model
    from myria3d_tpu_torch.run import CONFIG_DIR, compose_config

    tile = production_tile(TILE_POINTS, TILE_EXTENT)
    mcfg = compose_config(CONFIG_DIR, "config.yaml", ["model=point_transformer_v3_model"])["model"]
    torch.manual_seed(TILE_SEED)
    model = build_model(mcfg["neural_net_class_name"], mcfg["neural_net_hparams"],
                        interpolation_k=mcfg["interpolation_k"], d_in=mcfg["d_in"],
                        num_classes=mcfg["num_classes"],
                        classification_dict=mcfg["classification_dict"])
    with tempfile.TemporaryDirectory(prefix="m3d_pt3_") as ckpt:
        model.save_checkpoint(ckpt)
        # the net runs no K1 or K2: K3 interpolates its logits
        run = predict_tile(tile, TILE_EXTENT, "", f"predict.ckpt_path={ckpt}", phase="24",
                           launched=("K3",))
    counts = {k: v for k, v in run["phases"].items() if k.startswith("pt3_")}
    need(counts.get("pt3_points.0", 0) > 0, "the CLI's phases hold no pt3_* counters")
    print(f"phase 24 counters {json.dumps(counts)} [{CARD}]")


# ---------------------------------------------------------------------------
# phase 23: K9, Point Transformer's vector attention at eval
# ---------------------------------------------------------------------------

# the published net (perfbench/configs/point_transformer.json) and the
# predict step's sampled points a subtile (perfbench/traffic/subtile_predict.json)
PT_HPARAMS = {"num_features": 9, "num_classes": 7, "planes": [32, 64, 128, 256, 512],
              "blocks": [2, 3, 4, 6, 3], "nsample": [8, 16, 16, 16, 16],
              "stride": [1, 4, 4, 4, 4], "share_planes": 8}
PT_N = 16_384


def pt_clouds(dev, n: int, real, seed: int):
    """(pos, mask): B clouds of ``n`` slots, positions uniform in the net's
    normalized units (x, y in [-1, 1], z in [-0.2, 0.2]), the first
    ``real[b]`` slots of cloud b real."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pos = (torch.rand((B, n, 3), generator=g) * 2 - 1) * torch.tensor([1.0, 1.0, 0.2])
    mask = torch.arange(n)[None, :] < torch.as_tensor(real)[:, None]
    return pos.to(dev), mask.to(dev)


def pt_layer(c: int, dev, seed: int):
    """A ``VectorAttention(c, 8)`` at eval, random weights and BatchNorm
    statistics away from the identity."""
    import torch

    from myria3d_tpu_torch.models.modules.point_transformer import VectorAttention

    torch.manual_seed(seed)
    layer = VectorAttention(c, PT_HPARAMS["share_planes"])
    with torch.no_grad():
        for bn in layer.norms:
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0.0, 0.2)
            bn.running_mean.normal_(0.0, 0.5)
            bn.running_var.uniform_(0.5, 2.0)
    return layer.to(dev).eval()


def phase_k9(dev):
    """23: (a) K9 against its plain version at the predict step's stages
    (B=48, N = 16384 -> 4096 -> 1024 -> 256 -> 64, each cloud's first 85-100 %
    of the slots real, the stage's K1 self graph): bit-equal, pad queries 0,
    timed beside the plain version; each stage's row counts its layers
    (blocks 2/3/4/6/3), so that the kernels line's K9 entry sums one step's
    18 layers, with the bytes of the attention reader's floor (q, k, v, y,
    the int32 index and the positions once at real points) as ``bound_ms``;
    (b) the net's eval forward at B=48, N=16384: K9's launches a step (18),
    ms a step, and its logits bit-equal to the same net's with K9's plain
    version in its place. The layers and the net are built outside
    inference mode, as predict builds them, so that K9's parameters are
    prepared once per layer."""
    import torch

    from myria3d_tpu_torch.models.model import build_model
    from myria3d_tpu_torch.models.modules import point_transformer
    from myria3d_tpu_torch.models.modules.point_transformer import stage_graph
    from myria3d_tpu_torch.ops.cuda_vector_attention import (
        vector_attention,
        vector_attention_plain,
    )

    rng = np.random.default_rng(23)
    real = rng.integers(int(0.85 * PT_N), PT_N + 1, B)
    stats, n = [], PT_N
    for i, (c, k, blocks) in enumerate(zip(PT_HPARAMS["planes"], PT_HPARAMS["nsample"],
                                           PT_HPARAMS["blocks"])):
        layer = pt_layer(c, dev, seed=c)
        p, packed = layer.kernel_params()
        pos, mask = pt_clouds(dev, n, real // 4 ** i, seed=i)
        x = torch.randn((B, n, c), generator=torch.Generator().manual_seed(c)).to(dev)
        with torch.inference_mode():
            g = stage_graph(pos, mask, k)
            args = (layer.linear_q(x), layer.linear_k(x), layer.linear_v(x), g.idx, g.valid,
                    g.rel)
            got = vector_attention(*args, p, packed)
            want = vector_attention_plain(*args, p)
        need(bool(torch.equal(got, want)), f"K9 C={c} K={k} N={n}: max |kernel - plain| "
             f"{float((got - want).abs().max()):.3g}, not bit-equal")
        need(not bool(got[~mask].any()), f"K9 C={c} N={n}: a pad query's output is not 0")
        with torch.inference_mode():
            ms = cuda_ms(lambda: vector_attention(*args, p, packed), 5)
            plain_ms = cuda_ms(lambda: vector_attention_plain(*args, p), 2)
        m = float(mask.sum())
        bnd = bound(0.0, m * (4 * c * 4 + k * 4 + 3 * 4))
        stats.append((0.0, blocks * ms, blocks * plain_ms, (blocks * bnd[0], bnd[1]), None))
        print(f"phase 23a K9 C={c} K={k} B={B} N={n} ({int(m)} real): bit-equal, {ms:.3f} ms a "
              f"layer, plain {plain_ms:.3f} ms, bound_ms {bnd[0]:.4f} (bytes); x{blocks} layers "
              f"[{CARD}]")
        del g, x, args, got, want
        n //= 4

    torch.manual_seed(0)
    model = build_model("PointTransformerSeg", dict(PT_HPARAMS)).to(dev).eval()
    pos, mask = pt_clouds(dev, PT_N, real, seed=5)
    x = torch.rand((B, PT_N, 9), generator=torch.Generator().manual_seed(5)).to(dev)
    before = vector_attention.launches
    with torch.inference_mode():
        logits = model.net(x, pos, mask)
        ms = cuda_ms(lambda: model.net(x, pos, mask), 3)
    launches = vector_attention.launches - before
    need(launches == 18 * 5, f"K9 launched {launches} times in 5 eval forwards, not 18 each")

    def plain(*a, packed=None):
        return vector_attention_plain(*a[:7])

    point_transformer.vector_attention = plain
    try:
        with torch.inference_mode():
            want = model.net(x, pos, mask)
            plain_ms = cuda_ms(lambda: model.net(x, pos, mask), 1)
    finally:
        point_transformer.vector_attention = vector_attention
    need(vector_attention.launches - before == launches, "the plain route launched K9")
    need(bool(torch.equal(logits, want)), f"PointTransformerSeg eval logits with K9: max |diff| "
         f"{float((logits - want).abs().max()):.3g} from K9's plain version in its place")
    print(f"phase 23b PointTransformerSeg eval forward B={B} N={PT_N}: {ms:.1f} ms a step with "
          f"K9 (18 launches a step), {plain_ms:.1f} ms with its plain version, logits bit-equal "
          f"[{CARD}]")
    return stats, launches


# each kernel's source and the TPU kernel it replaces
SOURCES = {"K1": ("myria3d_tpu_torch/csrc/knn.cu", "myria3d_tpu/ops/pallas_knn.py:238"),
           "K1_full": ("myria3d_tpu_torch/csrc/knn.cu", "myria3d_tpu/ops/pallas_knn.py:150"),
           "K1_ball": ("myria3d_tpu_torch/csrc/knn.cu", "myria3d_tpu/ops/pallas_knn.py:150"),
           "K1_small": ("myria3d_tpu_torch/csrc/knn.cu", "myria3d_tpu/ops/pallas_knn.py:150"),
           "K2": ("myria3d_tpu_torch/csrc/lfa.cu", "myria3d_tpu/ops/pallas_lfa.py:106"),
           "K2_16": ("myria3d_tpu_torch/csrc/lfa.cu", "myria3d_tpu/ops/pallas_lfa.py:106"),
           "K3": ("myria3d_tpu_torch/csrc/interp.cu", "myria3d_tpu/ops/pallas_knn.py:475"),
           "K4": ("myria3d_tpu_torch/csrc/gather_bwd.cu", "myria3d_tpu/ops/pallas_gather.py:65"),
           "K5": ("myria3d_tpu_torch/csrc/lfa_train.cu",
                  "myria3d_tpu/ops/pallas_lfa_train.py:162"),
           "K6": ("myria3d_tpu_torch/csrc/lfa_train.cu",
                  "myria3d_tpu/ops/pallas_lfa_train.py:192"),
           "K7": ("myria3d_tpu_torch/csrc/knn.cu", "myria3d_tpu/ops/pallas_knn.py:115"),
           "K8": ("myria3d_tpu_torch/csrc/fps.cu", "myria3d_tpu/ops/fps.py:25"),
           # no TPU kernel: the JAX package has no Point Transformer
           "K9": ("myria3d_tpu_torch/csrc/vector_attention.cu", None)}


def kernel_entries(stats: dict, launches: dict, sources: dict) -> list:
    """The kernels line: each kernel's launches, its largest error against
    its plain version, and its rows' ms, plain ms and bounds summed."""
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
    return kernels


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
    global CARD
    if sys.argv[1:] == ["--phase", "22"]:
        # phase 22 alone, after the card and the build: no kernels line, no
        # device line
        try:
            CARD = phase_device()
            phase_build()
            phase_tile(dev)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            print("FAIL")
            return 1
        return 0
    if sys.argv[1:] == ["--phase", "24"]:
        # phase 24 alone, after the card and the build
        try:
            CARD = phase_device()
            phase_build()
            phase_pt3_tile(dev)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            print("FAIL")
            return 1
        return 0
    if sys.argv[1:] == ["--phase", "23"]:
        # phase 23 alone, after the card and the build: the kernels line
        # holds K9 alone; no device line
        try:
            CARD = phase_device()
            phase_build()
            k9_stats, k9_launches = phase_k9(dev)
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            print("FAIL")
            return 1
        print(json.dumps({"kernels": kernel_entries({"K9": k9_stats}, {"K9": k9_launches},
                                                    {"K9": SOURCES["K9"]})}))
        return 0
    try:
        CARD = phase_device()
        phase_build()
        model = load_checkpoint(ASSETS, dev)
        with torch.inference_mode():
            stats = phase_kernels(model, dev)
        launches, main_acc = phase_main_path(dev)
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
            phase_finetune(dev, work, runs[-1][1])
            phase_lr_range(dev, runs[-1][0])
            phase_microbatch(dev)
            phase_profiler(dev, work)
            phase_data_parallel(dev, work)
            phase_pn2_data_parallel(dev, work)
            with torch.inference_mode():
                stats["K8"] = phase_fps(dev)
                stats.update(phase_pn2_searches(dev))
                pn2 = phase_pn2_predict_step(dev)
            pn2_train = phase_pn2_train_step(dev)
            phase_pn2_fit(dev, work)
            # K8's and K1's PointNet++ routes' launches: the PointNet++
            # predict and train steps' runs
            for name in ("K8", "K1_ball", "K1_small"):
                launches[name] = pn2[name] + pn2_train[name]
            phase_parity(dev, work)
            model = load_checkpoint(ASSETS, dev)
            stats["K2_16"], dtype_launches = phase_compute_dtype(model, dev, work)
            launches["K2_16"] = dtype_launches["K2_16"]
            del model
            phase_log_probs_and_remat(dev, work)
            stats["K1_full"], exact_launches = phase_exact_knn(dev, work)
            launches["K1_full"] = exact_launches["K1"]
            for name in ("K2", "K3", "K4"):
                launches[name] += exact_launches.get(name, 0)
        phase_cli(main_acc)
        for name, count in phase_tile(dev).items():
            launches[name] += count
        stats["K9"], launches["K9"] = phase_k9(dev)
        phase_pt3_tile(dev)
    except Exception:  # noqa: BLE001 - every phase failure ends the run
        traceback.print_exc()
        print("FAIL")
        return 1
    foreign = foreign_modules()
    if foreign:
        print(f"FAIL: modules of JAX or of the JAX package were loaded: {foreign}")
        return 1
    print(json.dumps({"kernels": kernel_entries(stats, launches, SOURCES)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
