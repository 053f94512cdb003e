"""The predict step in a closed loop: ``Model.interp_step`` on device-resident
batches at the tile's bucket, each step's float16 full-cloud logits copied
to pinned host memory without blocking, as ``predict()`` does (batch i's
copy is waited for once batch i+1 is queued).

Set-up makes the seeded weights and the traffic's distinct batches, builds
the program's model and runs ``warmup_steps`` steps (every shape the window
uses). The window runs steps, rotating the batches, until ``--seconds``
have passed and every step kept for the check has run; its rate is every
real full-cloud point of every step over the whole window.

The check: one step of each distinct batch, at an index drawn from the
seed, keeps its logits and the generator's state before it; once the
window has closed and the program's state is freed, the reference
recomputes those steps from the same inputs, weights and generator state.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from perfbench import compare, gen, weights
from perfbench.drivers.common import Ctx, build_program_model, tf32
from perfbench.reference import search


def _batches(ctx: Ctx) -> list:
    g = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
    return [gen.subtile_batch(ctx.traffic, ctx.traffic["rows"], g, ctx.device)
            for _ in range(ctx.traffic["distinct_batches"])]


def _kept_steps(ctx: Ctx) -> dict:
    """{step index: batch}: one step of each batch, within its first four
    turns after the first, drawn from the seed."""
    nb = ctx.traffic["distinct_batches"]
    turns = np.random.default_rng(ctx.seed).integers(1, 4, nb)
    return {int(b + nb * t): b for b, t in enumerate(turns)}


def reference_logits(ctx: Ctx, w: dict, batch, gen_state, lower: bool = False):
    """The reference's float32 full-cloud logits of one step (``lower``:
    with TF32 products, the control), and the valid neighbour slots of each
    set abstraction where the net has them (PointNet++), else None."""
    tf32(lower)
    g = torch.Generator(device=ctx.device)
    g.set_state(gen_state)
    # predict windows every search of the net by sorted_window (set_sorted_window)
    cfg = dict(ctx.config["neural_net_hparams"], knn_window=ctx.traffic["sorted_window"])
    net = ctx.reference.Net({k: v.clone() for k, v in w.items()}, cfg)
    if lower and ctx.device.type == "cpu":
        net.tf32 = True
    with torch.no_grad():
        logits = net(batch.x, batch.pos, batch.mask, g)
        window = search.stage_window(ctx.traffic["sorted_window"], batch.x.shape[1])
        full = search.interpolate(logits, batch.sampled_pos, batch.mask, batch.full_pos,
                                  batch.full_mask, ctx.config["interpolation_k"], window)
    tf32(False)
    return full, getattr(net, "slots", None)


def run(ctx: Ctx) -> dict:
    tr = ctx.traffic
    w = weights.make(ctx.reference.param_shapes(ctx.config["neural_net_hparams"]), ctx.seed,
                     ctx.device)
    batches = _batches(ctx)
    ctx.mark("inputs")
    model = build_program_model(ctx, w).eval()
    model.set_sorted_window(tr["sorted_window"])
    generator = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    cuda = ctx.device.type == "cuda"

    def step(b):
        return model.interp_step(b.x, b.pos, b.mask, b.sampled_pos, b.full_pos, b.full_mask,
                                 generator)

    for i in range(tr["warmup_steps"]):
        step(batches[i % len(batches)])
    ctx.sync()
    ctx.mark("warm-up")
    setup_s = ctx.since_start()

    keep = _kept_steps(ctx)
    states, kept = {}, {}
    pending: deque = deque()
    nb = len(batches)

    def drain():
        j, host, done = pending.popleft()
        if done is not None:
            done.synchronize()
        if j in keep:
            kept[j] = host

    t0 = time.perf_counter()
    i = 0
    while True:
        b = batches[i % nb]
        if i in keep:
            states[i] = generator.get_state()
        logits = step(b)
        if cuda:
            host = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
            host.copy_(logits, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = logits.clone(), None
        pending.append((i, host, done))
        i += 1
        if len(pending) > 1:
            drain()
        if time.perf_counter() - t0 >= ctx.seconds and i > max(keep):
            break
    while pending:
        drain()
    window_s = time.perf_counter() - t0
    steps = i
    points = sum(int(batches[j % nb].n_full.sum()) for j in range(steps))
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0

    record = {"kind": "predict", "family": ctx.config["reference"], "cfg": ctx.config["neural_net_hparams"],
              "interp_k": ctx.config["interpolation_k"], "steps": steps, "window_s": window_s,
              "batches": [(b.n_sampled, b.n_full, b.x.shape[1]) for b in batches]}
    trace = None
    if ctx.trace:
        from perfbench.devtrace import profiled

        n_trace = tr["trace_steps"]
        ctx.sync()
        t1 = time.perf_counter()
        for j in range(3):
            step(batches[j % nb])
        record["enqueue_ms"] = (time.perf_counter() - t1) * 1e3 / 3
        ctx.sync()
        trace = profiled(lambda: [step(batches[j % nb]) for j in range(n_trace)], ctx.sync,
                         on_cpu=not cuda)
        record["trace"] = trace
        record["trace_batches"] = [j % nb for j in range(n_trace)]

    del model
    if cuda:
        torch.cuda.empty_cache()
    readings, lower, slots = {}, {}, {}
    for j in sorted(kept):
        b = batches[keep[j]]
        ref, slots[keep[j]] = reference_logits(ctx, w, b, states[j])
        valid = b.full_mask.cpu().numpy()
        _worst(readings, compare.logits(kept[j].numpy(), ref.cpu().numpy(), valid))
        if ctx.control:
            control = reference_logits(ctx, w, b, states[j], lower=True)[0].half()
            _worst(lower, compare.logits(control.cpu().numpy(), ref.cpu().numpy(), valid))
    record["slots"] = slots
    e2e = {"predict_step_mpts_per_s": points / window_s / 1e6, "setup_s": setup_s}
    return {"e2e": e2e, "record": record, "readings": readings, "attempted": steps,
            "memory_peak_bytes": peak, "trace": trace, "control_readings": lower}


def _worst(into: dict, got: dict) -> None:
    for k, v in got.items():
        into[k] = max(into.get(k, 0.0), v)
