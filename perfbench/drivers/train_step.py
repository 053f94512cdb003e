"""The train step in a closed loop: ``Model.train_step`` (forward, backward
and the Adam update) on device-resident batches with seeded labels.

Set-up builds one model and its optimizer state from the seeded weights and
drives it through ``warmup_steps`` steps, rotating batches whose rows all
differ, through the same call the window makes. That same object then runs
the window, rotating the batches, for ``--seconds`` and at least until the
checked window steps have run; the rate is every real sampled point of
every step over the whole window.

Two runs of three steps are checked. The first three set-up steps start
from the harness's weights and a fresh optimizer. Three window steps start
at a step drawn from the seed below ``checked_within``: before it the
window copies the parameters, Adam's moments and step count and the
generator's state, without waiting for the device. Of each run the program
keeps the loss of each step, the first step's gradient as Adam takes it
(its first moment after the step less ``beta1`` times the one before, over
``1 - beta1``) and the parameters after the third step. Once the window has
closed and the model is freed, the reference makes the same three steps
from the same start (the harness's weights, or the program's copied state),
batches and generator state (decimations and dropout drawn in the same
order), with a plain Adam; each number is the worse of the two runs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import compare, gen, weights
from perfbench.drivers.common import Ctx, build_program_model, tf32

CHECKED_STEPS = 3


def _is_param(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def cross_entropy(logits, y, num_classes: int, ignore: int = 65):
    counted = (y != ignore) & (y >= 0) & (y < num_classes)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(counted, y, 0)[..., None])[..., 0]
    w = counted.float()
    return (nll * w).sum() / w.sum().clamp(min=1e-12)


def fresh_start(w: dict) -> dict:
    """The start of a fresh model: the harness's weights, Adam at step 0."""
    names = [n for n in w if _is_param(n)]
    return {"params": {n: w[n] for n in names}, "m": {n: torch.zeros_like(w[n]) for n in names},
            "v": {n: torch.zeros_like(w[n]) for n in names}, "t": 0}


def snapshot(model) -> dict:
    """Copies of the program's parameters, Adam's moments and step count,
    enqueued on the device's stream (nothing waits)."""
    out = {"params": {}, "m": {}, "v": {}, "t": 0}
    for n, p in model.net.named_parameters():
        st = model.optimizer.state.get(p)
        out["params"][n] = p.detach().clone()
        out["m"][n] = st["exp_avg"].clone() if st else torch.zeros_like(p)
        out["v"][n] = st["exp_avg_sq"].clone() if st else torch.zeros_like(p)
        if st:
            out["t"] = st["step"].clone()
    return out


class Checked:
    """The program's side of one checked run of three steps: its start,
    the losses, the first moment after the first step and the parameters
    after the last, all kept on the device until :meth:`readings`."""

    def __init__(self, model, batches: list, generator):
        self.model, self.batches = model, batches
        self.gen_state = generator.get_state()
        self.start = snapshot(model)
        self.losses, self.m1, self.after = [], None, None

    def took(self, loss) -> None:
        """After each of the three steps, with its loss."""
        self.losses.append(loss)
        if len(self.losses) == 1:
            self.m1 = {n: self.model.optimizer.state[p]["exp_avg"].clone()
                       for n, p in self.model.net.named_parameters()}
        if len(self.losses) == CHECKED_STEPS:
            self.after = {n: p.detach().clone() for n, p in self.model.net.named_parameters()}
            self.model = None

    def program(self, b1: float) -> dict:
        return {"losses": [float(x) for x in self.losses],
                "grad": {n: (m - b1 * self.start["m"][n]) / (1.0 - b1) for n, m in self.m1.items()},
                "change": {n: p - self.start["params"][n] for n, p in self.after.items()}}


def reference_steps(ctx: Ctx, w: dict, start: dict, batches: list, gen_state,
                    lower: bool = False) -> dict:
    """The reference's three steps from ``start``: losses, first gradient,
    change."""
    tf32(lower)
    cfg, opt = ctx.config["neural_net_hparams"], ctx.config["optimizer"]
    P = {k: v.clone() for k, v in {**w, **start["params"]}.items()}
    names = [n for n in P if _is_param(n)]
    for n in names:
        P[n].requires_grad_(True)
    net = ctx.reference.Net(P, cfg, train=True)
    if lower and ctx.device.type == "cpu":
        net.tf32 = True
    g = torch.Generator(device=ctx.device)
    g.set_state(gen_state)
    m = {n: start["m"][n].clone() for n in names}
    v = {n: start["v"][n].clone() for n in names}
    t0 = int(float(start["t"]))
    losses, first = [], None
    for t, b in enumerate(batches, start=t0 + 1):
        logits = net(b.x, b.pos, b.mask, g, sort=bool(cfg["sort_inputs"] and cfg["knn_window"]))
        loss = cross_entropy(logits, b.y, cfg["num_classes"])
        grads = torch.autograd.grad(loss, [P[n] for n in names])
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: gr.detach().clone() for n, gr in zip(names, grads)}
        with torch.no_grad():
            for n, gr in zip(names, grads):
                m[n].mul_(opt["b1"]).add_((1 - opt["b1"]) * gr)
                v[n].mul_(opt["b2"]).add_((1 - opt["b2"]) * gr * gr)
                m_hat = m[n] / (1 - opt["b1"] ** t)
                v_hat = v[n] / (1 - opt["b2"] ** t)
                P[n].sub_(ctx.config["lr"] * m_hat / (v_hat.sqrt() + opt["eps"]))
    tf32(False)
    return {"losses": losses, "grad": first,
            "change": {n: (P[n] - start["params"][n]).detach() for n in names}}


def _worst(a: dict, b: dict) -> dict:
    return {k: max(a[k], b[k]) for k in a}


def run(ctx: Ctx) -> dict:
    tr, cuda = ctx.traffic, ctx.device.type == "cuda"
    if tr["warmup_steps"] < CHECKED_STEPS:
        raise ValueError(f"warmup_steps {tr['warmup_steps']} holds fewer than the "
                         f"{CHECKED_STEPS} checked set-up steps")
    w = weights.make(ctx.reference.param_shapes(ctx.config["neural_net_hparams"]), ctx.seed,
                     ctx.device)
    g_data = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
    batches = [gen.subtile_batch(tr, tr["rows"], g_data, ctx.device)
               for _ in range(max(tr["distinct_batches"], CHECKED_STEPS))]
    ctx.mark("inputs")
    model = build_program_model(ctx, w)
    model.init_train_state()
    generator = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    nb = len(batches)

    def step(b):
        return model.train_step(b.x, b.pos, b.y, b.mask, generator)[0]

    def rows(first: int) -> list:
        return [batches[(first + j) % nb] for j in range(CHECKED_STEPS)]

    checks = [Checked(model, rows(0), generator)]
    for i in range(tr["warmup_steps"]):
        loss = step(batches[i % nb])
        if i < CHECKED_STEPS:
            checks[0].took(loss)
    ctx.sync()
    ctx.mark("warm-up")
    setup_s = ctx.since_start()

    first = int(np.random.default_rng(ctx.seed).integers(tr["checked_within"]))
    t0 = time.perf_counter()
    i = 0
    while True:
        if i == first:
            checks.append(Checked(model, rows(first), generator))
        loss = step(batches[i % nb])
        if first <= i < first + CHECKED_STEPS:
            checks[1].took(loss)
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds and i >= first + CHECKED_STEPS:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    steps = i
    points = sum(int(batches[j % nb].n_sampled.sum()) for j in range(steps))
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    record = {"kind": "train", "family": ctx.config["reference"],
              "cfg": ctx.config["neural_net_hparams"], "steps": steps, "window_s": window_s,
              "batches": [(b.n_sampled, b.n_full, b.x.shape[1]) for b in batches]}
    trace = None
    if ctx.trace:
        from perfbench.devtrace import profiled

        ctx.sync()
        t1 = time.perf_counter()
        for j in range(3):
            step(batches[j % nb])
        record["enqueue_ms"] = (time.perf_counter() - t1) * 1e3 / 3
        ctx.sync()
        trace = profiled(lambda: [step(batches[j % nb]) for j in range(tr["trace_steps"])],
                         ctx.sync, on_cpu=not cuda)
        record["trace"] = trace

    b1 = model.optimizer.param_groups[0]["betas"][0]
    progs = [c.program(b1) for c in checks]
    del model, step
    if cuda:
        torch.cuda.empty_cache()
    readings, lower = None, {}
    for c, prog in zip(checks, progs):
        start = fresh_start(w) if c is checks[0] else c.start
        ref = reference_steps(ctx, w, start, c.batches, c.gen_state)
        got = compare.train(prog, ref)
        readings = got if readings is None else _worst(readings, got)
        if ctx.control:
            got = compare.train(reference_steps(ctx, w, start, c.batches, c.gen_state, lower=True),
                                ref)
            lower = got if not lower else _worst(lower, got)
    e2e = {"train_mpts_per_s": points / window_s / 1e6, "setup_s": setup_s}
    return {"e2e": e2e, "record": record, "readings": readings, "attempted": steps,
            "memory_peak_bytes": peak, "trace": trace, "control_readings": lower}
