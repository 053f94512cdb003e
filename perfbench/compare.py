"""The numbers that decide ``correct``, and their limits.

Each cell's limits live in ``perfbench/limits/<workload>.json`` as
``{number: {"limit": value, ...}}``; a reading above its limit makes the run
not correct. How each limit was set (the program's readings over a dozen
seeds and more, and the lower-precision control's) is in PERF.md.

- Full-cloud logits (the predict steps): the program ships float16 logits.
  ``logit_mismatch_share`` is the share of real points' logits that differ
  from the float32 reference's rounded to float16 (float32 rounding moves
  a few across a float16 boundary; TF32 products move most);
  ``logit_gap_max`` the largest difference over the largest reference
  logit (a logit altered where it is produced).
- A predicted tile: ``proba_mismatch_share`` the share of compared points
  with a probability more than 1e-6, or the entropy more than 1e-5, from
  what the reference's logits give once rounded to float16 as the program
  ships them (float32's rounding stays under both; a logit a float16 step
  off does not); ``logit_gap_max`` the largest difference between the
  logits the written probabilities give (``log p`` less its mean over the
  classes) and the reference's, over the largest of those, as for the
  steps; ``class_mismatch_share`` the share whose PredictedClassification
  is not the reference's argmax where the reference's two best logits are
  more than 0.02 apart (an exact comparison).
- Training, for each checked run of three steps (the first set-up steps,
  and three window steps; the worse of the two counts): ``loss_gap_max``
  the largest relative gap of the three steps' losses;
  ``grad_norm_gap_max`` the largest gap over leaves between the program's
  first-gradient norm and the reference's, over the larger of that leaf's
  reference norm and the median leaf's; ``change_norm_gap_max`` the same
  for each leaf's change over the three steps, leaves whose reference
  gradient is under a thousandth of the median leaf's left out.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PROBA_TOL = 1e-6     # float32 rounding of a probability, many times over
ENTROPY_TOL = 1e-5   # float32 rounding of the entropy's sum of up to 7 terms of order 10
MARGIN = 0.02        # logits: over 5 float16 steps below 8, more than the wire's rounding moves


def limits(workload: str) -> dict:
    path = os.path.join(HERE, "limits", f"{workload}.json")
    with open(path) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def logits(prog: np.ndarray, ref: np.ndarray, valid: np.ndarray) -> dict:
    """``prog`` float16 and ``ref`` float32 (B, M, C) logits, ``valid``
    (B, M): the real points."""
    p = prog[valid].astype(np.float32)
    r = ref[valid].astype(np.float32)
    r16 = r.astype(np.float16).astype(np.float32)
    scale = max(float(np.abs(r).max()), 1e-30)
    return {"logit_mismatch_share": float((p != r16).mean()),
            "logit_gap_max": float(np.abs(p - r).max()) / scale}


def finalized(z16: np.ndarray, class_codes) -> dict:
    """What the program writes for float16-shipped logits ``z16`` (n, C):
    float32 probabilities, their entropy and the argmax's class code."""
    z = z16.astype(np.float32)
    e = np.exp(z - z.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    return {"probas": p, "entropy": -(p * np.log(np.maximum(p, 1e-30))).sum(axis=1),
            "classification": np.asarray(class_codes)[p.argmax(axis=1)]}


def tile(prog: dict, ref32: np.ndarray, class_codes) -> dict:
    """``prog``: the output's probabilities (n, C), entropy (n,) and
    PredictedClassification (n,) at the compared points; ``ref32``: the
    reference's float32 logits there."""
    want = finalized(ref32.astype(np.float16), class_codes)
    p = prog["probas"].astype(np.float64)
    off = (np.abs(p - want["probas"]).max(axis=1) > PROBA_TOL) | (
        np.abs(prog["entropy"].astype(np.float64) - want["entropy"]) > ENTROPY_TOL)
    # the logits up to a constant, from the written probabilities
    lp = np.log(np.maximum(p, 1e-38))
    got = lp - lp.mean(axis=1, keepdims=True)
    r = ref32.astype(np.float64) - ref32.mean(axis=1, keepdims=True)
    top2 = np.sort(ref32, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    wrong = (prog["classification"] != np.asarray(class_codes)[ref32.argmax(axis=1)]) & clear
    return {"proba_mismatch_share": float(off.mean()),
            "logit_gap_max": float(np.abs(got - r).max() / max(np.abs(r).max(), 1e-30)),
            "class_mismatch_share": float(wrong.mean())}


def _norm_gaps(prog: dict, ref: dict, keep=None) -> float:
    names = [n for n in ref if keep is None or n in keep]
    pn = {n: float(torch.linalg.vector_norm(prog[n].double())) for n in names}
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    median = float(np.median(list(rn.values())))
    return max(abs(pn[n] - rn[n]) / max(rn[n], median, 1e-30) for n in names)


def train(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``losses`` (3 floats), ``grad`` and ``change``
    (``{leaf: tensor}``)."""
    losses = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    gnorm = {n: float(torch.linalg.vector_norm(g.double())) for n, g in ref["grad"].items()}
    median = float(np.median(list(gnorm.values())))
    moving = {n for n, v in gnorm.items() if v >= 1e-3 * median}
    return {"loss_gap_max": losses,
            "grad_norm_gap_max": _norm_gaps(prog["grad"], ref["grad"]),
            "change_norm_gap_max": _norm_gaps(prog["change"], ref["change"], moving)}


def judge(readings: dict, lim: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every reading at or under its
    limit; a reading without a limit, or not a number, fails."""
    out, ok = {}, True
    for name, value in readings.items():
        limit = lim.get(name)
        out[name] = {"value": value, "limit": limit}
        if limit is None or not np.isfinite(value) or value > limit:
            ok = False
    return ok, out
