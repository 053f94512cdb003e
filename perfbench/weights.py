"""Seeded weights, made on the device in one draw.

Every parameter and BatchNorm statistic of a configuration comes from one
``torch.rand`` of their total size on a ``torch.Generator`` seeded with the
run's seed, then sliced and scaled by kind: Linear weights uniform with the
variance LeakyReLU stacks keep (``2 / fan_in``), biases within 0.1,
BatchNorm scales 1 +- 0.2, shifts and running means within 0.1, running
variances in [0.5, 1.5], so that eval BatchNorm is not the identity. The
classifier (``fc_classif``) is a tenth of that, so that the logits are of
order 1: with larger ones the probabilities a tile's output holds saturate
at 0 and 1, and a difference in the logits no longer shows in them.
"""

from __future__ import annotations

import math

import torch


def make(shapes: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}`` for ``shapes`` (``{name: shape}``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0   # U(-1, 1)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        u = flat[at:at + size].view(shape)
        at += size
        leaf = name.rsplit(".", 1)[-1]
        if ".norms." in name:
            t = {"weight": 1.0 + 0.2 * u, "bias": 0.1 * u, "running_mean": 0.1 * u,
                 "running_var": 1.0 + 0.5 * u}[leaf]
        elif leaf == "weight":
            t = u * math.sqrt(6.0 / shape[1])
        else:
            t = 0.1 * u
        if name.startswith("fc_classif."):
            t = 0.1 * t
        out[name] = t.contiguous()
    return out
