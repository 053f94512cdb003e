"""Point Transformer's model FLOPs and least K1 bytes, under the rules of
:mod:`perfbench.yardstick` (its peaks, its ``search_bytes``).

- Model FLOPs count the dense products the architecture defines, ``2 *
  in * out`` per real point or per valid neighbour slot, at the real counts
  of each stage: every stage keeps ``n // stride`` real points of the
  stage before (the public code's count). Per point: the first transition
  down, each block's ``linear1``, ``q``, ``k``, ``v`` and ``linear3``, the
  transitions up and the classifier; the head's Linear on the cloud's mean
  once a cloud. Per valid slot of a stage's graph, in each of its layers:
  the position encoding (3 -> 3 -> C) and the weight MLP (C -> C/s ->
  C/s); per valid slot of a centroid's search, the transition down's
  Linear on ``[p_j - c | x_j]``. The softmax, the sums and the weighting
  are not products and count nothing.
- K1 searches: each stage's self graph (``min(nsample, m)`` slots a real
  query), each centroid search into the stage before and each transition
  up's 3-NN list, positions read and lists written once
  (``yardstick.search_bytes``).

``slots`` is what the reference counts (``reference/point_transformer.py``):
``{"graph": [...], "down": [...], "up": [...]}``, each a batch's total.
"""

from __future__ import annotations

from perfbench.yardstick import search_bytes


def stages(cfg: dict, n: int) -> list:
    """Real points of each stage of one cloud of ``n`` real points."""
    out = [int(n)]
    for s in cfg["stride"][1:]:
        out.append(out[-1] // s)
    return out


def point_flops(cfg: dict, n: int) -> float:
    """The per-point products of one cloud of ``n`` real points."""
    planes, blocks = cfg["planes"], cfg["blocks"]
    ns = stages(cfg, n)
    c_in = cfg["num_features"]
    total = 0
    for i, c in enumerate(planes):
        if cfg["stride"][i] == 1:
            total += 2 * c_in * c * ns[i]
        # blocks - 1 encoder blocks and the decoder's one
        total += blocks[i] * 2 * ns[i] * 5 * c * c
        c_in = c
    top = planes[-1]
    total += 2 * 2 * top * top * ns[-1] + (2 * top * top if ns[-1] else 0)
    for i in range(len(planes) - 1):
        total += 2 * planes[i] * planes[i] * ns[i] + 2 * planes[i + 1] * planes[i] * ns[i + 1]
    total += 2 * ns[0] * planes[0] * (planes[0] + cfg["num_classes"])
    return float(total)


def slot_flops(cfg: dict, slots: dict) -> float:
    """The per-slot products of a batch whose searches have ``slots``."""
    planes, s = cfg["planes"], cfg["share_planes"]
    total = 0
    for i, c in enumerate(planes):
        per_slot = 3 * 3 + 3 * c + c * (c // s) + (c // s) ** 2
        total += cfg["blocks"][i] * 2 * per_slot * slots["graph"][i]
    downs = iter(slots["down"])
    for i in range(1, len(planes)):
        if cfg["stride"][i] > 1:
            total += 2 * (3 + planes[i - 1]) * planes[i] * next(downs)
    return float(total)


def k1_bytes(cfg: dict, n: int) -> float:
    """Least bytes of the K1 searches of one cloud of ``n`` real points."""
    ns, ks = stages(cfg, n), cfg["nsample"]
    total = sum(search_bytes(m, m, min(k, m)) for m, k in zip(ns, ks))
    total += sum(search_bytes(ns[i], ns[i - 1], min(ks[i], ns[i - 1]))
                 for i in range(1, len(ns)) if cfg["stride"][i] > 1)
    return total + sum(search_bytes(ns[i], ns[i + 1], min(3, ns[i + 1]))
                       for i in range(len(ns) - 1))
