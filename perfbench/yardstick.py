"""The yardstick: the card's peaks, the model FLOPs of a step and the least
bytes and operations of a kernel call, all from shapes and real counts.

The counts are floors that any correct implementation has to meet, so a
faster correct one can never read above 100 %:

- model FLOPs count the dense products the architecture defines,
  ``2 * in * out`` per real point or per valid neighbour slot, at the real
  counts of each stage (a padded row costs nothing here). Folding
  BatchNorm, fusing passes or skipping pads leaves them as they are.
  Training counts the forward, the weight gradients and the input
  gradients that reach a weight (none for the first layer, none into the
  LocSE geometry).
- a search reads its queries' and keys' positions (float4 rows: x, y, z
  and the pad flag) once and writes each real query's list (int32 index
  and float32 squared distance a slot). No comparison is counted: a
  smarter search makes fewer.
- the interpolation adds the sampled logits it reads, the full-cloud
  logits it writes (float32) and the weighting's arithmetic (per slot a
  reciprocal and a multiply-add per class, per point a division per class).
"""

from __future__ import annotations

PEAKS = {
    # NVIDIA H100 SXM data sheet, dense, at the full 700 W limit
    "fp32_flops": 67e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "hbm_bytes": 3.35e12,
}
RANDLA_WIDTHS = (32, 128, 256, 512)


def decimated(n: int, decimation: int, stages: int) -> list:
    """Real points of each stage: each keeps max(1, n // decimation)."""
    out = [int(n)]
    for _ in range(stages):
        out.append(max(1, out[-1] // decimation) if out[-1] else 0)
    return out


def randla_flops(cfg: dict, n: int, train: bool = False) -> float:
    """Model FLOPs of RandLA-Net on one cloud of ``n`` real points."""
    k, f, c = cfg["num_neighbors"], cfg["num_features"], cfg["num_classes"]
    d_b = max(32, c, f)
    ns = decimated(n, cfg["decimation"], 4)
    ins = (d_b,) + RANDLA_WIDTHS
    first = 2 * f * d_b * ns[0]
    fwd, no_dx = first, first
    for i in range(4):
        d_in, d_out, m = ins[i], ins[i + 1], ns[i]
        slots = m * min(k, m)
        fwd += 2 * m * (d_in * d_out // 8 + d_in * d_out + (d_out // 2) * d_out)
        for ch in (d_out // 4, d_out // 2):
            enc = 2 * 10 * (ch // 2) * slots
            fwd += enc + 2 * ch * ch * slots + 2 * ch * ch * m
            no_dx += enc
    fwd += 2 * 512 * 512 * ns[4]
    decoder = ((768, 256), (384, 128), (160, 32), (64, d_b))
    for (a, b), m in zip(decoder, (ns[3], ns[2], ns[1], ns[0])):
        fwd += 2 * a * b * m
    fwd += 2 * ns[0] * (d_b * 64 + 64 * 32 + 32 * c)
    return float(3 * fwd - no_dx) if train else float(fwd)


def pointnet2_stages(cfg: dict, n: int, n_pad: int) -> list:
    """Real points of each stage of PointNet++: farthest-point sampling
    takes ``n_pad // decimation`` slots of a cloud padded to ``n_pad``,
    real as far as the cloud has points."""
    ns, pad = [int(n)], int(n_pad)
    for _ in cfg["radii"]:
        pad = max(1, pad // cfg["decimation"])
        ns.append(min(ns[-1], pad))
    return ns


def pointnet2_flops(cfg: dict, n: int, n_pad: int, slots: list) -> float:
    """Model FLOPs of PointNet++'s eval forward on one cloud of ``n`` real
    points padded to ``n_pad``, whose set abstractions group ``slots[i]``
    valid slots."""
    f, c, widths = cfg["num_features"], cfg["num_classes"], cfg["widths"]
    ns = pointnet2_stages(cfg, n, n_pad)
    ins = [32, *widths]
    total = 2 * f * 32 * ns[0]
    for i, w in enumerate(widths):
        total += 2 * slots[i] * ((ins[i] + 3) * (w // 2) + (w // 2) ** 2 + (w // 2) * w)
    width = ins[-1]
    for j, out in enumerate((256, 256, 128, 128)[:len(widths)]):
        skip = len(widths) - 1 - j
        total += 2 * (width + ins[skip]) * out * ns[skip]
        width = out
    total += 2 * ns[0] * (width * 128 + 128 * c)
    return float(total)


def search_bytes(queries: int, keys: int, k: int) -> float:
    """Least bytes of one search: float4 positions in, (index, d2) out."""
    return 16.0 * (queries + keys) + 8.0 * k * queries


def k1_bytes(family: str, cfg: dict, n: int, n_pad: int) -> float:
    """Least bytes of the K1 searches of one cloud's predict step."""
    if family == "randla_net":
        ns = decimated(n, cfg["decimation"], 4)
        total = sum(search_bytes(m, m, min(cfg["num_neighbors"], m)) for m in ns[:4])
        return total + sum(search_bytes(ns[i], ns[i + 1], 1) for i in range(4))
    ns = pointnet2_stages(cfg, n, n_pad)
    total = sum(search_bytes(ns[i + 1], ns[i], cfg["num_neighbors"]) for i in range(len(ns) - 1))
    return total + sum(search_bytes(ns[i], ns[i + 1], 3) for i in range(len(ns) - 1))


def k3_bound_s(n_keys: int, n_queries: int, k: int, classes: int) -> float:
    """Least seconds of one cloud's full-cloud interpolation."""
    n_bytes = 16.0 * (n_queries + n_keys) + 4.0 * classes * (n_keys + n_queries)
    ops = n_queries * (k * (2.0 * classes + 1.0) + classes)
    return max(n_bytes / PEAKS["hbm_bytes"], ops / PEAKS["fp32_flops"])
