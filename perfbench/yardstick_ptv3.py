"""Point Transformer V3's model FLOPs, under the rules of
:mod:`perfbench.yardstick` (its peaks): the dense products the
architecture defines, at the real counts the reference's ``slots`` hold for
a batch (``reference/point_transformer_v3.py``: ``points`` of each stage,
``conv_pairs`` of the stem's map and of each stage's, ``attn_pairs`` of
one attention layer at each stage).

- Each Linear: ``2 * in * out`` a real point. A block at width C: the
  xCPE's Linear, qkv (C -> 3 C), proj and the MLP (C -> 4 C -> C); a
  pooling's Linear at its children, an unpooling's two at the coarse and
  the skip points; the classifier.
- Each sparse convolution: ``2 * C_in * C_out`` an occupied (point, offset)
  pair: the stem once, a stage's map in each of its encoder and decoder
  blocks.
- Each attention layer: ``4 * C`` a (kept query, key) pair (``q . k`` and
  the weighted sum of ``v``, over every head).
- The softmax, the norms, the activations, the max and the sums of the
  residuals count nothing.
"""

from __future__ import annotations


def block_flops(c: int, ratio: float, points: int, conv_pairs: int, attn_pairs: int) -> float:
    """One block at width ``c`` over a stage's counts."""
    hidden = int(c * ratio)
    dense = 2 * points * (c * c + 3 * c * c + c * c + 2 * c * hidden)
    return float(dense + 2 * c * c * conv_pairs + 4 * c * attn_pairs)


def attention_flops(cfg: dict, slots: dict) -> float:
    """The attention layers' ``4 C`` a pair, over every encoder and decoder
    block of every stage."""
    total = 0
    for s, c in enumerate(cfg["enc_channels"]):
        total += cfg["enc_depths"][s] * 4 * c * slots["attn_pairs"][s]
    for s, c in enumerate(cfg["dec_channels"]):
        total += cfg["dec_depths"][s] * 4 * c * slots["attn_pairs"][s]
    return float(total)


def batch_flops(cfg: dict, slots: dict) -> float:
    """Model FLOPs of one eval forward of a batch whose counts are ``slots``."""
    enc, dec = cfg["enc_channels"], cfg["dec_channels"]
    ratio = cfg.get("mlp_ratio", 4)
    pts, conv, attn = slots["points"], slots["conv_pairs"], slots["attn_pairs"]
    total = 2.0 * cfg["num_features"] * enc[0] * conv[0]
    for s, c in enumerate(enc):
        if s:
            total += 2 * enc[s - 1] * c * pts[s - 1]
        total += cfg["enc_depths"][s] * block_flops(c, ratio, pts[s], conv[s + 1], attn[s])
    ins = list(dec) + [enc[-1]]
    for s, c in enumerate(dec):
        total += 2 * ins[s + 1] * c * pts[s + 1] + 2 * enc[s] * c * pts[s]
        total += cfg["dec_depths"][s] * block_flops(c, ratio, pts[s], conv[s + 1], attn[s])
    return float(total + 2 * dec[0] * cfg["num_classes"] * pts[0])
