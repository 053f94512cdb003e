"""Multi-head dot-product attention inside patches of consecutive points of
a serialization order: Point Transformer V3's ``SerializedAttention`` on
its flash path (varlen patches), over packed point clouds.

A stage's patches (``layout``) hold sorted positions, the same for each of
its orders (every order keeps the clouds in cloud order):

- a cloud of ``n <= K`` points is one patch of ``n``; such patches are
  padded to the longest of them (rounded up to 8), with a key mask;
- a cloud of ``n > K`` points is cut into ``ceil(n / K)`` patches of ``K``
  consecutive points, the last one holding the cloud's last ``K`` points
  (PTv3 fills it so: its ``n % K`` own points and the ``K - n % K`` before
  them), and only the results of its own points are kept.

``attention(qkv, order, inverse, layout, heads)`` takes the rows of
``qkv`` (P, 3 C) in the order's sort, runs
``torch.nn.functional.scaled_dot_product_attention`` on ``(patches, heads,
K, C / heads)`` float32 at scale ``(C / heads)^-0.5`` and puts each point's
row back through the order's inverse.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F


class Layout(NamedTuple):
    """Sorted positions of a stage's patches: ``full`` (F, K) the patches of
    the clouds over ``K`` points, ``short`` (S, L) one a cloud of at most
    ``K``, with ``key_mask`` (S, 1, 1, L); ``own`` (P,) each sorted
    position's row in the patches' outputs laid end to end; ``pairs`` the
    (kept query, key) pairs of one layer."""
    full: Optional[torch.Tensor]
    short: Optional[torch.Tensor]
    key_mask: Optional[torch.Tensor]
    own: torch.Tensor
    pairs: int


def _device_ints(device, *lists):
    """Host int lists as device int64 tensors, moved in one copy that does
    not wait for the device (from pinned memory where it is a card)."""
    host = torch.tensor([v for values in lists for v in values], dtype=torch.long)
    if torch.device(device).type == "cuda":
        host = host.pin_memory().to(device, non_blocking=True)
    return host.split([len(values) for values in lists])


def layout(counts: Sequence[int], k: int, device) -> Layout:
    """The patches of clouds of ``counts`` points (host ints), packed in
    cloud order. Makes no host synchronisation."""
    counts = [int(n) for n in counts]
    starts, at = [], 0
    for n in counts:
        starts.append(at)
        at += n
    full_starts, base, short, short_n = [], {}, [], []
    for b, (o, n) in enumerate(zip(starts, counts)):
        if n > k:
            base[b] = len(full_starts)
            c = -(-n // k)
            full_starts += [o + p * k for p in range(c - 1)] + [o + n - k]
        elif n:
            base[b] = len(short)
            short.append(o)
            short_n.append(n)
    n_full = len(full_starts) * k
    width = -(-max(short_n, default=0) // 8) * 8
    full_t, short_t, n_t, c, o, bse = _device_ints(
        device, full_starts, short, short_n, counts, starts,
        [base.get(b, 0) for b in range(len(counts))])
    full = full_t[:, None] + torch.arange(k, device=device) if full_starts else None
    key_mask = sh = None
    if short:
        ar = torch.arange(width, device=device)
        sh = short_t[:, None] + torch.minimum(ar, n_t[:, None] - 1)
        key_mask = (ar < n_t[:, None])[:, None, None, :]
    # each sorted position's row: patch p's row i is p * K + i among the
    # full patches, then n_full + s * width + i among the short ones
    cloud = torch.repeat_interleave(torch.arange(len(counts), device=device), c,
                                    output_size=at)
    local = torch.arange(at, device=device) - o[cloud]
    n, b0 = c[cloud], bse[cloud]
    last = (n + k - 1) // k - 1
    p = torch.minimum(local // k, last)
    in_full = (b0 + p) * k + local - torch.where(p == last, n - k, p * k)
    own = torch.where(n > k, in_full, n_full + b0 * width + local)
    pairs = sum(n * k if n > k else n * n for n in counts)
    return Layout(full, sh, key_mask, own, pairs)


def attention(qkv: torch.Tensor, order: torch.Tensor, inverse: torch.Tensor, lay: Layout,
              heads: int) -> torch.Tensor:
    """``(P, C)``: each point's attention over its patch of the order."""
    c = qkv.shape[1] // 3
    outs = []
    for pos, mask in ((lay.full, None), (lay.short, lay.key_mask)):
        if pos is None:
            continue
        n, length = pos.shape
        t = qkv[order[pos]].view(n, length, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        y = F.scaled_dot_product_attention(t[0], t[1], t[2], attn_mask=mask)
        outs.append(y.transpose(1, 2).reshape(n * length, c))
    flat = outs[0] if len(outs) == 1 else torch.cat(outs)
    return flat[lay.own[inverse]]
