"""Serialization of packed point clouds along space-filling curves, and
grid pooling's max: Point Transformer V3's orders (Wu et al., CVPR 2024,
arXiv:2312.10035; Pointcept's ``serialization/`` and ``SerializedPooling``).

Bit layouts (bit 0 is the least significant):

- **Morton** (``"z"``) of a cell ``g = (x, y, z)`` of ``depth`` bits an axis:
  bit ``i`` of x at ``3 i + 2``, of y at ``3 i + 1``, of z at ``3 i``, so each
  triple reads ``x y z`` from its top.
- **Hilbert** (``"hilbert"``): Skilling's transform of the axes (``Programming
  the Hilbert curve``, AIP 2004, as Pointcept's ``hilbert.py`` runs it), from
  the top level down: at level ``Q = 2^b`` (b = depth - 1 .. 1) and for each
  axis ``i`` in x, y, z order, where bit ``b`` of axis ``i`` is set the bits
  below ``b`` of x are inverted, else those bits of x and of axis ``i`` are
  exchanged where they differ. The transformed axes are interleaved as the
  Morton code interleaves them, and the result read as a Gray code and
  turned back to binary (each bit the XOR of itself and every bit above).
- ``"-trans"`` swaps x and y first.
- The code a point sorts by is ``cloud << (3 depth) | code``, so each order
  keeps the clouds in cloud order. ``depth`` is ``bit_length`` of the
  largest cell coordinate of the batch, and at least the number of poolings,
  so that the cloud's bits never reach a parent's code (``>> 3`` a pooling).

Each order keeps its stable sort (ties, two points in one cell, go by
packed index) and that sort's inverse. Functions here run on the device
and make no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
MAX_DEPTH = 16         # the bits a cell coordinate may take
# the bit-spreading masks of a 21-bit coordinate into every third bit
_SPREAD = ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF), (8, 0x100F00F00F00F00F),
           (4, 0x10C30C30C30C30C3), (2, 0x1249249249249249))


def spread3(v: torch.Tensor) -> torch.Tensor:
    """Bit ``i`` of ``v`` (int64, below 2^21) moved to bit ``3 i``."""
    v = v & 0x1FFFFF
    for shift, mask in _SPREAD:
        v = (v | (v << shift)) & mask
    return v


def morton(g: torch.Tensor) -> torch.Tensor:
    """Morton codes of ``g`` (P, 3) int64 cells."""
    return (spread3(g[:, 0]) << 2) | (spread3(g[:, 1]) << 1) | spread3(g[:, 2])


def hilbert(g: torch.Tensor, depth: int) -> torch.Tensor:
    """3-D Hilbert codes of ``g`` (P, 3) int64 cells of ``depth`` bits."""
    x = [g[:, 0], g[:, 1], g[:, 2]]
    for b in range(depth - 1, 0, -1):
        q, low = 1 << b, (1 << b) - 1
        for i in range(3):
            on = (x[i] & q) != 0
            if i == 0:
                x[0] = torch.where(on, x[0] ^ low, x[0])
                continue
            t = (x[0] ^ x[i]) & low
            x[0], x[i] = torch.where(on, x[0] ^ low, x[0] ^ t), torch.where(on, x[i], x[i] ^ t)
    h = (spread3(x[0]) << 2) | (spread3(x[1]) << 1) | spread3(x[2])
    shift = 1
    while shift < 3 * depth:
        h = h ^ (h >> shift)
        shift <<= 1
    return h


def encode(g: torch.Tensor, cloud: torch.Tensor, depth, order: str) -> torch.Tensor:
    """The sort code of each point along ``order``: the cloud above the
    curve's ``3 depth`` bits. ``depth`` is a host int or a 0-d tensor on
    ``g``'s device, so no synchronisation: the Hilbert code runs Skilling's
    transform at ``MAX_DEPTH`` levels, whose levels above ``depth`` find
    every bit clear and so only cycle the axes (x, y, z) -> (z, x, y); the
    axes are first cycled back as often."""
    axes = torch.arange(3, device=g.device)
    if order.endswith("-trans"):
        axes = torch.where(axes < 2, 1 - axes, axes)
    if order.startswith("z"):
        code = morton(g.index_select(1, axes))
    else:
        turns = (MAX_DEPTH - depth) % 3
        code = hilbert(g.index_select(1, axes[(torch.arange(3, device=g.device) + turns) % 3]),
                       MAX_DEPTH)
    return (cloud << (3 * depth)) | code


class Serialized(NamedTuple):
    """Four orders of one stage's points: ``code``, ``order`` (the stable
    sort) and ``inverse`` (its inverse), each (4, P) int64, in the shuffled
    order of the orders."""
    code: torch.Tensor
    order: torch.Tensor
    inverse: torch.Tensor


def sort_orders(code: torch.Tensor, perm: torch.Tensor) -> Serialized:
    """Each row of ``code`` (4, P) sorted (stable) with its inverse, the rows
    taken in the order ``perm`` (on ``code``'s device: no synchronisation)."""
    code = code[perm.to(code.device)]
    order = torch.sort(code, dim=1, stable=True).indices
    ar = torch.arange(code.shape[1], device=code.device).expand_as(order)
    return Serialized(code, order, torch.empty_like(order).scatter_(1, order, ar))


def shuffle(n: int, shuffle_orders: bool, generator) -> torch.Tensor:
    """The orders' permutation: ``torch.randperm(n)`` on the generator (on
    its device; the global generator when it is None), else the identity."""
    if not shuffle_orders:
        return torch.arange(n)
    if generator is None:
        return torch.randperm(n)
    return torch.randperm(n, generator=generator, device=generator.device)


def segment_max(h: torch.Tensor, parent: torch.Tensor, n: int) -> torch.Tensor:
    """``out[j] = max over i with parent[i] = j of h[i]`` (every j has a child)."""
    idx = parent[:, None].expand_as(h)
    return h.new_zeros((n, h.shape[1])).scatter_reduce(0, idx, h, reduce="amax",
                                                       include_self=False)
