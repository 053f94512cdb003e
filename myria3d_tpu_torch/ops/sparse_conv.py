"""Submanifold sparse convolution over packed point clouds on a voxel grid:
Point Transformer V3's stem (5^3) and conditional position encoding (3^3).

``cells(g, cloud, valid)`` sorts the rows' (cloud, cell) keys once
(stable, so equal keys keep the row order; rows not ``valid`` last) and
marks the first row of each cell. ``kernel_map(cells, radius)`` is the
neighbour map: for each row ``i`` and each offset ``d`` of ``{-r..r}^3``
(index ``((dx + r) w + dy + r) w + dz + r``, ``w = 2 r + 1``), the row of
the same cloud whose cell is ``g_i + d``, or -1 where that cell is empty
or the row not valid. At ``d = 0`` a row reads itself. Where several rows
of a cloud share a cell, every other offset reads the one of lowest
index. The map is a binary search of every (row, offset) query in the
sorted keys. ``restrict(nbr, r)`` takes a map's columns of the offsets
within a smaller radius ``r``: the 3^3 map is the 5^3 map's 27 inner
columns.

``pairs(nbr, counts)`` lists, for each offset that some point occupies,
the points that have a neighbour there and those neighbours; ``counts``
(host ints, ``occupancy`` read once) gives each offset's count, so
the listing itself needs no synchronisation. ``submconv(x, pairs, weight,
bias)`` is ``y_i = sum_d W_d x_{nbr(i, d)}`` over the occupied offsets
only: a gather of the neighbours' rows, their product by ``W_d`` and an
``index_add_`` into the points' rows, an offset at a time in offset order,
then the bias. A point has at most one neighbour an offset, so no two
rows of one ``index_add_`` meet and the sums do not depend on the
device's scheduling. The weight is ``(C_out, K^3 C_in)``, whose column ``d
C_in + c`` is input channel ``c`` at offset ``d``. Nothing here
synchronises with the host.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

FIELD = 17             # bits a cell coordinate (below 2^16, shifted by 2) takes in a key
SENTINEL = torch.iinfo(torch.long).max   # above every key: where a row is not valid


def cell_keys(g: torch.Tensor, cloud: torch.Tensor) -> torch.Tensor:
    """(cloud, cell) keys of ``g`` (P, 3) int64, each axis shifted by 2 so
    that a neighbour's key is the key plus its offset's."""
    g = g + 2
    return (cloud << (3 * FIELD)) | (g[:, 0] << (2 * FIELD)) | (g[:, 1] << FIELD) | g[:, 2]


def offsets(radius: int, device) -> torch.Tensor:
    """The key increments of the ``(2 r + 1)^3`` offsets, in map order."""
    r = torch.arange(-radius, radius + 1, device=device)
    dx, dy, dz = torch.meshgrid(r, r, r, indexing="ij")
    return ((dx << (2 * FIELD)) + (dy << FIELD) + dz).reshape(-1)


class Cells(NamedTuple):
    """Rows' (cloud, cell) keys (``key``), their stable sort with the rows
    not valid last as ``SENTINEL`` (``sorted_key``, ``by_key``), ``first``
    (by sorted position) where a valid row's cell starts, and ``valid``."""
    key: torch.Tensor
    sorted_key: torch.Tensor
    by_key: torch.Tensor
    first: torch.Tensor
    valid: torch.Tensor


def cells(g: torch.Tensor, cloud: torch.Tensor, valid: torch.Tensor) -> Cells:
    """The cells of ``g`` (n, 3) int64 (below 2^16 an axis) in ``cloud``
    (below 2^12), over the rows where ``valid``."""
    key = cell_keys(g, cloud)
    sorted_key, by_key = torch.sort(torch.where(valid, key, SENTINEL), stable=True)
    first = sorted_key != SENTINEL
    first[1:] &= sorted_key[1:] != sorted_key[:-1]
    return Cells(key, sorted_key, by_key, first, valid)


def kernel_map(c: Cells, radius: int) -> torch.Tensor:
    """``nbr`` (n, (2 r + 1)^3) int64: the neighbour row of each row at each
    offset, -1 where none."""
    n = c.key.numel()
    q = c.key[:, None] + offsets(radius, c.key.device)[None, :]
    at = torch.searchsorted(c.sorted_key, q).clamp_(max=max(n - 1, 0))
    nbr = torch.where(c.sorted_key[at] == q, c.by_key[at], -1)
    nbr[:, nbr.shape[1] // 2] = torch.arange(n, device=c.key.device)
    return nbr.masked_fill_(~c.valid[:, None], -1)


def restrict(nbr: torch.Tensor, radius: int) -> torch.Tensor:
    """The columns of ``nbr`` (a map of a larger radius) at the offsets of
    ``{-radius..radius}^3``, in map order."""
    big = round(nbr.shape[1] ** (1 / 3)) // 2
    r = torch.arange(big - radius, big + radius + 1, device=nbr.device)
    w = 2 * big + 1
    return nbr[:, ((r[:, None, None] * w + r[None, :, None]) * w + r[None, None, :]).reshape(-1)]


class Pairs(NamedTuple):
    """The occupied offsets of a neighbour map (host ints), and for each the
    points that read it (``out``) and their neighbours (``src``); ``count``
    all the (point, offset) pairs, ``points`` the points."""
    offsets: List[int]
    out: List[torch.Tensor]
    src: List[torch.Tensor]
    count: int
    points: int


def occupancy(nbr: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The rows where ``rows`` that have a neighbour at each offset ((K^3,)
    device int64)."""
    return ((nbr >= 0) & rows[:, None]).sum(dim=0)


def compact(m: torch.Tensor, total: int) -> torch.Tensor:
    """The indices of ``m``'s (1-D bool) ``total`` true entries, ascending:
    ``m.nonzero()`` without the synchronisation that sizes its output."""
    at = torch.cumsum(m, 0)
    at.sub_(1).masked_fill_(~m, total)
    out = torch.empty(total + 1, dtype=torch.long, device=m.device)
    return out.scatter_(0, at, torch.arange(m.numel(), device=m.device))[:total]


def pairs(nbr: torch.Tensor, counts: List[int]) -> Pairs:
    """``nbr``'s pairs by offset, given each offset's count (``occupancy``)."""
    total = sum(counts)
    t = nbr.T.reshape(-1)
    at = compact(t >= 0, total)
    i, j = at % nbr.shape[0], t[at]
    occupied = [k for k, n in enumerate(counts) if n]
    sizes = [counts[k] for k in occupied]
    return Pairs(occupied, list(i.split(sizes)), list(j.split(sizes)), total, nbr.shape[0])


def submconv(x: torch.Tensor, pr: Pairs, weight: torch.Tensor,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """The submanifold convolution of ``x`` (P, C_in) over ``pr``."""
    c_out, c_in = weight.shape[0], x.shape[1]
    w = weight.view(c_out, -1, c_in)
    y = x.new_zeros((pr.points, c_out))
    for d, i, j in zip(pr.offsets, pr.out, pr.src):
        y.index_add_(0, i, F.linear(x[j], w[:, d]))
    return y if bias is None else y + bias
