"""Point Transformer V3 semantic segmentation over padded clouds.

Wu, Jiang, Wang, Liu, Liu, Qiao, Ouyang, He and Zhao, "Point Transformer
V3: Simpler, Faster, Stronger", CVPR 2024 (arXiv:2312.10035), at the sizes
of the authors' public implementation (Pointcept ``PointTransformerV3`` as
``semseg-pt-v3m1-0-base`` sets it): orders z, z-trans, hilbert,
hilbert-trans, shuffled; strides 2; encoder depths 2/2/2/6/2 at 32-512
channels and 2-32 heads, decoder depths 2/2/2/2 at 64/64/128/256 channels
and 4/4/8/16 heads (16 channels a head); patches of 1024; MLP ratio 4; qkv
bias; pre-norm; no relative position encoding. The zoo's fourth family and
the port's first packed net: the valid points of the padded ``(B, N)``
batch are packed into one ``(P, C)`` array in index order with their cloud
ids, and the logits unpacked to ``(B, N, classes)``, zeros on pad rows.

The layers (``ops.serialize``, ``ops.sparse_conv``, ``ops.patch_attention``):

- Grid: ``g = floor(pos / grid_size) - min over the cloud of floor(pos /
  grid_size)`` (Pointcept's ``GridSample``).
- Serialization: each order's codes (``cloud << 3 depth | curve code``), the
  stable sort and its inverse; with ``shuffle_orders`` the four orders are
  permuted by ``torch.randperm(4, generator=generator)`` here and at every
  pooling. Block ``i`` of a stage attends along order ``i % 4``.
- Embedding: ``GELU(BN(SubMConv5(x)))``, no bias.
- Block at width C, H heads: ``x + LN(Linear(SubMConv3(x)))`` (the xCPE;
  its conv has a bias), ``x + proj(Attn(LN(x)))``, ``x + fc2(GELU(fc1(LN(x))))``
  (4 C hidden). Attn is multi-head dot-product attention over patches of
  1024 consecutive points of the order (``ops.patch_attention``).
- Pooling (stride 2): ``h = Linear(x)``; children whose first order's code
  agrees above its lowest 3 bits share a parent, whose features are the
  children's max of ``h``, then ``GELU(BN(.))``; the parent's cell is
  ``g >> 1`` and its codes the children's ``>> 3``, sorted again.
- Unpooling: ``GELU(BN(Linear(x_skip))) + GELU(BN(Linear(x_coarse)))[parent]``,
  then the stage's decoder blocks.
- Head: ``fc_classif`` (64 -> classes).
- BatchNorm eps 1e-3 and momentum 0.01 as published; LayerNorm eps 1e-5.

Departures from the public implementation: the attention runs in float32
(the public flash path casts q, k and v to float16); padded clouds are
packed inside the net; two valid points may share a cell (the cook's grid
is anchored elsewhere; PTv3's own pipeline keeps one point a cell), and then
every offset but 0 reads the cell's point of lowest packed index; the
serialization depth is at least the number of poolings; training runs
without ``drop_path`` (stochastic depth), which is the identity at eval.

Every BatchNorm and LayerNorm sits under a ``norms`` list; a sparse
convolution's weight is ``(C_out, K^3 C_in)``. Spans
(``utils.profiling.span``): ``pt3.serialize`` (grid, codes, sorts,
inverses), ``pt3.cpe`` (the neighbour maps, the stem's conv and each
xCPE), ``pt3.attention`` (qkv, patches, the attention, proj), ``pt3.pool``
and ``pt3.unpool``. When ``counters`` is a dict (``predict(phases=)``
gives one) the forward adds to it (``utils.profiling.count``):
``pt3_points.<s>`` the points of stage s, ``pt3_conv_pairs.stem`` and
``pt3_conv_pairs.<s>`` the occupied (point, offset) pairs of the stem's
and of stage s's map, ``pt3_attn_pairs.<s>`` the (kept query, key) pairs
of one attention layer at stage s and ``pt3_dup_points`` the points whose
cell a point of lower index holds.

The shapes depend on the data, so the forward synchronises with the host
once a step, whatever it counts. Before that it queues every stage over
the padded batch's slots (``_levels``): the slot's cell at stage s is
``(cloud, g >> s)``, the stage's points are the distinct cells (at stage
0 the valid slots), each sorted once; the neighbour maps are searched
there and every code is computed at a depth the device holds. The one
read brings each cloud's points at every stage, each map's occupied
pairs an offset, the duplicates and the largest cell coordinate. Each
stage is then laid out in packed form (``_stage``: the points in cell-key
order, at stage 0 in slot order) when the forward reaches it, while the
device runs the stage before, so no layer waits on the host.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from myria3d_tpu_torch.models.modules.nn import MaskedBatchNorm
from myria3d_tpu_torch.ops import patch_attention, serialize
from myria3d_tpu_torch.ops.sparse_conv import (FIELD, Cells, Pairs, cells, compact, kernel_map,
                                                occupancy, pairs, restrict, submconv)
from myria3d_tpu_torch.utils.profiling import count, span

BN_EPS, BN_MOMENTUM, LN_EPS = 1e-3, 0.01, 1e-5
CLOUD_SHIFT = 3 * FIELD          # a cell key's cloud bits (ops.sparse_conv.cell_keys)


def batch_norm(c: int) -> MaskedBatchNorm:
    return MaskedBatchNorm(c, momentum=BN_MOMENTUM, eps=BN_EPS)


class Level(NamedTuple):
    """Stage s over the padded batch's ``S`` slots, queued before the host
    knows its sizes: ``cells`` (``sparse_conv.cells`` of ``g >> s``),
    ``index`` (S,) the stage's point that each valid slot falls in, ``nbr``
    the slots' neighbour map (5^3 at stage 0, the stem's; 3^3 after) and
    ``sizes`` (device) each cloud's points then the map's pairs an offset
    (at stage 0 then those of its 3^3 columns)."""
    cells: Cells
    index: torch.Tensor
    nbr: torch.Tensor
    sizes: torch.Tensor


class Stage(NamedTuple):
    """A stage's points in packed form: the four orders, the pairs of the
    3^3 neighbour map and the attention's patches."""
    ser: serialize.Serialized
    conv: Pairs
    patches: patch_attention.Layout


class SubMConv(nn.Module):
    """A submanifold sparse convolution (``ops.sparse_conv.submconv``)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, bias: bool):
        super().__init__()
        fan_in = kernel ** 3 * c_in
        self.weight = nn.Parameter(torch.empty(c_out, fan_in))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bias = nn.Parameter(torch.empty(c_out).uniform_(-fan_in ** -0.5, fan_in ** -0.5)) \
            if bias else None

    def forward(self, x: torch.Tensor, pr: Pairs) -> torch.Tensor:
        return submconv(x, pr, self.weight, self.bias)


class LinearBN(nn.Module):
    """``GELU(BN(Linear(x)))``, as ``linear`` and ``norms.0``."""

    def __init__(self, a: int, b: int):
        super().__init__()
        self.linear = nn.Linear(a, b)
        self.norms = nn.ModuleList([batch_norm(b)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.norms[0](self.linear(x)))


class Embedding(nn.Module):
    def __init__(self, c_in: int, c: int):
        super().__init__()
        self.conv = SubMConv(c_in, c, 5, bias=False)
        self.norms = nn.ModuleList([batch_norm(c)])

    def forward(self, x: torch.Tensor, pr: Pairs) -> torch.Tensor:
        with span("pt3.cpe"):
            return F.gelu(self.norms[0](self.conv(x, pr)))


class CPE(nn.Module):
    """The conditional position encoding ``LN(Linear(SubMConv3(x)))``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = SubMConv(c, c, 3, bias=True)
        self.linear = nn.Linear(c, c)
        self.norms = nn.ModuleList([nn.LayerNorm(c, eps=LN_EPS)])

    def forward(self, x: torch.Tensor, pr: Pairs) -> torch.Tensor:
        return self.norms[0](self.linear(self.conv(x, pr)))


class Attention(nn.Module):
    """``proj`` of the patch attention of ``qkv(x)`` along one order."""

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, st: Stage, order: int) -> torch.Tensor:
        y = patch_attention.attention(self.qkv(x), st.ser.order[order], st.ser.inverse[order],
                                      st.patches, self.heads)
        return self.proj(y)


class MLP(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(c, hidden)
        self.fc2 = nn.Linear(hidden, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """The pre-norm block: ``cpe``, ``norms.0`` and ``attn``, ``norms.1`` and
    ``mlp``, each behind a residual."""

    def __init__(self, c: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.cpe = CPE(c)
        self.norms = nn.ModuleList([nn.LayerNorm(c, eps=LN_EPS), nn.LayerNorm(c, eps=LN_EPS)])
        self.attn = Attention(c, heads)
        self.mlp = MLP(c, int(c * mlp_ratio))

    def forward(self, x: torch.Tensor, st: Stage, order: int) -> torch.Tensor:
        with span("pt3.cpe"):
            x = x + self.cpe(x, st.conv)
        y = self.norms[0](x)
        with span("pt3.attention"):
            x = x + self.attn(y, st, order)
        return x + self.mlp(self.norms[1](x))


class Pool(nn.Module):
    """The stride-2 grid pooling's ``linear``, max and ``norms.0``."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.linear = nn.Linear(c_in, c_out)
        self.norms = nn.ModuleList([batch_norm(c_out)])

    def forward(self, x: torch.Tensor, parent: torch.Tensor, n: int) -> torch.Tensor:
        return F.gelu(self.norms[0](serialize.segment_max(self.linear(x), parent, n)))


class Unpool(nn.Module):
    def __init__(self, c_in: int, c_skip: int, c_out: int):
        super().__init__()
        self.proj = LinearBN(c_in, c_out)
        self.proj_skip = LinearBN(c_skip, c_out)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
        with span("pt3.unpool"):
            return self.proj_skip(skip) + self.proj(x)[parent]


class EncoderStage(nn.Module):
    def __init__(self, down: Optional[Pool], blocks: List[Block]):
        super().__init__()
        self.down = down
        self.blocks = nn.ModuleList(blocks)


class DecoderStage(nn.Module):
    def __init__(self, up: Unpool, blocks: List[Block]):
        super().__init__()
        self.up = up
        self.blocks = nn.ModuleList(blocks)


class PointTransformerV3Seg(nn.Module):
    """``forward(x, pos, mask, generator) -> logits (B, N, num_classes)``
    float32. ``generator`` draws the orders' shuffles. Positions are the
    net's (``NormalizePos``: the 50 m subtile to [-1, 1]), so the default
    ``grid_size`` 0.01 is a 0.25 m voxel."""

    def __init__(self, num_features: int, num_classes: int, grid_size: float = 0.01,
                 order: Sequence[str] = serialize.ORDERS, stride: Sequence[int] = (2, 2, 2, 2),
                 enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
                 enc_channels: Sequence[int] = (32, 64, 128, 256, 512),
                 enc_num_head: Sequence[int] = (2, 4, 8, 16, 32),
                 enc_patch_size: Sequence[int] = (1024,) * 5,
                 dec_depths: Sequence[int] = (2, 2, 2, 2),
                 dec_channels: Sequence[int] = (64, 64, 128, 256),
                 dec_num_head: Sequence[int] = (4, 4, 8, 16),
                 dec_patch_size: Sequence[int] = (1024,) * 4, mlp_ratio: float = 4,
                 shuffle_orders: bool = True, return_logits: bool = True):
        super().__init__()
        n = len(enc_depths)
        if not (len(enc_channels) == len(enc_num_head) == len(enc_patch_size) == n
                and len(stride) == len(dec_depths) == len(dec_channels) == len(dec_num_head)
                == len(dec_patch_size) == n - 1):
            raise ValueError("one encoder entry a stage, one stride and decoder entry a pooling")
        if any(int(s) != 2 for s in stride):
            raise ValueError(f"stride {list(stride)}: the grid pooling is implemented at 2")
        if len(set(enc_patch_size) | set(dec_patch_size)) != 1:
            raise ValueError("one patch size for every stage")
        self.grid_size = float(grid_size)
        self.order = tuple(order)
        self.patch = int(enc_patch_size[0])
        self.shuffle_orders = bool(shuffle_orders)
        self.return_logits = bool(return_logits)
        self.counters: Optional[dict] = None
        self.embedding = Embedding(num_features, enc_channels[0])
        self.enc = nn.ModuleList(
            EncoderStage(Pool(enc_channels[s - 1], enc_channels[s]) if s else None,
                         [Block(enc_channels[s], enc_num_head[s], mlp_ratio)
                          for _ in range(enc_depths[s])])
            for s in range(n))
        ins = list(dec_channels) + [enc_channels[-1]]
        self.dec = nn.ModuleList(
            DecoderStage(Unpool(ins[s + 1], enc_channels[s], dec_channels[s]),
                         [Block(dec_channels[s], dec_num_head[s], mlp_ratio)
                          for _ in range(dec_depths[s])])
            for s in range(n - 1))
        self.fc_classif = nn.Linear(dec_channels[0], num_classes)

    def _count(self, name: str, n) -> None:
        if self.counters is not None:
            count(self.counters, name, int(n))

    def _levels(self, pos: torch.Tensor, mask: torch.Tensor, generator):
        """Every stage over the padded batch's slots, read by the host in
        one synchronisation: ``(levels, code, perms, sizes)``, ``code`` (4,
        S) the slots' stage-0 codes in the orders' given order, ``perms``
        (L, 4) each stage's orders among them and ``sizes`` each level's
        host ints."""
        b, n = mask.shape
        dev = mask.device
        valid = mask.reshape(-1)
        with span("pt3.serialize"):
            cell = torch.floor(pos / self.grid_size)
            low = torch.where(mask[..., None], cell, math.inf).amin(dim=1, keepdim=True)
            g = torch.where(mask[..., None], cell - low, 0).long().reshape(-1, 3)
            cloud = torch.arange(b * n, device=dev) // n
            gmax = g.max()
            bits = (gmax >= 1 << torch.arange(63, device=dev)).sum()
            depth = bits.clamp(min=len(self.enc) - 1, max=serialize.MAX_DEPTH)
            code = torch.stack([serialize.encode(g, cloud, depth, o) for o in self.order])
            perms = [self._perm(generator).to(dev)]
            for _ in range(1, len(self.enc)):
                perms.append(perms[-1][self._perm(generator).to(dev)])
        levels = []
        with span("pt3.cpe"):
            for s in range(len(self.enc)):
                c = cells(g >> s, cloud, valid)
                distinct = torch.zeros(b, dtype=torch.long, device=dev).scatter_add_(
                    0, (c.sorted_key >> CLOUD_SHIFT).clamp_(max=b - 1), c.first.long())
                if s == 0:
                    index, rows, nbr = torch.cumsum(valid, 0) - 1, valid, kernel_map(c, 2)
                    dups = valid.sum() - distinct.sum()
                    occupied = [occupancy(nbr, rows), occupancy(restrict(nbr, 1), rows)]
                    counts = mask.sum(dim=1)
                else:
                    rank = torch.cumsum(c.first, 0) - 1
                    index = torch.empty_like(rank).scatter_(0, c.by_key, rank)
                    rows = torch.zeros_like(valid).scatter_(0, c.by_key, c.first)
                    nbr, counts = kernel_map(c, 1), distinct
                    occupied = [occupancy(nbr, rows)]
                levels.append(Level(c, index, nbr, torch.cat([counts] + occupied)))
        with span("pt3.serialize"):
            got = torch.cat([lv.sizes for lv in levels] + [dups.view(1), gmax.view(1)]).tolist()
        sizes, at = [], 0
        for lv in levels:
            sizes.append(got[at:at + lv.sizes.numel()])
            at += lv.sizes.numel()
        self._count("pt3_dup_points", got[-2])
        depth = max(int(got[-1]).bit_length(), len(self.enc) - 1)
        if depth > serialize.MAX_DEPTH or 3 * depth + b.bit_length() > 63:
            raise ValueError(f"serialization depth {depth} for {b} clouds: a cloud spans more "
                             f"than 2^{serialize.MAX_DEPTH} cells at grid_size {self.grid_size}")
        return levels, code, torch.stack(perms), sizes

    def _stage(self, s: int, lv: Level, sizes: list, code, perm):
        """Stage s in packed form, and its points' slots (no synchronisation):
        ``(stage, members, stem)``, ``stem`` the stem's pairs at stage 0;
        ``sizes`` the level's host ints."""
        b = len(sizes) - lv.nbr.shape[1] - (27 if s == 0 else 0)
        counts, occupied = sizes[:b], sizes[b:]
        p = sum(counts)
        with span("pt3.serialize" if s == 0 else "pt3.pool"):
            if s == 0:
                members = compact(lv.cells.valid, p)
            else:
                members = lv.cells.by_key[compact(lv.cells.first, p)]
            ser = serialize.sort_orders(code[:, members] >> 3 * s, perm)
        with span("pt3.cpe"):
            nbr = lv.nbr[members]
            nbr = torch.where(nbr >= 0, lv.index[nbr.clamp(min=0)], -1)
            stem = None
            if s == 0:
                stem = pairs(nbr, occupied[:-27])
                nbr, occupied = restrict(nbr, 1), occupied[-27:]
            conv = pairs(nbr, occupied)
        with span("pt3.attention"):
            patches = patch_attention.layout(counts, self.patch, nbr.device)
        if s == 0:
            self._count("pt3_conv_pairs.stem", stem.count)
        self._count(f"pt3_points.{s}", p)
        self._count(f"pt3_conv_pairs.{s}", conv.count)
        self._count(f"pt3_attn_pairs.{s}", patches.pairs)
        return Stage(ser, conv, patches), members, stem

    def _perm(self, generator):
        return serialize.shuffle(len(self.order), self.shuffle_orders, generator)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, n = mask.shape
        classes = self.fc_classif.out_features
        if not b * n:
            return pos.new_zeros((b, n, classes))
        levels, code, perms, sizes = self._levels(pos, mask, generator)
        if not sum(sizes[0][:b]):
            return pos.new_zeros((b, n, classes))
        st, flat, stem = self._stage(0, levels[0], sizes[0], code, perms[0])
        x = self.embedding(x.reshape(-1, x.shape[-1])[flat], stem)
        del stem
        stages, skips, parents, members = [st], [], [], flat
        for s, enc in enumerate(self.enc):
            if s:
                # stage s is laid out while the device runs stage s - 1
                st, nxt, _ = self._stage(s, levels[s], sizes[s], code, perms[s])
                with span("pt3.pool"):
                    skips.append(x)
                    parents.append(levels[s].index[members])
                    x = enc.down(x, parents[-1], st.ser.code.shape[1])
                stages.append(st)
                members = nxt
            for i, block in enumerate(enc.blocks):
                x = block(x, st, i % len(self.order))
        for s in reversed(range(len(self.dec))):
            dec = self.dec[s]
            x = dec.up(x, skips[s], parents[s])
            for i, block in enumerate(dec.blocks):
                x = block(x, stages[s], i % len(self.order))
        x = self.fc_classif(x)
        logits = x.new_zeros((b * n, classes))
        logits[flat] = x
        logits = logits.view(b, n, classes)
        return logits if self.return_logits else torch.log_softmax(logits, dim=-1)
