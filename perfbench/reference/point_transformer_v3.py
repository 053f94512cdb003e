"""Plain Point Transformer V3 (Wu et al., CVPR 2024, arXiv:2312.10035), the
segmentation net of the authors' public implementation (Pointcept
``PointTransformerV3``, ``semseg-pt-v3m1-0-base``): the reference the
benchmark holds the program to.

A function of a flat parameter dict (:func:`param_shapes`) over packed
points: each cloud's valid points in index order, its cells ``g =
floor(pos / grid_size) - min over the cloud``. Four serialization orders
(Morton and Hilbert codes, the ``-trans`` ones with x and y swapped, each
``cloud << 3 depth | code``, ``depth`` the bit length of the batch's
largest cell coordinate and at least the number of poolings), sorted
stably and permuted by ``torch.randperm(4)`` on the caller's generator, at
the start and at every pooling. The stem ``GELU(BN(SubMConv5(x)))``; five
encoder stages (a grid pooling before each but the first: the max of a
Linear over the children that share the first order's code above its
lowest 3 bits, then BN and GELU; the parents' codes the children's ``>>
3``) of pre-norm blocks (``x + LN(Linear(SubMConv3(x)))``, ``x +
proj(Attn(LN(x)))``, ``x + fc2(GELU(fc1(LN(x))))``), four decoder stages
(``GELU(BN(Linear(skip))) + GELU(BN(Linear(coarse)))[parent]``, then
blocks) and the classifier. Block ``i`` attends along order ``i % 4``.

- The neighbour map is a dense occupancy grid of each cloud (the lowest
  packed index of a cell's points); a point reads itself at offset 0. The
  convolution sums ``W_d x_nbr`` over the occupied offsets, one product an
  offset.
- The attention builds Pointcept's ``pad``, ``unpad`` and ``cu_seqlens``
  (``SerializedAttention.get_padding_and_inverse``, a cloud at a time) and
  runs ``softmax((q * d^-0.5) @ k^T) @ v`` a patch, in blocks of patches of
  one length.
- BatchNorm eps 1e-3 (at eval the affine of its running statistics),
  LayerNorm eps 1e-5, GELU the exact ``erf`` form. Every Linear, product and
  convolution is float32.

``slots`` counts, for the last call: ``points`` of each stage,
``conv_pairs`` the occupied (point, offset) pairs of the stem's map and of
each stage's, ``attn_pairs`` the (kept query, key) pairs of one attention
layer at each stage and ``dup_points`` the points whose cell a point of
lower index holds. Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.randla_net import round_tf32

BN_EPS, LN_EPS = 1e-3, 1e-5
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
SCORES = 1 << 26   # attention scores of one block of patches, at most


def param_shapes(cfg: dict) -> dict:
    """Every parameter and BatchNorm statistic: ``{name: shape}``."""
    enc_c, dec_c = cfg["enc_channels"], cfg["dec_channels"]
    ratio = cfg.get("mlp_ratio", 4)
    shapes: dict = {}

    def lin(name, a, b):
        shapes[f"{name}.weight"] = (b, a)
        shapes[f"{name}.bias"] = (b,)

    def norm(name, c, leaves=("weight", "bias")):
        shapes.update({f"{name}.{leaf}": (c,) for leaf in leaves})

    def block(p, c):
        shapes[f"{p}.cpe.conv.weight"] = (c, 27 * c)
        shapes[f"{p}.cpe.conv.bias"] = (c,)
        lin(f"{p}.cpe.linear", c, c)
        norm(f"{p}.cpe.norms.0", c)
        norm(f"{p}.norms.0", c)
        norm(f"{p}.norms.1", c)
        lin(f"{p}.attn.qkv", c, 3 * c)
        lin(f"{p}.attn.proj", c, c)
        lin(f"{p}.mlp.fc1", c, int(c * ratio))
        lin(f"{p}.mlp.fc2", int(c * ratio), c)

    shapes["embedding.conv.weight"] = (enc_c[0], 125 * cfg["num_features"])
    norm("embedding.norms.0", enc_c[0], BN_LEAVES)
    for s, c in enumerate(enc_c):
        if s:
            lin(f"enc.{s}.down.linear", enc_c[s - 1], c)
            norm(f"enc.{s}.down.norms.0", c, BN_LEAVES)
        for i in range(cfg["enc_depths"][s]):
            block(f"enc.{s}.blocks.{i}", c)
    ins = list(dec_c) + [enc_c[-1]]
    for s, c in enumerate(dec_c):
        lin(f"dec.{s}.up.proj.linear", ins[s + 1], c)
        norm(f"dec.{s}.up.proj.norms.0", c, BN_LEAVES)
        lin(f"dec.{s}.up.proj_skip.linear", enc_c[s], c)
        norm(f"dec.{s}.up.proj_skip.norms.0", c, BN_LEAVES)
        for i in range(cfg["dec_depths"][s]):
            block(f"dec.{s}.blocks.{i}", c)
    lin("fc_classif", dec_c[0], cfg["num_classes"])
    return shapes


def morton(g: torch.Tensor, depth: int) -> torch.Tensor:
    """Bit ``i`` of x, y and z at ``3 i + 2``, ``3 i + 1`` and ``3 i``."""
    code = torch.zeros_like(g[:, 0])
    for i in range(depth):
        for axis, at in ((0, 2), (1, 1), (2, 0)):
            code |= ((g[:, axis] >> i) & 1) << (3 * i + at)
    return code


def hilbert(g: torch.Tensor, depth: int) -> torch.Tensor:
    """Skilling's Hilbert code over bit arrays, the top bit first, as
    Pointcept's ``serialization/hilbert.py`` computes it."""
    if depth == 0:
        return torch.zeros_like(g[:, 0])
    bits = torch.stack([((g >> (depth - 1 - j)) & 1).bool() for j in range(depth)], dim=-1)
    for j in range(depth):
        for axis in range(3):
            on = bits[:, axis, j][:, None]
            bits[:, 0, j + 1:] ^= on
            flip = ~on & (bits[:, 0, j + 1:] ^ bits[:, axis, j + 1:])
            bits[:, axis, j + 1:] ^= flip
            bits[:, 0, j + 1:] ^= flip
    gray = bits.transpose(1, 2).reshape(g.shape[0], 3 * depth).long()
    binary = torch.cumsum(gray, dim=1) % 2          # each bit the XOR of those above
    weights = 1 << torch.arange(3 * depth - 1, -1, -1, device=g.device)
    return (binary * weights).sum(dim=1)


def encode(g, cloud, depth: int, order: str):
    if order.endswith("-trans"):
        g = g[:, [1, 0, 2]]
    code = morton(g, depth) if order.startswith("z") else hilbert(g, depth)
    return (cloud << (3 * depth)) | code


def sorted_orders(code):
    order = torch.stack([torch.sort(c, stable=True).indices for c in code])
    inverse = torch.stack([torch.argsort(o) for o in order])
    return code, order, inverse


def neighbours(g, counts, radius: int):
    """(P, (2 r + 1)^3) neighbour map (-1: empty), offsets with dz fastest,
    by a dense occupancy grid of each cloud; and the count of points whose
    cell holds a point of lower index."""
    w = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, device=g.device)
    delta = torch.stack(torch.meshgrid(d, d, d, indexing="ij"), dim=-1).reshape(-1, 3)
    out, start, dups = [], 0, 0
    for n in counts:
        if n == 0:
            continue
        gc = g[start:start + n] + radius
        size = (gc.max(dim=0).values + radius + 1).tolist()
        flat = (gc[:, 0] * size[1] + gc[:, 1]) * size[2] + gc[:, 2]
        grid = torch.full((size[0] * size[1] * size[2],), n, dtype=torch.long, device=g.device)
        grid.scatter_reduce_(0, flat, torch.arange(n, device=g.device), "amin")
        dups += int((grid[flat] != torch.arange(n, device=g.device)).sum())
        q = gc[:, None, :] + delta[None]
        nb = grid[(q[..., 0] * size[1] + q[..., 1]) * size[2] + q[..., 2]]
        nb[:, w ** 3 // 2] = torch.arange(n, device=g.device)
        out.append(torch.where(nb < n, nb + start, -1))
        start += n
    return torch.cat(out), dups


def padding(counts, k: int, device):
    """Pointcept's ``pad``, ``unpad`` and ``cu_seqlens`` of clouds of
    ``counts`` points."""
    counts = torch.as_tensor(counts, dtype=torch.long)
    padded = torch.where(counts > k, (counts + k - 1) // k * k, counts)
    off = F.pad(torch.cumsum(counts, 0), (1, 0)).tolist()
    off_pad = F.pad(torch.cumsum(padded, 0), (1, 0)).tolist()
    pad = torch.arange(off_pad[-1])
    unpad = torch.arange(off[-1])
    cu = []
    for i, n in enumerate(counts.tolist()):
        unpad[off[i]:off[i + 1]] += off_pad[i] - off[i]
        if n != int(padded[i]):
            r = n % k
            pad[off_pad[i + 1] - k + r:off_pad[i + 1]] = \
                pad[off_pad[i + 1] - 2 * k + r:off_pad[i + 1] - k]
        pad[off_pad[i]:off_pad[i + 1]] -= off_pad[i] - off[i]
        cu += list(range(off_pad[i], off_pad[i + 1], k))
    cu.append(off_pad[-1])
    return pad.to(device), unpad.to(device), cu


class Net:
    """The forward over parameters ``P`` (``train``: BatchNorm on the batch
    moments of every point, updating ``P``'s running statistics at momentum
    0.01). ``tf32`` rounds every product's operands to TF32 (the control,
    on a device without TF32 products)."""

    tf32 = False

    def __init__(self, P: dict, cfg: dict, train: bool = False):
        self.P, self.cfg, self.train = P, cfg, train

    def rnd(self, *t):
        return tuple(round_tf32(a) for a in t) if self.tf32 else t

    def lin(self, name: str, x):
        x, weight = self.rnd(x, self.P[f"{name}.weight"])
        return F.linear(x, weight, self.P.get(f"{name}.bias"))

    def bn(self, name: str, x):
        P = self.P
        if not self.train:
            mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
        else:
            mean = x.mean(dim=0)
            var = ((x - mean) ** 2).mean(dim=0)
            n = x.shape[0]
            with torch.no_grad():
                P[f"{name}.running_mean"].mul_(0.99).add_(0.01 * mean.detach())
                P[f"{name}.running_var"].mul_(0.99).add_(0.01 * var.detach() * n / max(n - 1, 1))
        return (x - mean) * torch.rsqrt(var + BN_EPS) * P[f"{name}.weight"] + P[f"{name}.bias"]

    def ln(self, name: str, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + LN_EPS) * self.P[f"{name}.weight"] \
            + self.P[f"{name}.bias"]

    @staticmethod
    def gelu(x):
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))

    def conv(self, name: str, x, nbr):
        weight = self.P[f"{name}.weight"]
        k = nbr.shape[1]
        w = weight.view(weight.shape[0], k, x.shape[1])
        y = 0.0
        for d in range(k):
            valid = nbr[:, d] >= 0
            rows = torch.where(valid[:, None], x[nbr[:, d].clamp(min=0)], 0.0)
            a, b = self.rnd(rows, w[:, d])
            y = y + a @ b.T
        bias = self.P.get(f"{name}.bias")
        return y if bias is None else y + bias

    def perm(self, generator):
        if not self.cfg.get("shuffle_orders", True):
            return torch.arange(4)
        if generator is None:
            return torch.randperm(4)
        return torch.randperm(4, generator=generator, device=generator.device)

    def attention(self, p: str, x, stage, i: int, heads: int):
        _, order, inverse = stage["ser"]
        pad, unpad, cu = stage["patches"]
        c = x.shape[1]
        d = c // heads
        qkv = self.lin(f"{p}.qkv", x)[order[i % 4][pad]]
        out = torch.empty((qkv.shape[0], c), dtype=x.dtype, device=x.device)
        spans = list(zip(cu[:-1], cu[1:]))
        by_len: dict = {}
        for a, b in spans:
            by_len.setdefault(b - a, []).append(a)
        for length, starts in by_len.items():
            per = max(1, SCORES // (heads * length * length))
            for j in range(0, len(starts), per):
                rows = torch.tensor(starts[j:j + per], device=x.device)[:, None] + torch.arange(
                    length, device=x.device)
                t = qkv[rows].view(rows.shape[0], length, 3, heads, d).permute(2, 0, 3, 1, 4)
                q, k = self.rnd(t[0] * d ** -0.5, t[1])
                w = torch.softmax(q @ k.transpose(-2, -1), dim=-1)
                w, v = self.rnd(w, t[2])
                out[rows.reshape(-1)] = (w @ v).transpose(1, 2).reshape(-1, c)
        return self.lin(f"{p}.proj", out[unpad[inverse[i % 4]]])

    def block(self, p: str, x, stage, i: int, heads: int):
        x = x + self.ln(f"{p}.cpe.norms.0",
                        self.lin(f"{p}.cpe.linear", self.conv(f"{p}.cpe.conv", x, stage["nbr"])))
        x = x + self.attention(f"{p}.attn", self.ln(f"{p}.norms.0", x), stage, i, heads)
        h = self.gelu(self.lin(f"{p}.mlp.fc1", self.ln(f"{p}.norms.1", x)))
        return x + self.lin(f"{p}.mlp.fc2", h)

    def stage(self, g, cloud, counts, ser):
        nbr, _ = neighbours(g, counts, 1)
        pad, unpad, cu = padding(counts, self.cfg["enc_patch_size"][0], g.device)
        seg = torch.bucketize(unpad, torch.tensor(cu, device=g.device), right=True) - 1
        kept = torch.bincount(seg, minlength=len(cu) - 1)
        lengths = torch.tensor(cu, device=g.device).diff()
        self.slots["points"].append(g.shape[0])
        self.slots["conv_pairs"].append(int((nbr >= 0).sum()))
        self.slots["attn_pairs"].append(int((kept * lengths).sum()))
        return {"g": g, "cloud": cloud, "ser": ser, "nbr": nbr, "patches": (pad, unpad, cu)}

    def __call__(self, x, pos, mask, generator=None):
        cfg = self.cfg
        b, n = mask.shape
        classes = cfg["num_classes"]
        self.slots = {"points": [], "conv_pairs": [], "attn_pairs": [], "dup_points": 0}
        counts = [int(m) for m in mask.sum(dim=1)]
        if sum(counts) == 0:
            return pos.new_zeros((b, n, classes))
        feats, cells, clouds, rows = [], [], [], []
        for c in range(b):
            keep = mask[c].nonzero().squeeze(1)
            cell = torch.floor(pos[c, keep] / cfg["grid_size"])
            cells.append((cell - cell.min(dim=0).values).long() if keep.numel() else cell.long())
            feats.append(x[c, keep])
            clouds.append(torch.full_like(keep, c))
            rows.append(keep + c * n)
        g, cloud, h = torch.cat(cells), torch.cat(clouds), torch.cat(feats)
        n_stages = len(cfg["enc_depths"])
        depth = max(int(g.max()).bit_length(), n_stages - 1)
        code = torch.stack([encode(g, cloud, depth, o) for o in cfg.get("order", ORDERS)])
        ser = sorted_orders(code[self.perm(generator).to(g.device)])
        stem, self.slots["dup_points"] = neighbours(g, counts, 2)
        self.slots["conv_pairs"].append(int((stem >= 0).sum()))
        h = self.gelu(self.bn("embedding.norms.0", self.conv("embedding.conv", h, stem)))
        stages, skips, parents = [], [], []
        st = self.stage(g, cloud, counts, ser)
        for s in range(n_stages):
            if s:
                code, _, _ = st["ser"]
                cells_, parent = torch.unique(code[0] >> 3, sorted=True, return_inverse=True)
                m = cells_.numel()
                head = torch.zeros(m, dtype=torch.long, device=g.device).scatter_reduce(
                    0, parent, torch.arange(parent.numel(), device=g.device), "amin",
                    include_self=False)
                skips.append(h)
                parents.append(parent)
                y = self.lin(f"enc.{s}.down.linear", h)
                y = y.new_zeros((m, y.shape[1])).scatter_reduce(
                    0, parent[:, None].expand_as(y), y, "amax", include_self=False)
                h = self.gelu(self.bn(f"enc.{s}.down.norms.0", y))
                g, cloud = st["g"][head] >> 1, st["cloud"][head]
                counts = torch.bincount(cloud, minlength=b).tolist()
                ser = sorted_orders((code[:, head] >> 3)[self.perm(generator).to(g.device)])
                st = self.stage(g, cloud, counts, ser)
            stages.append(st)
            for i in range(cfg["enc_depths"][s]):
                h = self.block(f"enc.{s}.blocks.{i}", h, st, i, cfg["enc_num_head"][s])
        for s in reversed(range(n_stages - 1)):
            up = f"dec.{s}.up"
            skip = self.gelu(self.bn(f"{up}.proj_skip.norms.0",
                                     self.lin(f"{up}.proj_skip.linear", skips[s])))
            coarse = self.gelu(self.bn(f"{up}.proj.norms.0", self.lin(f"{up}.proj.linear", h)))
            h = skip + coarse[parents[s]]
            for i in range(cfg["dec_depths"][s]):
                h = self.block(f"dec.{s}.blocks.{i}", h, stages[s], i, cfg["dec_num_head"][s])
        logits = self.lin("fc_classif", h)
        out = logits.new_zeros((b * n, classes))
        out[torch.cat(rows)] = logits
        return out.view(b, n, classes)
