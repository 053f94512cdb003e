"""Plain Point Transformer (Zhao et al., ICCV 2021, arXiv:2012.09164), the
segmentation net of the authors' public implementation
(POSTECH-CVLab/point-transformer, ``pointtransformer_seg_repro``): the
reference the benchmark holds the program to.

A function of a flat parameter dict (:func:`param_shapes`). Five encoder
stages, each a transition down (stride 1: Linear-BN-ReLU; stride 4:
farthest-point sampling of ``n_pad // 4`` slots whose first ``n_real // 4``
are real, the ``nsample`` nearest valid points of each centroid, a
Linear-BN-ReLU on ``[p_j - c | x_j]`` and a max over the valid slots), then
``blocks - 1`` transformer blocks; five decoder stages, each a transition
up (the head: each point beside the cloud's mean; elsewhere the skip's
Linear-BN-ReLU plus the coarser stage's, interpolated by inverse squared
distance over the 3 nearest) and one block; a Linear-BN-ReLU and the
classifier. A block: Linear-BN-ReLU, the vector attention, BN-ReLU,
Linear-BN, the residual, ReLU. The vector attention over a stage's
self-kNN graph (computed once a stage, at its ``nsample``): ``q, k, v``
Linears, the position encoding ``Linear(ReLU(BN(Linear(p_j - p_i))))``,
the weights ``Linear(ReLU(BN(Linear(ReLU(BN(k_j - q_i + r))))))`` (C -> C/s
-> C/s), a softmax over the valid slots, and ``sum_j (v_j + r) * w`` with
the C/s weights shared by the s channel groups.

Every Linear is a float32 product; BatchNorm at eval the affine of its
running statistics, eps 1e-6; the searches full scans
(:mod:`perfbench.reference.search`; a ``knn_window`` in the configuration
is ignored: the net has none). ``slots`` counts, for each search of the
last call, the valid (query, neighbour) slots: the stage graphs
(``"graph"``), the centroids' searches (``"down"``) and the 3-NN lists of
the transitions up (``"up"``, deepest first). Imports nothing of the
program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import search
from perfbench.reference.randla_net import Net as _RandLA
from perfbench.reference.randla_net import round_tf32

NEG = -1e30
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def param_shapes(cfg: dict) -> dict:
    """Every parameter and BatchNorm statistic: ``{name: shape}``."""
    planes, blocks, stride = cfg["planes"], cfg["blocks"], cfg["stride"]
    s = cfg["share_planes"]
    shapes: dict = {}

    def lin(name, a, b, bias=True):
        shapes[f"{name}.weight"] = (b, a)
        if bias:
            shapes[f"{name}.bias"] = (b,)

    def bn(name, c):
        shapes.update({f"{name}.{leaf}": (c,) for leaf in BN_LEAVES})

    def linear_bn(name, a, b, bias=True):
        lin(f"{name}.linear", a, b, bias)
        bn(f"{name}.norms.0", b)

    def block(p, c):
        linear_bn(f"{p}.linear1", c, c, bias=False)
        for q in "qkv":
            lin(f"{p}.attn.linear_{q}", c, c)
        lin(f"{p}.attn.linear_p.0", 3, 3)
        lin(f"{p}.attn.linear_p.1", 3, c)
        lin(f"{p}.attn.linear_w.0", c, c // s)
        lin(f"{p}.attn.linear_w.1", c // s, c // s)
        for i, w in enumerate((3, c, c // s)):
            bn(f"{p}.attn.norms.{i}", w)
        bn(f"{p}.norms.0", c)
        linear_bn(f"{p}.linear3", c, c, bias=False)

    c_in = cfg["num_features"]
    for i, c in enumerate(planes):
        linear_bn(f"enc{i + 1}.0", c_in + (3 if stride[i] > 1 else 0), c, bias=False)
        for j in range(1, blocks[i]):
            block(f"enc{i + 1}.{j}", c)
        c_in = c
    n = len(planes)
    linear_bn(f"dec{n}.0.linear1", 2 * planes[-1], planes[-1])
    lin(f"dec{n}.0.linear2", planes[-1], planes[-1])
    block(f"dec{n}.1", planes[-1])
    for i in reversed(range(n - 1)):
        linear_bn(f"dec{i + 1}.0.linear1", planes[i], planes[i])
        linear_bn(f"dec{i + 1}.0.linear2", planes[i + 1], planes[i])
        block(f"dec{i + 1}.1", planes[i])
    linear_bn("cls", planes[0], planes[0])
    lin("fc_classif", planes[0], cfg["num_classes"])
    return shapes


class Net(_RandLA):
    """The forward over parameters ``P`` (``train``: batch moments over the
    valid points or slots, as the base class takes them)."""

    def lin(self, name: str, x):
        weight = self.P[f"{name}.weight"]
        if self.tf32:
            x, weight = round_tf32(x), round_tf32(weight)
        return F.linear(x, weight, self.P.get(f"{name}.bias"))

    def linear_bn(self, name: str, x, valid, relu: bool = True):
        x = self.bn(f"{name}.norms.0", self.lin(f"{name}.linear", x), valid)
        return F.relu(x) if relu else x

    def graph(self, pos, mask, k: int):
        idx, _, valid = search.knn(pos, pos, mask, k, query_mask=mask)
        self.slots["graph"].append(int(valid.sum()))
        return idx, valid, search.gather_rows(pos, idx) - pos[:, :, None, :]

    def down(self, name: str, x, pos, mask, stride: int, k: int):
        m = pos.shape[1] // stride
        sel, _ = search.farthest_point_sampling(pos, mask, m)
        real = mask.sum(dim=1) // stride
        sel_mask = torch.arange(m, device=pos.device)[None, :] < real[:, None]
        centre = search.gather_rows(pos, torch.where(sel_mask, sel, 0))
        idx, _, valid = search.knn(centre, pos, mask, k, query_mask=sel_mask)
        self.slots["down"].append(int(valid.sum()))
        rel = search.gather_rows(pos, idx) - centre[:, :, None, :]
        h = self.linear_bn(name, torch.cat([rel, search.gather_rows(x, idx)], dim=-1), valid)
        pooled = torch.where(valid[..., None], h, NEG).amax(dim=2)
        return torch.where(sel_mask[..., None], pooled, 0.0), centre, sel_mask

    def attention(self, p: str, x, graph):
        idx, valid, rel = graph
        q = self.lin(f"{p}.linear_q", x)
        k_j = search.gather_rows(self.lin(f"{p}.linear_k", x), idx)
        v_j = search.gather_rows(self.lin(f"{p}.linear_v", x), idx)
        r = self.lin(f"{p}.linear_p.1",
                     F.relu(self.bn(f"{p}.norms.0", self.lin(f"{p}.linear_p.0", rel), valid)))
        w = F.relu(self.bn(f"{p}.norms.1", k_j - q[:, :, None, :] + r, valid))
        w = F.relu(self.bn(f"{p}.norms.2", self.lin(f"{p}.linear_w.0", w), valid))
        w = self.lin(f"{p}.linear_w.1", w)
        w = torch.where(valid[..., None], w, NEG).softmax(dim=2)
        w = torch.where(valid[..., None], w, 0.0)
        b, n, kk, c = v_j.shape
        s = self.cfg["share_planes"]
        y = ((v_j + r).view(b, n, kk, s, c // s) * w.unsqueeze(3)).sum(dim=2)
        return y.reshape(b, n, c)

    def block(self, p: str, x, graph, mask):
        y = self.linear_bn(f"{p}.linear1", x, mask)
        y = F.relu(self.bn(f"{p}.norms.0", self.attention(f"{p}.attn", y, graph), mask))
        return F.relu(self.linear_bn(f"{p}.linear3", y, mask, relu=False) + x)

    def interp3(self, x, pos, mask, pos_t, mask_t):
        """Inverse squared distance over the 3 nearest valid coarse points."""
        idx, d2, valid = search.knn(pos_t, pos, mask, 3, query_mask=mask_t)
        self.slots["up"].append(int(valid.sum()))
        w = torch.where(valid, 1.0 / d2.clamp(min=1e-16), 0.0)
        out = (search.gather_rows(x, idx) * w[..., None]).sum(dim=2)
        out = out / w.sum(dim=2, keepdim=True).clamp(min=1e-16)
        return torch.where(mask_t[..., None], out, 0.0)

    def __call__(self, x, pos, mask, generator=None):
        cfg = self.cfg
        self.slots = {"graph": [], "down": [], "up": []}
        stages = []
        for i, (stride, k) in enumerate(zip(cfg["stride"], cfg["nsample"])):
            if stride == 1:
                x = self.linear_bn(f"enc{i + 1}.0", x, mask)
            else:
                x, pos, mask = self.down(f"enc{i + 1}.0", x, pos, mask, stride, k)
            graph = self.graph(pos, mask, k)
            for j in range(1, cfg["blocks"][i]):
                x = self.block(f"enc{i + 1}.{j}", x, graph, mask)
            stages.append((x, pos, mask, graph))
        n = len(stages)
        cnt = mask.sum(dim=1, keepdim=True).clamp(min=1).to(x.dtype)
        mean = torch.where(mask[..., None], x, 0.0).sum(dim=1) / cnt
        g = F.relu(self.lin(f"dec{n}.0.linear2", mean))[:, None, :].expand_as(x)
        x = self.linear_bn(f"dec{n}.0.linear1", torch.cat([x, g], dim=-1), mask)
        x = self.block(f"dec{n}.1", x, stages[-1][3], mask)
        for i in reversed(range(n - 1)):
            x_skip, pos_skip, mask_skip, graph = stages[i]
            coarse = self.linear_bn(f"dec{i + 1}.0.linear2", x, mask)
            x = (self.linear_bn(f"dec{i + 1}.0.linear1", x_skip, mask_skip)
                 + self.interp3(coarse, pos, mask, pos_skip, mask_skip))
            x = self.block(f"dec{i + 1}.1", x, graph, mask_skip)
            pos, mask = pos_skip, mask_skip
        return self.lin("fc_classif", self.linear_bn("cls", x, mask))
