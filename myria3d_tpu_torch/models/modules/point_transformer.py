"""Point Transformer (PTv1) semantic segmentation over padded clouds.

Zhao, Jiang, Jia, Torr and Koltun, ICCV 2021 (arXiv:2012.09164), as the
authors' public segmentation net sets it (POSTECH-CVLab/point-transformer,
``pointtransformer_seg_repro``): planes 32/64/128/256/512, ``share_planes``
8, strides 1/4/4/4/4, ``nsample`` 8/16/16/16/16 and encoder blocks
2/3/4/6/3, the zoo's third family. Every encoder stage is one transition
down and then ``blocks - 1`` transformer blocks; every decoder stage one
transition up and then one block: 18 vector-attention layers in all.

- Transition down: at stride 1 ``ReLU(BN(Linear_nobias(x)))``; otherwise
  farthest-point sampling (K8, ``ops.fps``) into ``n_pad // stride`` slots,
  of which the first ``n_real // stride`` are real (the public code's
  count), the ``nsample`` nearest valid points of the previous stage (K1)
  and ``max_j ReLU(BN(Linear_nobias([p_j - c | x_j])))`` over the valid
  slots.
- Vector attention on the stage's self-kNN graph: ``q, k, v = Linear(x)``;
  ``r = Linear(ReLU(BN(Linear(p_j - p_i))))`` (3 -> 3 -> C);
  ``w = Linear(ReLU(BN(Linear(ReLU(BN(k_j - q_i + r))))))`` (C -> C/s ->
  C/s); ``w`` a softmax over the valid slots; ``y = sum_j (v_j + r) * w``
  with the C/s weights shared by the s channel groups
  (``(v + r).view(..., s, C/s) * w``).
- Block: ``ReLU(x + BN(Linear_nobias(ReLU(BN(attention(ReLU(BN(
  Linear_nobias(x)))))))))``.
- Transition up: at the head ``ReLU(BN(Linear([x | ReLU(Linear(mean(x)))])))``
  with the mean over each cloud's valid points; elsewhere
  ``ReLU(BN(Linear(x_skip))) + interp3(ReLU(BN(Linear(x_coarse))))``, the 3
  nearest coarse points of each skip point on K1's 4-slot list, weighed as
  PointNet++'s feature propagation weighs them (``cuda_interp.idw_combine``).
- Classifier ``fc_classif(ReLU(BN(Linear(x))))``, 32 -> 32 -> classes.

Departures from the public implementation: padded ``(B, N)`` clouds with
masks stand in for offset-packed ones (BatchNorm's training moments are
taken over the valid points, and over the valid slots of an edge tensor);
a stage computes its kNN graph once and every layer of the stage, encoder
and decoder, uses it (the public code searches again in each layer, from
the same points at the same k, which gives the same neighbours); the
propagation weighs by the inverse squared distance where the public code
takes the inverse distance; there is no dropout; BatchNorm's eps is the
zoo's 1e-6. Every search is a full scan (the net has no ``knn_window``, so
``Model.set_sorted_window`` windows only the full-cloud interpolation).

Every BatchNorm sits under a ``norms`` list, as ``nn.SharedMLP`` names
them. A vector-attention layer at eval with float32 ``x`` on a CUDA device
is K9 (``ops.cuda_vector_attention``): one kernel gathers the k and v rows
by the graph's index, builds the position encoding and the weight MLP on
chip, takes the masked softmax and writes only ``y``, in the torch
composition's float32 operations and order. K9 is instantiated at the
published widths alone (``M3D_K9_WIDTHS``): an eval float32 layer on the
card at another (C, C/s) or a larger K raises rather than run slowly
unseen. Its parameters are prepared once per state of the module (the
three BatchNorms' ``rsqrt(running_var + eps)`` beside their mean, weight
and bias, none folded into a Linear; keyed by each source tensor's
device, storage and version, so a load, a move, an optimizer step or a
training forward's running statistics prepare them again; a module built
under ``torch.inference_mode`` prepares them on every call). In training,
on the CPU and under a 16-bit compute dtype (K9 has no 16-bit
instantiation) the layer is the torch composition: at eval its neighbour
gathers are plain row gathers (an invalid slot reads row 0 and weighs 0);
in training they go through K4 (``pointnet2.neighbour_rows``), so the
backward is deterministic. Spans
(``utils.profiling.span``): ``pt.knn`` a stage's graph, ``pt.down``,
``pt.attention`` a layer, ``pt.up``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from myria3d_tpu_torch.models.modules.nn import MaskedBatchNorm
from myria3d_tpu_torch.models.modules.pointnet2 import neighbour_rows
from myria3d_tpu_torch.ops.cuda_interp import idw_combine
from myria3d_tpu_torch.ops.cuda_vector_attention import layer_params, pack, vector_attention
from myria3d_tpu_torch.ops.fps import farthest_point_sampling
from myria3d_tpu_torch.ops.knn import gather_rows, knn, knn_graph
from myria3d_tpu_torch.utils.profiling import span

NEG = -1e30
BN_MOMENTUM = 0.1   # torch's BatchNorm1d default, which the public net keeps


class Graph(NamedTuple):
    """A stage's self-kNN graph: ``idx``, ``valid`` (B, N, K) and the
    offsets ``rel = p_j - p_i`` (B, N, K, 3)."""
    idx: torch.Tensor
    valid: torch.Tensor
    rel: torch.Tensor


def stage_graph(pos: torch.Tensor, mask: torch.Tensor, k: int) -> Graph:
    """Each valid point's ``k`` nearest valid points, itself included."""
    with span("pt.knn"):
        idx, _, valid = knn_graph(pos, mask, k)
        return Graph(idx, valid, gather_rows(pos, idx) - pos[:, :, None, :])


def rows(module: nn.Module, payload: torch.Tensor, idx: torch.Tensor,
         valid: torch.Tensor) -> torch.Tensor:
    """``(B, Nq, K, P)`` rows of ``payload`` at ``idx``: a plain gather at
    eval, K4 in training (zero on invalid slots)."""
    if not module.training:
        return gather_rows(payload, idx)
    return neighbour_rows(module, payload, idx, valid)


class LinearBN(nn.Module):
    """``Linear -> BN (-> ReLU)``, as ``linear`` and ``norms.0``."""

    def __init__(self, a: int, b: int, bias: bool = True, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.linear = nn.Linear(a, b, bias=bias)
        self.norms = nn.ModuleList([MaskedBatchNorm(b)])

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.norms[0](self.linear(x), valid)
        return F.relu(x) if self.relu else x


class TransitionDown(LinearBN):
    """Stride 1: the pointwise ``LinearBN``. Otherwise FPS, the ``nsample``
    nearest previous points of each centroid, the ``LinearBN`` on
    ``[p_j - c | x_j]`` and a max over the valid slots."""

    def __init__(self, c_in: int, c_out: int, stride: int, nsample: int):
        super().__init__(c_in + (3 if stride > 1 else 0), c_out, bias=False)
        self.stride, self.nsample = stride, nsample

    def forward(self, x, pos, mask):
        if self.stride == 1:
            return super().forward(x, mask), pos, mask
        with span("pt.down"):
            m = pos.shape[1] // self.stride
            sel, _ = farthest_point_sampling(pos, mask, m)
            real = mask.sum(dim=1) // self.stride
            sel_mask = torch.arange(m, device=pos.device)[None, :] < real[:, None]
            centre = gather_rows(pos, torch.where(sel_mask, sel, 0))
            idx, _, valid = knn(centre, pos, mask, self.nsample, query_mask=sel_mask)
            rel = gather_rows(pos, idx) - centre[:, :, None, :]
            h = super().forward(torch.cat([rel, rows(self, x, idx, valid)], dim=-1), valid)
            pooled = torch.where(valid[..., None], h, NEG).amax(dim=2)
            return torch.where(sel_mask[..., None], pooled, 0.0), centre, sel_mask


class VectorAttention(nn.Module):
    """The point transformer layer on a stage's :class:`Graph`."""

    def __init__(self, c: int, share_planes: int):
        super().__init__()
        self.share_planes = share_planes
        self.linear_q = nn.Linear(c, c)
        self.linear_k = nn.Linear(c, c)
        self.linear_v = nn.Linear(c, c)
        self.linear_p = nn.ModuleList([nn.Linear(3, 3), nn.Linear(3, c)])
        self.linear_w = nn.ModuleList([nn.Linear(c, c // share_planes),
                                       nn.Linear(c // share_planes, c // share_planes)])
        self.norms = nn.ModuleList(MaskedBatchNorm(w) for w in (3, c, c // share_planes))
        self._params = None   # (key, LayerParams, packed): K9's parameters

    def kernel_params(self):
        """K9's parameters and their packed form, computed once per state:
        the key holds each source tensor's device, storage and version, so
        a load, a move or an in-place update prepares them again. Inference
        tensors (a module built under ``torch.inference_mode``) keep no
        version: theirs are prepared on every call."""
        sources = [*self.linear_p.parameters(), *self.linear_w.parameters(),
                   *(t for bn in self.norms for t in (bn.weight, bn.bias, bn.running_mean,
                                                       bn.running_var))]
        key = None if any(t.is_inference() for t in sources) else tuple(
            (t.device, t.data_ptr(), t._version) for t in sources)
        if key is None or self._params is None or self._params[0] != key:
            with torch.no_grad():
                p = layer_params(self.linear_p, self.linear_w, self.norms)
                self._params = (key, p, pack(p))
        return self._params[1], self._params[2]

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        with span("pt.attention"):
            q, k, v = self.linear_q(x), self.linear_k(x), self.linear_v(x)
            if not self.training and x.is_cuda and x.dtype == torch.float32:
                return vector_attention(q, k, v, g.idx, g.valid, g.rel, *self.kernel_params())
            return self.composed(q, k, v, g)

    def composed(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 g: Graph) -> torch.Tensor:
        """The layer on torch operations, from its ``q``, ``k`` and ``v``:
        the route in training, on the CPU and in 16 bits."""
        valid = g.valid
        k_j = rows(self, k, g.idx, valid)
        v_j = rows(self, v, g.idx, valid)
        r = self.linear_p[1](F.relu(self.norms[0](self.linear_p[0](g.rel), valid)))
        w = F.relu(self.norms[1](k_j - q[:, :, None, :] + r, valid))
        w = F.relu(self.norms[2](self.linear_w[0](w), valid))
        w = self.linear_w[1](w)
        w = torch.where(valid[..., None], w, NEG).softmax(dim=2)
        w = torch.where(valid[..., None], w, 0.0)   # a pad query has no valid slot
        b, n, kk, c = v_j.shape
        s = self.share_planes
        y = ((v_j + r).view(b, n, kk, s, c // s) * w.unsqueeze(3)).sum(dim=2)
        return y.reshape(b, n, c)


class Block(nn.Module):
    """The point transformer block: ``linear1``, ``attn`` and its ``norms.0``,
    ``linear3``, and the residual."""

    def __init__(self, c: int, share_planes: int):
        super().__init__()
        self.linear1 = LinearBN(c, c, bias=False)
        self.attn = VectorAttention(c, share_planes)
        self.norms = nn.ModuleList([MaskedBatchNorm(c)])
        self.linear3 = LinearBN(c, c, bias=False, relu=False)

    def forward(self, x: torch.Tensor, g: Graph, mask: torch.Tensor) -> torch.Tensor:
        y = self.linear1(x, mask)
        y = F.relu(self.norms[0](self.attn(y, g), mask))
        return F.relu(self.linear3(y, mask) + x)


class HeadUp(nn.Module):
    """The deepest transition up: each point's features beside the cloud's
    mean through ``linear2``, then ``linear1``."""

    def __init__(self, c: int):
        super().__init__()
        self.linear1 = LinearBN(2 * c, c)
        self.linear2 = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        with span("pt.up"):
            cnt = mask.sum(dim=1, keepdim=True).clamp(min=1).to(x.dtype)
            mean = torch.where(mask[..., None], x, 0.0).sum(dim=1) / cnt
            g = F.relu(self.linear2(mean))[:, None, :].expand_as(x)
            return self.linear1(torch.cat([x, g], dim=-1), mask)


class TransitionUp(nn.Module):
    """``linear1`` on the skip plus the 3-NN interpolation of ``linear2`` on
    the coarser stage."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.linear1 = LinearBN(c_out, c_out)
        self.linear2 = LinearBN(c_in, c_out)

    def forward(self, x, pos, mask, x_skip, pos_skip, mask_skip):
        with span("pt.up"):
            y = self.linear2(x, mask)
            idx, d2, valid = knn(pos_skip, pos, mask, 3, query_mask=mask_skip)
            up = idw_combine(rows(self, y, idx, valid), d2, valid, mask_skip)
            return self.linear1(x_skip, mask_skip) + up


class PointTransformerSeg(nn.Module):
    """``forward(x, pos, mask, generator) -> logits (B, N, num_classes)``
    float32; ``generator`` is unused (no dropout). Positions are the net's
    (``NormalizePos``: the 50 m subtile to [-1, 1]); the features enter
    through the first transition down alone."""

    def __init__(self, num_features: int, num_classes: int,
                 planes: Sequence[int] = (32, 64, 128, 256, 512),
                 blocks: Sequence[int] = (2, 3, 4, 6, 3),
                 nsample: Sequence[int] = (8, 16, 16, 16, 16),
                 stride: Sequence[int] = (1, 4, 4, 4, 4), share_planes: int = 8,
                 bn_momentum: float = BN_MOMENTUM, return_logits: bool = True):
        super().__init__()
        if not len(planes) == len(blocks) == len(nsample) == len(stride):
            raise ValueError("planes, blocks, nsample and stride need one entry a stage")
        self.nsample = list(nsample)
        self.return_logits = bool(return_logits)
        n = len(planes)
        c_in = num_features
        for i, c in enumerate(planes):
            self.add_module(f"enc{i + 1}", nn.ModuleList(
                [TransitionDown(c_in, c, stride[i], nsample[i])]
                + [Block(c, share_planes) for _ in range(blocks[i] - 1)]))
            c_in = c
        self.add_module(f"dec{n}", nn.ModuleList(
            [HeadUp(planes[-1]), Block(planes[-1], share_planes)]))
        for i in reversed(range(n - 1)):
            self.add_module(f"dec{i + 1}", nn.ModuleList(
                [TransitionUp(planes[i + 1], planes[i]), Block(planes[i], share_planes)]))
        self.cls = LinearBN(planes[0], planes[0])
        self.fc_classif = nn.Linear(planes[0], num_classes)
        for m in self.modules():
            if isinstance(m, MaskedBatchNorm):
                m.momentum = bn_momentum

    def forward(self, x: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        stages = []
        for i, k in enumerate(self.nsample):
            enc = getattr(self, f"enc{i + 1}")
            x, pos, mask = enc[0](x, pos, mask)
            g = stage_graph(pos, mask, k)
            for block in enc[1:]:
                x = block(x, g, mask)
            stages.append((x, pos, mask, g))
        n = len(stages)
        up, block = getattr(self, f"dec{n}")
        x = block(up(x, mask), stages[-1][3], mask)
        for i in reversed(range(n - 1)):
            x_skip, pos_skip, mask_skip, g = stages[i]
            up, block = getattr(self, f"dec{i + 1}")
            x = block(up(x, pos, mask, x_skip, pos_skip, mask_skip), g, mask_skip)
            pos, mask = pos_skip, mask_skip
        logits = self.fc_classif(self.cls(x, mask))
        return logits if self.return_logits else torch.log_softmax(logits, dim=-1)
