"""PointNet++ (SSG) semantic segmentation over padded clouds.

Port of ``myria3d_tpu/models/modules/pointnet2.py`` (``SetAbstraction``
:30, ``FeaturePropagation`` :69, ``PointNet2`` :89), the model zoo's second
family: masked farthest-point sampling (K8, ``ops.fps``), the ball query
(the K nearest valid points inside the radius, on K1), a grouped PointNet
with a masked max-pool, and k=3 inverse-distance feature propagation (K1's
search, then the weighting in torch). Same hparams and defaults; the
parameter names are those ``utils.checkpoint.flax_to_torch_state_dict``
gives the JAX tree (``fc0.lins.0``, ``sa1.pointnet.lins.2``,
``fp4.nn.mlp.lins.0``, ``head.norms.0``, ``fc_classif``), so converted
weights load with ``strict=True``.

In training the neighbour gathers of each set abstraction (``[pos | x]``
rows) and of each feature propagation go through K4
(``ops.cuda_gather.gather_neighbors``, one inverse map per graph), so their
backward is a deterministic scatter and the gradients are bit-identical
from run to run. K4 writes zeros on invalid slots where the JAX package
reads row 0; neither reaches a result: a set abstraction sets those slots
to -1e30 before its max-pool (and its BatchNorm moments skip them), and the
interpolation weighs them 0. At eval the gathers are plain row gathers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from myria3d_tpu_torch.models.modules.nn import BN_MOMENTUM, SharedMLP
from myria3d_tpu_torch.ops.cuda_gather import gather_neighbors, gather_neighbors_plain, inverse_map
from myria3d_tpu_torch.ops.cuda_interp import idw_combine
from myria3d_tpu_torch.ops.fps import farthest_point_sampling
from myria3d_tpu_torch.ops.knn import ball_query, gather_rows, knn

NEG = -1e30
FP_WIDTHS = (256, 256, 128, 128)   # the decoder's widths, deepest first (pointnet2.py:127)


def neighbour_rows(module: nn.Module, payload: torch.Tensor, idx: torch.Tensor,
                   neigh_valid: torch.Tensor) -> torch.Tensor:
    """``(B, Nq, K, P)`` rows of ``payload`` at ``idx``, zero on invalid
    slots: through K4 (with the graph's inverse map on the card) in
    training, a plain gather otherwise."""
    if not module.training:
        return gather_neighbors_plain(payload, idx, neigh_valid)
    inv = inverse_map(idx, neigh_valid, payload.shape[1]) if payload.is_cuda else None
    return gather_neighbors(payload, idx, neigh_valid, inv)


class SetAbstraction(nn.Module):
    """FPS -> ball query -> grouped PointNet -> masked max-pool. Input width
    ``in_channels``; the PointNet reads ``[x_j | (pos_j - centre) / r]``."""

    def __init__(self, in_channels: int, decimation: int, radius: float, num_neighbors: int,
                 mlp: Sequence[int], bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.decimation = decimation
        self.radius = radius
        self.num_neighbors = num_neighbors
        self.pointnet = SharedMLP([in_channels + 3, *mlp], bn_momentum=bn_momentum)

    def forward(self, x, pos, mask):
        m = max(1, pos.shape[1] // self.decimation)
        sel_idx, sel_mask = farthest_point_sampling(pos, mask, m)
        new_pos = gather_rows(pos, sel_idx)                              # (B, M, 3)
        idx, _, neigh_valid = ball_query(new_pos, pos, mask, self.num_neighbors, self.radius,
                                         query_mask=sel_mask)
        g = neighbour_rows(self, torch.cat([pos, x], dim=-1), idx, neigh_valid)
        rel = (g[..., :3] - new_pos[:, :, None, :]) / self.radius
        h = self.pointnet(torch.cat([g[..., 3:], rel], dim=-1), neigh_valid)
        pooled = torch.where(neigh_valid[..., None], h, NEG).amax(dim=2)  # (B, M, C')
        return torch.where(sel_mask[..., None], pooled, 0.0), new_pos, sel_mask


class FeaturePropagation(nn.Module):
    """k-NN interpolation up, skip concat, MLP (k=3, classic PointNet++).
    Its MLP sits at ``nn.mlp``: the checkpoint layout nests every ``fp{i}``
    module under ``.nn`` (the reference's pyg FP modules)."""

    def __init__(self, in_channels: int, mlp: Sequence[int], k: int = 3,
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.k = k
        self.nn = nn.ModuleDict({"mlp": SharedMLP([in_channels, *mlp], bn_momentum=bn_momentum)})

    def forward(self, x, pos, mask, x_skip, pos_skip, mask_skip):
        idx, d2, neigh_valid = knn(pos_skip, pos, mask, self.k, query_mask=mask_skip)
        feats = neighbour_rows(self, x, idx, neigh_valid)                # (B, Nt, k, C)
        up = idw_combine(feats, d2, neigh_valid, mask_skip)
        if x_skip is not None:
            up = torch.cat([up, x_skip], dim=-1)
        return self.nn["mlp"](up, mask_skip)


class PointNet2(nn.Module):
    """4-stage SSG PointNet++ encoder-decoder for padded clouds:
    ``forward(x, pos, mask, generator) -> logits (B, N, num_classes)``;
    ``generator`` draws the head's dropout in training.

    Radii are in normalized subtile units (``NormalizePos`` maps the 50 m
    subtile to [-1, 1]). Stage widths ``w`` give set-abstraction MLPs
    ``[w/2, w/2, w]``; the decoder's widths are 256/256/128/128.
    """

    def __init__(self, num_features: int, num_classes: int, decimation: int = 4,
                 num_neighbors: int = 32, radii: Sequence[float] = (0.05, 0.1, 0.2, 0.4),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.fc0 = SharedMLP([num_features, 32], bn_momentum=bn_momentum)
        in_widths = [32, *widths]
        self.n_stages = len(radii)
        for i, (r, w) in enumerate(zip(radii, widths)):
            self.add_module(f"sa{i + 1}", SetAbstraction(
                in_widths[i], decimation, r, num_neighbors, [w // 2, w // 2, w], bn_momentum))
        width = in_widths[self.n_stages]
        for j in range(self.n_stages):
            skip = in_widths[self.n_stages - 1 - j]
            self.add_module(f"fp{4 - j}", FeaturePropagation(
                width + skip, [FP_WIDTHS[j]], bn_momentum=bn_momentum))
            width = FP_WIDTHS[j]
        self.head = SharedMLP([width, 128], bn_momentum=bn_momentum, dropout=[0.5])
        self.fc_classif = nn.Linear(128, num_classes)

    def forward(self, x: Optional[torch.Tensor], pos: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.fc0(x if x is not None else pos, mask)
        skips = [(x, pos, mask)]
        for i in range(self.n_stages):
            x, pos, mask = getattr(self, f"sa{i + 1}")(x, pos, mask)
            skips.append((x, pos, mask))
        for j in range(self.n_stages):
            x_skip, pos_skip, mask_skip = skips[len(skips) - 2 - j]
            x = getattr(self, f"fp{4 - j}")(x, pos, mask, x_skip, pos_skip, mask_skip)
            pos, mask = pos_skip, mask_skip
        return self.fc_classif(self.head(x, mask, generator))
