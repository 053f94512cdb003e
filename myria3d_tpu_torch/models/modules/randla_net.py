"""RandLA-Net eval forward over fixed-shape padded point clouds.

Port of ``myria3d_tpu/models/modules/randla_net.py`` (``LocalFeatureAggregation``
:37, ``DilatedResidualBlock`` :208, ``RandLANet`` :407) with the reference
``PyGRandLANet`` parameter names (``block1.lfa1.mlp_encoder.lins.0.weight``,
``fp4.nn.lins.0.weight``, ...), so weights converted from a JAX checkpoint
load with ``strict=True``.

Channel plan (``pyg_randla_net.py:40-53``): d_bottleneck = max(32,
num_classes, num_features); blocks 32/128/256/512 with random decimation by
4 between stages; decoder FP widths 256/128/32/d_bottleneck with k=1
upsampling; head [d_bottleneck, 64, 32] -> num_classes.

On CUDA every search runs on K1 and both LFAs of every block run on K2.
The JAX package routed encoder blocks 3-4 (768 and 192 keys) to dense XLA
search and an unfused LFA because its fused LFA gathered inside the
search window; K2 gathers directly, so all four blocks share one path.
"""

from __future__ import annotations

import torch
from torch import nn

from myria3d_tpu_torch.models.modules.nn import SharedMLP, lrelu
from myria3d_tpu_torch.ops.cuda_knn import stage_window
from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention
from myria3d_tpu_torch.ops.interpolate import knn_interpolate
from myria3d_tpu_torch.ops.knn import gather_rows, knn_graph
from myria3d_tpu_torch.ops.sampling import random_decimation


class LocalFeatureAggregation(nn.Module):
    """LocSE + attentive pooling over dense (B, N, K) neighbourhoods
    (reference ``pyg_randla_net.py:112-152``); input width channels // 2."""

    def __init__(self, channels: int, bn_momentum: float):
        super().__init__()
        self.mlp_encoder = SharedMLP([10, channels // 2], bn_momentum=bn_momentum)
        self.mlp_attention = SharedMLP([channels, channels], act=False, norm=False,
                                       bias=False)
        self.mlp_post_attention = SharedMLP([channels, channels], bn_momentum=bn_momentum)

    def folded_encoder(self):
        """The encoder Linear with its eval BatchNorm folded in:
        ``(A (C_in, 10), c (C_in,))`` with ``enc = A rel + c`` before the
        LeakyReLU."""
        lin, bn = self.mlp_encoder.lins[0], self.mlp_encoder.norms[0]
        scale, shift = bn.scale_shift()
        return lin.weight * scale[:, None], lin.bias * scale + shift

    def forward(self, x, pos, idx, neigh_valid):
        enc_a, enc_c = self.folded_encoder()
        att_w = self.mlp_attention.lins[0].weight.T.contiguous()
        pooled = lfa_attention(x.contiguous(), pos, idx, neigh_valid,
                               enc_a.contiguous(), enc_c.contiguous(), att_w)
        return self.mlp_post_attention(pooled)


class DilatedResidualBlock(nn.Module):
    """Reference ``DilatedResidualBlock`` (``pyg_randla_net.py:155-189``)."""

    def __init__(self, num_neighbors: int, d_in: int, d_out: int, bn_momentum: float):
        super().__init__()
        self.num_neighbors = num_neighbors
        self.mlp1 = SharedMLP([d_in, d_out // 8], bn_momentum=bn_momentum)
        self.shortcut = SharedMLP([d_in, d_out], act=False, bn_momentum=bn_momentum)
        self.mlp2 = SharedMLP([d_out // 2, d_out], act=False, bn_momentum=bn_momentum)
        self.lfa1 = LocalFeatureAggregation(d_out // 4, bn_momentum)
        self.lfa2 = LocalFeatureAggregation(d_out // 2, bn_momentum)

    def forward(self, x, pos, mask, knn_window: int = 0):
        window = stage_window(knn_window, pos.shape[1])
        idx, _, neigh_valid = knn_graph(pos, mask, self.num_neighbors, window=window)
        shortcut = self.shortcut(x)
        x = self.mlp1(x)
        x = self.lfa1(x, pos, idx, neigh_valid)
        x = self.lfa2(x, pos, idx, neigh_valid)
        return lrelu(self.mlp2(x) + shortcut)


class FPModule(nn.Module):
    """Decoder stage: k=1 upsampling, skip concat, MLP (reference
    ``FPModule``, ``pyg_randla_net.py:241-253``; its MLP sits under
    ``.nn``)."""

    def __init__(self, channels, bn_momentum: float):
        super().__init__()
        self.nn = SharedMLP(channels, bn_momentum=bn_momentum)


class RandLANet(nn.Module):
    """Encoder-decoder segmentation net for padded clouds:
    ``forward(x, pos, mask, generator) -> logits (B, N, num_classes)``.

    ``knn_window > 0`` windows every search and requires x-sorted input
    clouds (``SortPointsByX``); decimation keeps them sorted.
    """

    def __init__(self, num_features: int, num_classes: int, decimation: int = 4,
                 num_neighbors: int = 16, bn_momentum: float = 0.01,
                 knn_window: int = 0):
        super().__init__()
        self.decimation = decimation
        self.knn_window = knn_window
        d_b = max(32, num_classes, num_features)
        self.fc0 = nn.Linear(num_features, d_b)
        widths = (d_b, 32, 128, 256, 512)
        for i in range(4):
            self.add_module(f"block{i + 1}", DilatedResidualBlock(
                num_neighbors, widths[i], widths[i + 1], bn_momentum))
        self.mlp_summit = SharedMLP([512, 512], bn_momentum=bn_momentum)
        # decoder inputs concat the upsampled features with the decimated
        # skips (pyg_randla_net.py:48-51, 76-79)
        self.fp4 = FPModule([512 + 256, 256], bn_momentum)
        self.fp3 = FPModule([256 + 128, 128], bn_momentum)
        self.fp2 = FPModule([128 + 32, 32], bn_momentum)
        self.fp1 = FPModule([32 + 32, d_b], bn_momentum)
        self.mlp_classif = SharedMLP([d_b, 64, 32], bn_momentum=bn_momentum)
        self.fc_classif = nn.Linear(32, num_classes)

    def forward(self, x, pos, mask, generator: torch.Generator | None = None):
        x = self.fc0(x)
        blocks = (self.block1, self.block2, self.block3, self.block4)
        skips = []  # [b1_out @N, b1_dec @N/4, b2_dec @N/16, b3_dec @N/64]
        for i, block in enumerate(blocks):
            x = block(x, pos, mask, self.knn_window)
            if i == 0:
                skips.append((x, pos, mask))
            dec_idx, mask = random_decimation(mask, self.decimation, generator)
            x, pos = gather_rows(x, dec_idx), gather_rows(pos, dec_idx)
            if i < len(blocks) - 1:
                skips.append((x, pos, mask))
        x = self.mlp_summit(x)
        for fp in (self.fp4, self.fp3, self.fp2, self.fp1):
            x_skip, pos_skip, mask_skip = skips.pop()
            x = knn_interpolate(x, pos, mask, pos_skip, mask_skip, k=1,
                                window=stage_window(self.knn_window, pos.shape[1]))
            x = fp.nn(torch.cat([x, x_skip], dim=-1))
            pos, mask = pos_skip, mask_skip
        return self.fc_classif(self.mlp_classif(x))
