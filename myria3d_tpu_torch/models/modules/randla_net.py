"""RandLA-Net over fixed-shape padded point clouds: eval and train forward.

Port of ``myria3d_tpu/models/modules/randla_net.py`` (``LocalFeatureAggregation``
:37, ``DilatedResidualBlock`` :208, ``RandLANet`` :407) with the reference
``PyGRandLANet`` parameter names (``block1.lfa1.mlp_encoder.lins.0.weight``,
``fp4.nn.lins.0.weight``, ...), so weights converted from a JAX checkpoint
load with ``strict=True``.

Channel plan (``pyg_randla_net.py:40-53``): d_bottleneck = max(32,
num_classes, num_features); blocks 32/128/256/512 with random decimation by
4 between stages; decoder FP widths 256/128/32/d_bottleneck with k=1
upsampling; head [d_bottleneck, 64, 32] (dropout 0 / 0.5) -> num_classes.

Routes of the two LFAs of a block (on CUDA every search runs on K1):

- eval: K2 with the running-stat BN folded into the encoder affine. The
  JAX package routed encoder blocks 3-4 to an unfused LFA because its fused
  LFA gathered inside the search window; K2 gathers directly, so all four
  blocks share one path.
- train, fused (``fused_train_lfa`` True, or ``"auto"`` at a batch of at
  least :data:`FUSED_TRAIN_MIN_BATCH`): K5 rel statistics (once per block:
  they depend on the graph alone, so both LFAs share them), K2 forward on
  the batch-folded affine, K6 backward (``ops.cuda_lfa_train``).
- train, unfused: the LocSE geometry built once per block from one wide
  ``[pos | x]`` neighbour gather, both gathers through K4, masked-moment BN
  on the encoder over the valid neighbour slots, attention in torch.

Unlike the JAX package, neither train route needs a search window (K2, K4
and K6 gather directly), so the routing depends on the batch only.
"""

from __future__ import annotations

import torch
from torch import nn

from myria3d_tpu_torch.models.modules.nn import SharedMLP, lrelu
from myria3d_tpu_torch.ops.cuda_gather import gather_neighbors, inverse_map
from myria3d_tpu_torch.ops.cuda_knn import stage_window
from myria3d_tpu_torch.ops.cuda_lfa import idx_with_invalid, lfa_attention
from myria3d_tpu_torch.ops.cuda_lfa_train import lfa_train, locse, rel_stats
from myria3d_tpu_torch.ops.interpolate import knn_interpolate
from myria3d_tpu_torch.ops.knn import gather_rows, knn_graph
from myria3d_tpu_torch.ops.masked import masked_softmax
from myria3d_tpu_torch.ops.sampling import random_decimation

# ``fused_train_lfa: "auto"`` takes the fused train LFA from this batch size
# up: the smallest batch at which it trained faster than the unfused route in
# every timed turn on an H100 (``chip_smoke.py`` phase 8, PERF.md), on a
# quarter of the unfused route's peak memory. Below it both routes are paced
# by the host's launches and their order changes from turn to turn.
FUSED_TRAIN_MIN_BATCH = 16


def use_fused_train_lfa(setting, batch: int) -> bool:
    """Routing of ``fused_train_lfa`` True / False / ``"auto"``
    (``randla_net.py:264-267``)."""
    if setting == "auto":
        return batch >= FUSED_TRAIN_MIN_BATCH
    if isinstance(setting, bool):
        return setting
    raise ValueError(f"fused_train_lfa must be true, false or 'auto', not {setting!r}")


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

    def forward(self, x, pos, idx, neigh_valid, mask=None, rel=None, x_j=None, inv=None,
                fused=False, stats=None, idx_marked=None):
        """``x (B, N, C_in)`` -> ``(B, N, C)``. Training mode takes the fused
        route when ``fused`` (on the block's rel statistics ``stats`` and
        marked indices ``idx_marked``, when it made them), else the unfused
        one on the block's LocSE geometry ``rel (B, N, K, 10)`` (and
        ``x_j``, the neighbours' rows of ``x``, when the block gathered
        them already)."""
        if not self.training:
            enc_a, enc_c = self.folded_encoder()
            att_w = self.mlp_attention.lins[0].weight.T.contiguous()
            pooled = lfa_attention(x.contiguous(), pos, idx, neigh_valid,
                                   enc_a.contiguous(), enc_c.contiguous(), att_w)
        elif fused:
            lin, bn = self.mlp_encoder.lins[0], self.mlp_encoder.norms[0]
            pooled, mu, var, n = lfa_train(x, pos, idx, neigh_valid, lin.weight, lin.bias,
                                           bn.weight, bn.bias,
                                           self.mlp_attention.lins[0].weight, inv, stats,
                                           idx_marked)
            bn.update_running(mu, var, n)
        else:
            if x_j is None:
                x_j = gather_neighbors(x, idx, neigh_valid, inv)
            lf = torch.cat([x_j, self.mlp_encoder(rel, neigh_valid)], dim=-1)
            scores = masked_softmax(self.mlp_attention(lf), neigh_valid[..., None], dim=2)
            pooled = (scores * lf).sum(dim=2)
        return self.mlp_post_attention(pooled, mask)


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

    def forward(self, x, pos, mask, knn_window: int = 0, fused_train: bool = False):
        window = stage_window(knn_window, pos.shape[1])
        idx, _, neigh_valid = knn_graph(pos, mask, self.num_neighbors, window=window)
        shortcut = self.shortcut(x, mask)
        x = self.mlp1(x, mask)
        if not self.training:
            x = self.lfa1(x, pos, idx, neigh_valid, mask)
            x = self.lfa2(x, pos, idx, neigh_valid, mask)
        else:
            # one inverse map serves every backward scatter of the block
            inv = inverse_map(idx, neigh_valid, pos.shape[1]) if pos.is_cuda else None
            if fused_train:
                # what depends on the graph alone, once for both LFAs: the
                # kernels' marked indices and K5's rel statistics
                idx_marked = idx_with_invalid(idx, neigh_valid) if pos.is_cuda else None
                shared = dict(inv=inv, fused=True, idx_marked=idx_marked,
                              stats=rel_stats(pos, idx, neigh_valid, idx_marked))
                x = self.lfa1(x, pos, idx, neigh_valid, mask, **shared)
                x = self.lfa2(x, pos, idx, neigh_valid, mask, **shared)
            else:
                # one wide [pos | x] gather serves the LocSE geometry (built
                # once, shared by both LFAs) and lfa1's neighbour features
                g = gather_neighbors(torch.cat([pos, x], dim=-1), idx, neigh_valid, inv)
                rel = locse(pos, g[..., :3])
                x = self.lfa1(x, pos, idx, neigh_valid, mask, rel=rel, x_j=g[..., 3:])
                x = self.lfa2(x, pos, idx, neigh_valid, mask, rel=rel, inv=inv)
        return lrelu(self.mlp2(x, mask) + shortcut)


class FPModule(nn.Module):
    """Decoder stage: k=1 upsampling, skip concat, MLP (reference
    ``FPModule``, ``pyg_randla_net.py:241-253``; its MLP sits under
    ``.nn``)."""

    def __init__(self, channels, bn_momentum: float):
        super().__init__()
        self.nn = SharedMLP(channels, bn_momentum=bn_momentum)


class RandLANet(nn.Module):
    """Encoder-decoder segmentation net for padded clouds:
    ``forward(x, pos, mask, generator) -> logits (B, N, num_classes)``;
    ``generator`` draws the decimations and, in training, the dropout.

    ``knn_window > 0`` windows every search and requires x-sorted clouds:
    ``sort_inputs`` sorts them inside the forward (stable, pads last) and
    unsorts the logits; otherwise the caller sorts (``SortPointsByX``).
    Decimation keeps them sorted.
    """

    def __init__(self, num_features: int, num_classes: int, decimation: int = 4,
                 num_neighbors: int = 16, bn_momentum: float = 0.01,
                 knn_window: int = 0, sort_inputs: bool = False,
                 fused_train_lfa="auto"):
        super().__init__()
        self.decimation = decimation
        self.knn_window = knn_window
        self.sort_inputs = sort_inputs
        use_fused_train_lfa(fused_train_lfa, 0)  # validate
        self.fused_train_lfa = fused_train_lfa
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
        self.mlp_classif = SharedMLP([d_b, 64, 32], bn_momentum=bn_momentum,
                                     dropout=[0.0, 0.5])
        self.fc_classif = nn.Linear(32, num_classes)

    def forward(self, x, pos, mask, generator: torch.Generator | None = None):
        order = None
        if self.knn_window and self.sort_inputs:
            # device-side x-sort for the windowed searches (pads last)
            key = torch.where(mask, pos[..., 0], float("inf"))
            order = key.sort(dim=1, stable=True).indices
            x, pos, mask = gather_rows(x, order), gather_rows(pos, order), mask.gather(1, order)
        fused = self.training and use_fused_train_lfa(self.fused_train_lfa, x.shape[0])
        x = self.fc0(x)
        blocks = (self.block1, self.block2, self.block3, self.block4)
        skips = []  # [b1_out @N, b1_dec @N/4, b2_dec @N/16, b3_dec @N/64]
        for i, block in enumerate(blocks):
            x = block(x, pos, mask, self.knn_window, fused)
            if i == 0:
                skips.append((x, pos, mask))
            dec_idx, mask = random_decimation(mask, self.decimation, generator)
            x, pos = gather_rows(x, dec_idx), gather_rows(pos, dec_idx)
            if i < len(blocks) - 1:
                skips.append((x, pos, mask))
        x = self.mlp_summit(x, mask)
        for fp in (self.fp4, self.fp3, self.fp2, self.fp1):
            x_skip, pos_skip, mask_skip = skips.pop()
            x = knn_interpolate(x, pos, mask, pos_skip, mask_skip, k=1,
                                window=stage_window(self.knn_window, pos.shape[1]))
            x = fp.nn(torch.cat([x, x_skip], dim=-1), mask_skip)
            pos, mask = pos_skip, mask_skip
        logits = self.fc_classif(self.mlp_classif(x, mask, generator))
        if order is not None:
            logits = gather_rows(logits, order.argsort(dim=1))   # back to input order
        return logits
