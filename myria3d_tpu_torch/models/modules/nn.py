"""Masked neural-net building blocks, eval mode.

Port of ``myria3d_tpu/models/modules/nn.py:32-280`` with the reference's
pyg parameter names (``lins.{i}``, ``norms.{i}``), so the state dict that
``myria3d_tpu.utils.torch_ckpt.flax_to_torch_state_dict`` emits loads with
``strict=True``:

- LeakyReLU negative slope 0.2;
- BatchNorm eps 1e-6, momentum from the model hparams; the running
  statistics are buffers. At eval, BN is the affine of its running stats,
  so padded rows need no mask. Train-mode statistics (masked moments) come
  with the train path in a later change: a module in training mode raises.
- Layer order Linear -> BN -> act, the last layer included (pyg MLP
  ``plain_last=False``). Dense layers stay ``nn.Linear``.

The JAX package's channels-first twins (``SharedMLPCF``, ``DenseCF``) exist
for the TPU's lane layout; here one channels-last module serves both with
the same parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.2
BN_MOMENTUM = 0.01
BN_EPS = 1e-6


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the last axis; eval mode uses the running stats."""

    def __init__(self, features: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def scale_shift(self):
        """(scale, shift) of the eval affine ``y = x * scale + shift``."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("MaskedBatchNorm runs in eval mode only")
        return (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps) \
            * self.weight + self.bias


class SharedMLP(nn.Module):
    """Per-point MLP: [Linear -> MaskedBatchNorm -> LeakyReLU(0.2)] per layer
    (reference ``SharedMLP``, ``pyg_randla_net.py:97-109``); ``act=False`` /
    ``norm=False`` drop those stages for every layer. Dropout is the
    identity at eval and has no parameters, so it is not represented."""

    def __init__(self, channels: Sequence[int], act: bool = True, norm: bool = True,
                 bias: bool = True, bn_momentum: float = BN_MOMENTUM):
        super().__init__()
        self.act = act
        self.lins = nn.ModuleList(
            nn.Linear(a, b, bias=bias) for a, b in zip(channels[:-1], channels[1:])
        )
        self.norms = nn.ModuleList(
            MaskedBatchNorm(b, momentum=bn_momentum) for b in channels[1:]
        ) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.lins):
            x = lin(x)
            if self.norms is not None:
                x = self.norms[i](x)
            if self.act:
                x = lrelu(x)
        return x
