"""Masked neural-net building blocks.

Port of ``myria3d_tpu/models/modules/nn.py:32-280`` with the reference's
pyg parameter names (``lins.{i}``, ``norms.{i}``), so the state dict that
``myria3d_tpu.utils.torch_ckpt.flax_to_torch_state_dict`` emits loads with
``strict=True``:

- LeakyReLU negative slope 0.2;
- BatchNorm eps 1e-6, momentum from the model hparams; the running
  statistics are buffers. In training mode the batch moments are masked
  moments over the valid rows (over the valid neighbour slots for the LocSE
  encoder), normalization uses the biased variance and the running
  variance is updated with the unbiased estimate ``var * n / (n - 1)``
  (torch semantics). At eval BN is the affine of its running stats, so
  padded rows need no mask.
- Layer order Linear -> BN -> act -> dropout, the last layer included (pyg
  MLP ``plain_last=False``). Dense layers stay ``nn.Linear``. Dropout
  draws its keep mask from an explicit ``torch.Generator``.

The JAX package's channels-first twins (``SharedMLPCF``, ``DenseCF``) exist
for the TPU's lane layout; here one channels-last module serves both with
the same parameters.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from myria3d_tpu_torch.ops.masked import masked_mean, masked_var

LRELU_SLOPE = 0.2
BN_MOMENTUM = 0.01
BN_EPS = 1e-6


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the last axis of a padded batch: training mode
    normalizes with masked batch moments over every other axis (``valid``
    None counts every row), eval mode with the running stats."""

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

    def batch_moments(self, x: torch.Tensor, valid: Optional[torch.Tensor]):
        """(mean, biased var, count) over every axis but the last."""
        dims = tuple(range(x.dim() - 1))
        if valid is None:
            mean = x.mean(dim=dims)
            var = x.var(dim=dims, unbiased=False)
            n = torch.tensor(float(x.numel() // x.shape[-1]), device=x.device)
            return mean, var, n
        vmask = valid[..., None]
        mean = masked_mean(x, vmask, dim=dims)
        var = masked_var(x, vmask, dim=dims, mean=mean)
        return mean, var, valid.sum().to(x.dtype).clamp(min=1.0)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor, n: torch.Tensor) -> None:
        """Running-stat update from batch moments (biased ``var`` over ``n``
        rows), in place: ``r = (1 - m) r + m batch`` with the unbiased
        variance (``nn.py:79-85``, and ``update_stats`` at ``:154-167`` for
        moments computed outside the module)."""
        unbiased = var * n / (n - 1.0).clamp(min=1.0)
        self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean.detach())
        self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased.detach())

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            mean, var, n = self.batch_moments(x, valid)
            self.update_running(mean, var, n)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class SharedMLP(nn.Module):
    """Per-point MLP: [Linear -> MaskedBatchNorm -> LeakyReLU(0.2) ->
    Dropout] per layer (reference ``SharedMLP``, ``pyg_randla_net.py:97-109``);
    ``act=False`` / ``norm=False`` drop those stages for every layer.
    ``dropout`` holds one rate per layer (identity at eval; no parameters)."""

    def __init__(self, channels: Sequence[int], act: bool = True, norm: bool = True,
                 bias: bool = True, bn_momentum: float = BN_MOMENTUM,
                 dropout: Optional[Sequence[float]] = None):
        super().__init__()
        self.act = act
        self.dropout = list(dropout) if dropout is not None else None
        self.lins = nn.ModuleList(
            nn.Linear(a, b, bias=bias) for a, b in zip(channels[:-1], channels[1:])
        )
        self.norms = nn.ModuleList(
            MaskedBatchNorm(b, momentum=bn_momentum) for b in channels[1:]
        ) if norm else None

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i, lin in enumerate(self.lins):
            x = lin(x)
            if self.norms is not None:
                x = self.norms[i](x, valid)
            if self.act:
                x = lrelu(x)
            rate = self.dropout[i] if self.dropout is not None else 0.0
            if self.training and rate > 0.0:
                x = dropout(x, rate, generator)
        return x


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): keep with probability
    ``1 - rate`` and rescale by its inverse; the draws come from
    ``generator``."""
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draw < keep, x / keep, 0.0)
