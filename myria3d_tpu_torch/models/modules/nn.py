"""Masked neural-net building blocks.

Port of ``myria3d_tpu/models/modules/nn.py:32-280`` with the reference's
pyg parameter names (``lins.{i}``, ``norms.{i}``), so the state dict that
``utils.checkpoint.flax_to_torch_state_dict`` emits loads with
``strict=True``:

- LeakyReLU negative slope 0.2;
- BatchNorm eps 1e-6, momentum from the model hparams; the running
  statistics are buffers. In training mode the batch moments are masked
  moments over the valid rows (over the valid neighbour slots for the LocSE
  encoder), normalization uses the biased variance and the running
  variance is updated with the unbiased estimate ``var * n / (n - 1)``
  (torch semantics). At eval BN is the affine of its running stats, so
  padded rows need no mask. Under sync BN (``set_sync_batchnorm``, data
  parallel training) the moments and ``n`` span every rank's batch.
- Layer order Linear -> BN -> act -> dropout, the last layer included (pyg
  MLP ``plain_last=False``). Dense layers stay ``nn.Linear``. Dropout
  draws its keep mask from an explicit ``torch.Generator``.
- The compute dtype (``nn.py:64-91,113-117``): a ``SharedMLP`` casts its
  input and its f32 weights to ``dtype`` (float32, bfloat16 or float16)
  and runs the product there; ``MaskedBatchNorm`` takes its moments and
  normalizes in f32, then casts back to its input's dtype; the LeakyReLU
  multiplies by its slope rounded to the dtype (JAX's 0.2 is weakly
  typed). Parameters and running statistics stay f32.
  :func:`set_compute_dtype` sets the dtype of every module of a net that
  has one; :func:`as_dtype` reads a config name.
- Running-stat updates skip a recomputed forward (:func:`recomputing`,
  the ``remat`` of RandLA-Net's blocks): they happen once a step, as flax's
  ``nn.remat`` discards the recompute's state.

The JAX package's channels-first twins (``SharedMLPCF``, ``DenseCF``) exist
for the TPU's lane layout; here one channels-last module serves both with
the same parameters.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from myria3d_tpu_torch.ops.masked import masked_mean, masked_var
from myria3d_tpu_torch.parallel.ddp import all_reduce_with_grad

LRELU_SLOPE = 0.2
BN_MOMENTUM = 0.01
BN_EPS = 1e-6


# the compute dtypes of ``model.neural_net_hparams.dtype`` and
# ``predict.compute_dtype`` (``myria3d_tpu/models/model.py:39-47``)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}

_state = threading.local()
_SLOPES = {dt: float(torch.tensor(LRELU_SLOPE, dtype=dt)) for dt in COMPUTE_DTYPES.values()}


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU with the slope in ``x``'s dtype: the JAX package multiplies
    a 16-bit ``x`` by 0.2 rounded to that dtype (0.2001953125 in bfloat16,
    0.199951171875 in float16), in the forward and in the gradient."""
    return F.leaky_relu(x, _SLOPES.get(x.dtype, LRELU_SLOPE))


def as_dtype(dtype: Any) -> torch.dtype:
    """A compute dtype from its config name or a ``torch.dtype``; any other
    name or dtype raises ``ValueError``."""
    if isinstance(dtype, torch.dtype) and dtype in COMPUTE_DTYPES.values():
        return dtype
    if isinstance(dtype, str) and dtype in COMPUTE_DTYPES:
        return COMPUTE_DTYPES[dtype]
    raise ValueError(f"compute dtype {dtype!r}: one of {sorted(COMPUTE_DTYPES)}")


def dtype_name(dtype: torch.dtype) -> str:
    """The config name of a compute dtype (``as_dtype``'s inverse)."""
    return next(k for k, v in COMPUTE_DTYPES.items() if v == dtype)


def set_compute_dtype(net: nn.Module, dtype: Any) -> None:
    """The compute dtype of every module of ``net`` that has one (a class
    attribute ``dtype``: the nets and their ``SharedMLP`` s)."""
    dtype = as_dtype(dtype)
    for m in net.modules():
        if isinstance(getattr(type(m), "dtype", None), torch.dtype):
            m.dtype = dtype


@contextlib.contextmanager
def recomputing():
    """While it is open, BN running-stat updates are skipped: the backward
    is recomputing a forward whose updates were made (the ``context_fn``
    of a checkpointed block)."""
    before = getattr(_state, "recomputing", False)
    _state.recomputing = True
    try:
        yield
    finally:
        _state.recomputing = before


def set_sync_batchnorm(net: nn.Module, enabled: bool) -> None:
    """Sync BN on (or off) for every BatchNorm of ``net``, and for the
    fused train route's rel statistics (``DilatedResidualBlock``)."""
    for m in net.modules():
        if hasattr(type(m), "sync_bn"):
            m.sync_bn = bool(enabled)


def global_moments(x: torch.Tensor, valid: Optional[torch.Tensor], dims: tuple):
    """(mean, biased var, count) of the rows of every rank (``valid`` None
    counts every row) in two passes, as GSPMD takes them over the global
    batch: the masked sums and the count are all-reduced, then the centred
    second moment. The gradients flow through both sums."""
    m = None if valid is None else valid[..., None].to(x.dtype)
    if m is None:
        num = x.sum(dim=dims)
        cnt = torch.full((1,), float(x.numel() // x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        num = (x * m).sum(dim=dims)
        cnt = m.sum().reshape(1)
    tot = all_reduce_with_grad(torch.cat([num, cnt]))
    n = tot[-1].clamp(min=1.0)
    mean = tot[:-1] / n
    d2 = (x - mean) ** 2
    var = all_reduce_with_grad((d2 if m is None else d2 * m).sum(dim=dims)) / n
    return mean, var, n


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the last axis of a padded batch: training mode
    normalizes with masked batch moments over every other axis (``valid``
    None counts every row), eval mode with the running stats."""

    sync_bn = False   # moments over every rank's batch (set_sync_batchnorm)

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
        if self.sync_bn:
            return global_moments(x, valid, dims)
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
        moments computed outside the module). Skipped in a recomputed
        forward (:func:`recomputing`)."""
        if getattr(_state, "recomputing", False):
            return
        unbiased = var * n / (n - 1.0).clamp(min=1.0)
        self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean.detach())
        self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * unbiased.detach())

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        # moments and normalization in f32, the result in x's dtype
        xf = x.float()
        if self.training:
            mean, var, n = self.batch_moments(xf, valid)
            self.update_running(mean, var, n)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


class SharedMLP(nn.Module):
    """Per-point MLP: [Linear -> MaskedBatchNorm -> LeakyReLU(0.2) ->
    Dropout] per layer (reference ``SharedMLP``, ``pyg_randla_net.py:97-109``);
    ``act=False`` / ``norm=False`` drop those stages for every layer.
    ``dropout`` holds one rate per layer (identity at eval; no parameters).
    The Linear layers run in ``dtype`` (input and weights cast to it)."""

    dtype = torch.float32   # the compute dtype (set_compute_dtype)

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
        dt = self.dtype
        for i, lin in enumerate(self.lins):
            x = F.linear(x.to(dt), lin.weight.to(dt), None if lin.bias is None else lin.bias.to(dt))
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
