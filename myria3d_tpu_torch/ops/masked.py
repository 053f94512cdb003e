"""Masked softmax over a dense neighbour axis and masked moments.

Port of ``myria3d_tpu/ops/masked.py``: the reference's scatter softmax
over ragged neighbourhoods becomes a softmax over the dense K axis that
only counts valid entries, and torch BatchNorm statistics over the
concatenated valid points become masked moments over the padded batch.
"""

from __future__ import annotations

import torch


def masked_softmax(scores: torch.Tensor, valid: torch.Tensor, dim: int) -> torch.Tensor:
    """Numerically stable softmax along ``dim`` over valid entries only.

    Invalid entries get weight 0; an all-invalid segment gives all zeros
    (not NaN), like scatter softmax on an empty segment.
    """
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(valid, scores, neg)
    m = masked.amax(dim=dim, keepdim=True)
    e = torch.where(valid, torch.exp(masked - m), 0.0)
    s = e.sum(dim=dim, keepdim=True)
    return e / s.clamp(min=1e-16)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """Mean of ``x`` over ``dim`` counting only mask-True entries."""
    m = mask.to(x.dtype)
    num = (x * m).sum(dim=dim, keepdim=keepdim)
    return num / m.sum(dim=dim, keepdim=keepdim).clamp(min=1.0)


def masked_var(x: torch.Tensor, mask: torch.Tensor, dim, keepdim: bool = False,
               mean: torch.Tensor | None = None) -> torch.Tensor:
    """Biased variance over mask-True entries (torch BatchNorm normalizes
    with the biased batch variance); a given ``mean`` must broadcast
    against ``x``."""
    if mean is None:
        mean = masked_mean(x, mask, dim, keepdim=True)
    m = mask.to(x.dtype)
    num = (((x - mean) ** 2) * m).sum(dim=dim, keepdim=keepdim)
    return num / m.sum(dim=dim, keepdim=keepdim).clamp(min=1.0)
