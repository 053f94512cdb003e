"""Masked softmax over a dense neighbour axis.

Port of ``myria3d_tpu/ops/masked.py:17``: the reference's scatter softmax
over ragged neighbourhoods becomes a softmax over the dense K axis that
only counts valid entries.
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
