"""Cross-entropy over padded ``(B, N, C)`` logits with ignore-index semantics.

Port of ``myria3d_tpu/models/criterion.py`` (the reference's
``torch.nn.CrossEntropyLoss(ignore_index=65)`` and its class-weighted
variant): padded slots carry target 65, so masking falls out of the
ignore-index reduction. The reduction is ``sum(w_y * nll) / sum(w_y)`` over
counted targets (``w_y = 1`` without class weights), with torch-style label
smoothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class CrossEntropyLoss:
    """Masked softmax cross-entropy: ``__call__(logits, targets) -> scalar``."""

    def __init__(self, label_smoothing: float = 0.0, ignore_index: int = 65,
                 weight: Optional[Sequence[float]] = None):
        self.label_smoothing = float(label_smoothing)
        self.ignore_index = int(ignore_index)
        self.weight = None if weight is None else torch.as_tensor(weight, dtype=torch.float32)

    def __call__(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        num_classes = logits.shape[-1]
        targets = targets.long()
        counted = (targets != self.ignore_index) & (targets >= 0) & (targets < num_classes)
        safe_t = torch.where(counted, targets, 0)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, safe_t[..., None])[..., 0]
        if self.label_smoothing > 0.0:
            smooth = -logp.mean(dim=-1)
            nll = (1.0 - self.label_smoothing) * nll + self.label_smoothing * smooth
        w = counted.float()
        if self.weight is not None:
            w = self.weight.to(logits.device)[safe_t] * w
        return (nll * w).sum() / w.sum().clamp(min=1e-12)
