"""Per-phase segmentation metrics from a confusion matrix on the device.

Port of ``myria3d_tpu/callbacks/metric_callbacks.py``: one masked confusion
matrix per phase accumulates on the logits' device (a ``bincount`` of
``target * C + prediction``); every metric derives from it on the host at
epoch end: micro accuracy/precision/recall/F1, macro IoU over the classes
present, and per-class precision/recall/F1/IoU (reference
``metric_callbacks.py:60-88`` naming). In data-parallel training
``compute_and_reset`` sums the phase's matrix over the ranks first, so every
rank computes the metrics of the whole epoch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from myria3d_tpu_torch.parallel import ddp


def confusion_matrix_update(cm: torch.Tensor, logits: torch.Tensor, targets: torch.Tensor,
                            mask: Optional[torch.Tensor], num_classes: int) -> torch.Tensor:
    """``cm (C, C)`` (rows target, columns prediction) plus this batch."""
    preds = logits.argmax(dim=-1).reshape(-1)
    t = targets.reshape(-1).long()
    valid = (t >= 0) & (t < num_classes)
    if mask is not None:
        valid = valid & mask.reshape(-1)
    counts = torch.bincount(t[valid] * num_classes + preds[valid],
                            minlength=num_classes * num_classes)
    return cm + counts.reshape(num_classes, num_classes).to(cm.dtype)


def metrics_from_confusion_matrix(cm: np.ndarray, class_names: Optional[Dict[int, str]] = None,
                                  prefix: str = "") -> Dict[str, float]:
    """Every reference metric from one confusion matrix."""
    cm = np.asarray(cm, np.float64)
    num_classes = cm.shape[0]
    total = cm.sum()
    diag = np.diag(cm)
    row = cm.sum(axis=1)  # target counts
    col = cm.sum(axis=0)  # prediction counts

    def safe_div(a, b):
        return np.divide(a, b, out=np.zeros_like(a, dtype=np.float64), where=b > 0)

    precision = safe_div(diag, col)
    recall = safe_div(diag, row)
    f1 = safe_div(2 * precision * recall, precision + recall)
    iou = safe_div(diag, row + col - diag)
    present = row > 0
    micro_acc = float(diag.sum() / total) if total > 0 else 0.0
    out: Dict[str, float] = {
        f"{prefix}acc": micro_acc,
        f"{prefix}precision": micro_acc,
        f"{prefix}recall": micro_acc,
        f"{prefix}f1": micro_acc,
        f"{prefix}iou": float(iou[present].mean()) if present.any() else 0.0,
    }
    names = class_names or {}
    for c in range(num_classes):
        name = names.get(c, str(c))
        out[f"{prefix}precision/{name}"] = float(precision[c])
        out[f"{prefix}recall/{name}"] = float(recall[c])
        out[f"{prefix}f1/{name}"] = float(f1[c])
        out[f"{prefix}iou/{name}"] = float(iou[c])
    return out


class ModelMetrics:
    """Accumulates a per-phase confusion matrix; computes and resets it per
    epoch (reference ``ModelMetrics``)."""

    def __init__(self, num_classes: int, classification_dict: Optional[dict] = None):
        self.num_classes = int(num_classes)
        names = list((classification_dict or {}).values())
        self.class_names = {i: n for i, n in enumerate(names)}
        self._cms: Dict[str, torch.Tensor] = {}
        self._summed: set = set()   # phases whose matrix holds every rank's

    def update(self, phase: str, logits, targets, mask=None) -> None:
        cm = self._cms.get(phase)
        if cm is None:
            cm = torch.zeros((self.num_classes, self.num_classes), dtype=torch.float64,
                             device=logits.device)
        self._cms[phase] = confusion_matrix_update(cm, logits, targets, mask, self.num_classes)

    def confusion_matrix(self, phase: str) -> np.ndarray:
        cm = self._cms.get(phase)
        if cm is None:
            return np.zeros((self.num_classes, self.num_classes))
        return cm.cpu().numpy()

    def summed(self, phase: str) -> np.ndarray:
        """The phase's matrix summed over the ranks, once per epoch (each
        rank calls this in turn, a rank without a batch with zeros; again
        before ``compute_and_reset`` it sums nothing twice)."""
        if ddp.world_size() > 1 and phase not in self._summed:
            cm = self._cms.get(phase)
            if cm is None:
                cm = torch.zeros((self.num_classes, self.num_classes), dtype=torch.float64,
                                 device=ddp.device())
            self._cms[phase] = ddp.all_reduce(cm)
            self._summed.add(phase)
        return self.confusion_matrix(phase)

    def compute_and_reset(self, phase: str) -> Dict[str, float]:
        """The phase's metrics, from its matrix summed over the ranks
        (:meth:`summed`)."""
        cm = self.summed(phase)
        self._cms.pop(phase, None)
        self._summed.discard(phase)
        return metrics_from_confusion_matrix(cm, self.class_names, prefix=f"{phase}/")
