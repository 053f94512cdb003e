"""Early stopping — reference Lightning ``EarlyStopping``
(``configs/callbacks/default.yaml:25-31``: monitor val/loss_epoch, patience 6).

Copied from ``myria3d_tpu/callbacks/early_stopping.py``; imports point at the port.
In data-parallel training the ranks decide on the same reduced metrics and
take rank 0's decision, so they stop together: a rank that stopped alone
would hang the others' next collective.
"""

from __future__ import annotations

import math

from myria3d_tpu_torch.parallel import ddp


class EarlyStopping:
    def __init__(
        self,
        monitor: str = "val/loss_epoch",
        mode: str = "min",
        patience: int = 6,
        min_delta: float = 0.0,
    ):
        self.monitor = monitor
        self.mode = mode
        self.patience = int(patience)
        self.min_delta = float(min_delta)
        self.best: float = math.inf if mode == "min" else -math.inf
        self.wait = 0
        self.should_stop = False

    def on_validation_end(self, metrics: dict) -> bool:
        score = metrics.get(self.monitor)
        if score is None:
            return self.should_stop
        score = float(score)
        improved = (
            score < self.best - self.min_delta
            if self.mode == "min"
            else score > self.best + self.min_delta
        )
        if improved:
            self.best = score
            self.wait = 0
        else:
            self.wait += 1
            # Lightning semantics: stop once wait_count >= patience.
            if self.wait >= self.patience:
                self.should_stop = True
        self.should_stop = bool(ddp.from_rank_zero(self.should_stop))
        return self.should_stop
