"""Best/last checkpointing — reference Lightning ``ModelCheckpoint``
(``configs/callbacks/default.yaml:15-24``: monitor val/loss_epoch, mode min,
save_top_k 1, save_last, filename epoch_{epoch:03d}).

Copied from ``myria3d_tpu/callbacks/checkpoint_callbacks.py``; imports point at the port.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Optional


class ModelCheckpoint:
    def __init__(
        self,
        dirpath: str = "checkpoints/",
        monitor: str = "val/loss_epoch",
        mode: str = "min",
        save_top_k: int = 1,
        save_last: bool = True,
        filename: str = "epoch_{epoch:03d}",
    ):
        self.dirpath = dirpath
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.filename = filename
        self.best_score: float = math.inf if mode == "min" else -math.inf
        self.best_model_path: Optional[str] = None
        self.last_model_path: Optional[str] = None

    def _is_better(self, score: float) -> bool:
        return score < self.best_score if self.mode == "min" else score > self.best_score

    def save_interrupt(self, model, state) -> str:
        """Preemption save: write the "last" checkpoint (weights + optimizer
        state) immediately — called by the Trainer on SIGTERM/SIGINT so an
        evicted run resumes from the in-epoch state via ``model.ckpt_path``."""
        os.makedirs(self.dirpath, exist_ok=True)
        self.last_model_path = os.path.join(self.dirpath, "last")
        return model.save_checkpoint(self.last_model_path, state)

    def on_validation_end(self, model, state, metrics: dict, epoch: int) -> None:
        os.makedirs(self.dirpath, exist_ok=True)
        if self.save_last:
            self.last_model_path = os.path.join(self.dirpath, "last")
            model.save_checkpoint(self.last_model_path, state)
        score = metrics.get(self.monitor)
        if score is None or self.save_top_k < 1:
            return
        if self._is_better(float(score)):
            new_path = os.path.join(
                self.dirpath, self.filename.replace("{epoch:03d}", f"{epoch:03d}")
            )
            if (
                self.best_model_path
                and self.best_model_path != new_path
                and os.path.isdir(self.best_model_path)
            ):
                shutil.rmtree(self.best_model_path, ignore_errors=True)
            self.best_score = float(score)
            self.best_model_path = model.save_checkpoint(new_path, state)
