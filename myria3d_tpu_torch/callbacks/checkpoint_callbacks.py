"""Best/last checkpointing — reference Lightning ``ModelCheckpoint``
(``configs/callbacks/default.yaml:15-24``: monitor val/loss_epoch, mode min,
save_top_k 1, save_last, filename epoch_{epoch:03d}).

Copied from ``myria3d_tpu/callbacks/checkpoint_callbacks.py``; imports point at the port.
In data-parallel training every rank keeps the same best score and paths
(the metrics are reduced over the ranks), rank 0 alone writes and removes
checkpoints, and a barrier follows, so every rank may then read them.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Optional

from myria3d_tpu_torch.parallel import ddp


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
        self.last_model_path = os.path.join(self.dirpath, "last")
        self._save(model, self.last_model_path, state)
        ddp.barrier()
        return os.path.abspath(self.last_model_path)

    def _save(self, model, path: str, state) -> None:
        if ddp.is_rank_zero():
            os.makedirs(self.dirpath, exist_ok=True)
            model.save_checkpoint(path, state)

    def on_validation_end(self, model, state, metrics: dict, epoch: int) -> None:
        if self.save_last:
            self.last_model_path = os.path.join(self.dirpath, "last")
            self._save(model, self.last_model_path, state)
        score = metrics.get(self.monitor)
        if score is not None and self.save_top_k >= 1 and self._is_better(float(score)):
            new_path = os.path.join(
                self.dirpath, self.filename.replace("{epoch:03d}", f"{epoch:03d}")
            )
            if (
                ddp.is_rank_zero()
                and self.best_model_path
                and self.best_model_path != new_path
                and os.path.isdir(self.best_model_path)
            ):
                shutil.rmtree(self.best_model_path, ignore_errors=True)
            self.best_score = float(score)
            self._save(model, new_path, state)
            self.best_model_path = os.path.abspath(new_path)
        ddp.barrier()
