"""Optimizers and host-side LR schedulers.

Port of ``myria3d_tpu/models/optimizers.py`` (the reference's
``configs/model/optimizer/{Adam,AdamW,SGD}.yaml`` and
``configs/model/lr_scheduler/{ReduceLROnPlateau,OneCycleLR}.yaml``).
The factories take ``lr`` and return a function of the parameters that
builds the ``torch.optim`` optimizer; their updates equal optax's:
``torch.optim.Adam`` puts ``eps`` outside the square root as
``optax.adam`` does, ``AdamW``'s decoupled decay ``p (1 - lr wd)`` equals
optax's ``lr (u + wd p)``, and SGD's momentum buffer starts at the first
gradient in both. The trainer rescales the learning rate in place
(:func:`set_learning_rate_scale`); the schedulers are host-side
controllers that return that scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import torch

Factory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Factory:
    """``torch.optim.Adam`` (optax ``adam`` defaults)."""
    return lambda params: torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def adamw(lr: float, weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> Factory:
    return lambda params: torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                                            weight_decay=weight_decay)


def sgd(lr: float, momentum: float = 0.9) -> Factory:
    return lambda params: torch.optim.SGD(params, lr=lr, momentum=momentum)


def set_learning_rate_scale(optimizer: torch.optim.Optimizer, base_lr: float,
                            scale: float) -> None:
    """Set every parameter group's learning rate to ``base_lr * scale``."""
    for group in optimizer.param_groups:
        group["lr"] = base_lr * scale


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side plateau controller (torch ``ReduceLROnPlateau`` semantics;
    reference config mode=min, factor=0.5, patience=20, cooldown=5). Call
    ``step(metric)`` once per validation epoch; it returns the LR scale."""

    mode: str = "min"
    factor: float = 0.5
    patience: int = 10
    cooldown: int = 0
    threshold: float = 1e-4

    def __post_init__(self):
        self.best: Optional[float] = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.scale = 1.0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            if self.cooldown_counter > 0:
                self.cooldown_counter -= 1
            else:
                self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.scale *= self.factor
            self.num_bad_epochs = 0
            self.cooldown_counter = self.cooldown
        return self.scale


@dataclasses.dataclass
class OneCycleLR:
    """torch ``OneCycleLR`` (cosine strategy) as a per-step scale relative to
    ``max_lr``: from ``1 / div_factor`` up to 1 over ``pct_start`` of the
    steps, then down to ``1 / (div_factor * final_div_factor)``. ``step()``
    after every optimizer step returns the next scale."""

    epochs: int = 100
    steps_per_epoch: int = 100
    pct_start: float = 0.3
    div_factor: float = 10.0
    final_div_factor: float = 1000.0

    def __post_init__(self):
        self.total_steps = max(1, self.epochs * self.steps_per_epoch)
        self._step = 0
        self.scale = self.scale_at(0)

    def scale_at(self, step: int) -> float:
        up = max(1, int(self.total_steps * self.pct_start))
        initial = 1.0 / self.div_factor
        final = initial / self.final_div_factor
        s = min(step, self.total_steps)
        if s < up:
            t = s / up
            return initial + (1.0 - initial) * 0.5 * (1 - math.cos(math.pi * t))
        t = (s - up) / max(1, self.total_steps - up)
        return final + (1.0 - final) * 0.5 * (1 + math.cos(math.pi * t))

    def step(self, metric: Optional[float] = None) -> float:
        self._step += 1
        self.scale = self.scale_at(self._step)
        return self.scale

    @property
    def per_step(self) -> bool:
        return True
