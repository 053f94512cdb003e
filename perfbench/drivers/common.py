"""What the drivers share: the run's context, building the program's model
from a configuration file, the device's synchronisation and the host
clock since the process started."""

from __future__ import annotations

import importlib
import os
import time
from dataclasses import dataclass, field

import torch


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``, jiffies)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start / os.sysconf("SC_CLK_TCK")


@dataclass
class Ctx:
    """One run: the cell, its configuration and traffic, the seed, the
    window's length, whether it traces, and the device."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    start_age_s: float = 0.0         # process age at ``t0``
    control: bool = False            # also read the lower-precision control
    t0: float = field(default_factory=time.perf_counter)

    marks: list = field(default_factory=list)   # (set-up phase, seconds since start)

    def since_start(self) -> float:
        return self.start_age_s + time.perf_counter() - self.t0

    def mark(self, phase: str) -> None:
        """The end of a set-up phase, for the split of ``setup_s``."""
        self.marks.append((phase, round(self.since_start(), 3)))

    @property
    def reference(self):
        return importlib.import_module(f"perfbench.reference.{self.config['reference']}")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def build_program_model(ctx: Ctx, weights: dict):
    """The program's ``Model`` for the configuration, on the device, with the
    seeded weights (loaded strictly: names and shapes must match)."""
    from myria3d_tpu_torch.models.model import build_model

    cfg = ctx.config
    model = build_model(cfg["neural_net_class_name"], dict(cfg["neural_net_hparams"]),
                        lr=cfg.get("lr", 1e-3), interpolation_k=cfg["interpolation_k"],
                        classification_dict=cfg["classification_dict"])
    model.net.load_state_dict({k: v.clone() for k, v in weights.items()}, strict=True)
    model = model.to(ctx.device)
    if ctx.device.type == "cuda":
        from myria3d_tpu_torch import _ext

        ctx.mark("model")
        _ext.lib()   # the kernels' library: built by nvcc on a checkout's first run, else loaded
        ctx.mark("kernel library")
    return model


def tf32(enabled: bool) -> None:
    """TF32 products on or off for float32 matmuls (the reference runs with
    them off: float32 is what the configurations state; on is the control's
    lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
