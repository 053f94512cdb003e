"""CSV metrics logger and LR monitor.

Port of ``myria3d_tpu/callbacks/logging_callbacks.py`` (``CSVLogger``,
``LearningRateMonitor``) for one process: one ``metrics.csv`` with a
union-of-keys header and one row per logged step or epoch, plus
``hparams.yaml``. The Comet logger needs a network and is not ported.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional


class CSVLogger:
    """Metrics rows to ``<save_dir>/<name>/<version>/metrics.csv``."""

    def __init__(self, save_dir: str, name: str = "csv/", version: Optional[str] = None):
        if version is None:
            base = os.path.join(save_dir, name)
            os.makedirs(base, exist_ok=True)
            existing = [d for d in os.listdir(base)
                        if d.startswith("version_") and d[len("version_"):].isdigit()]
            version = f"version_{len(existing)}"
        self.log_dir = os.path.join(save_dir, name, version)
        os.makedirs(self.log_dir, exist_ok=True)
        self.metrics_path = os.path.join(self.log_dir, "metrics.csv")
        self._rows: List[Dict[str, float]] = []
        self._keys: List[str] = []

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        row = {"step": step, **{k: _scalar(v) for k, v in metrics.items()}}
        self._rows.append(row)
        for k in row:
            if k not in self._keys:
                self._keys.append(k)
        with open(self.metrics_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._keys)
            writer.writeheader()
            writer.writerows(self._rows)

    def log_hyperparams(self, params: dict) -> None:
        from myria3d_tpu.utils.config import to_yaml

        with open(os.path.join(self.log_dir, "hparams.yaml"), "w") as f:
            f.write(to_yaml(params))


def _scalar(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


class LearningRateMonitor:
    """Adds the current LR to each step's metrics row (reference
    ``LearningRateMonitor``, ``callbacks/default.yaml:10-13``)."""

    def __init__(self, logging_interval: str = "step"):
        self.logging_interval = logging_interval

    def metrics(self, lr: float) -> Dict[str, float]:
        return {"lr-current": float(lr)}
