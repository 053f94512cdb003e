"""Loggers and LR monitor.

Port of ``myria3d_tpu/callbacks/logging_callbacks.py`` (``CSVLogger``,
``CometLogger``, ``LearningRateMonitor``). ``CSVLogger``: one
``metrics.csv`` with a union-of-keys header and one row per logged step or
epoch, plus ``hparams.yaml``. ``CometLogger`` sends the same to a Comet
experiment; it imports ``comet_ml`` only when it has an ``api_key``, and
without one, with ``disabled``, or without ``comet_ml`` (a warning) it does
nothing, so ``logger=comet`` composes and fits with no network. Both are
written by rank 0 alone in data-parallel training (the other ranks'
loggers make no directory, no experiment, and write nothing).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

from myria3d_tpu_torch.parallel import ddp


class CSVLogger:
    """Metrics rows to ``<save_dir>/<name>/<version>/metrics.csv``."""

    def __init__(self, save_dir: str, name: str = "csv/", version: Optional[str] = None):
        self.writes = ddp.is_rank_zero()
        if version is None and self.writes:
            base = os.path.join(save_dir, name)
            os.makedirs(base, exist_ok=True)
            existing = [d for d in os.listdir(base)
                        if d.startswith("version_") and d[len("version_"):].isdigit()]
            version = f"version_{len(existing)}"
        self.log_dir = os.path.join(save_dir, name, version or "")
        if self.writes:
            os.makedirs(self.log_dir, exist_ok=True)
        self.metrics_path = os.path.join(self.log_dir, "metrics.csv")
        self._rows: List[Dict[str, float]] = []
        self._keys: List[str] = []

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        if not self.writes:
            return
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
        if not self.writes:
            return
        from myria3d_tpu_torch.utils.config import to_yaml

        with open(os.path.join(self.log_dir, "hparams.yaml"), "w") as f:
            f.write(to_yaml(params))


def _scalar(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


class CometLogger:
    """Comet logger (reference ``configs/logger/comet.yaml``; the JAX
    package's ``logging_callbacks.py:67-133``): a ``comet_ml.Experiment``
    when ``api_key`` is set, ``comet_ml`` imports and this is rank 0; else
    every method does nothing (reference ``get_comet_logger`` returning
    None, ``comet_callbacks.py:23-39``)."""

    def __init__(self, api_key: str = "", workspace: str = "", project_name: str = "",
                 experiment_name: Optional[str] = None, disabled: bool = False):
        self.experiment = None
        if disabled or not api_key or not ddp.is_rank_zero():
            return
        try:
            import comet_ml
        except ImportError:
            import warnings

            warnings.warn("comet_ml is not installed; CometLogger is a no-op. "
                          "Use logger=csv instead.")
            return
        self.experiment = comet_ml.Experiment(api_key=api_key, workspace=workspace or None,
                                              project_name=project_name or None)
        if experiment_name:
            self.experiment.set_name(experiment_name)

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        if self.experiment is not None:
            self.experiment.log_metrics({k: _scalar(v) for k, v in metrics.items()}, step=step)

    def log_hyperparams(self, params: dict) -> None:
        if self.experiment is not None:
            self.experiment.log_parameters(params)

    def log_confusion_matrix(self, cm, labels, epoch: int, title: str) -> None:
        """Reference ``log_comet_cm`` (``comet_callbacks.py:61-87``)."""
        if self.experiment is not None:
            self.experiment.log_confusion_matrix(matrix=cm.tolist(), labels=labels, epoch=epoch,
                                                 title=title)

    def log_code(self, root: str) -> None:
        """Uploads the source under ``root`` (reference ``LogCode``,
        ``comet_callbacks.py:42-52``)."""
        if self.experiment is not None:
            self.experiment.log_code(folder=root)

    def log_logs_path(self, logs_dir: str) -> None:
        """The run's logs directory as an experiment parameter (reference
        ``LogLogsPath``, ``comet_callbacks.py:55-60``)."""
        if self.experiment is not None:
            self.experiment.log_parameter("experiment_logs_dirpath", logs_dir)

    def finalize(self) -> None:
        if self.experiment is not None:
            self.experiment.end()


class LearningRateMonitor:
    """Adds the current LR to each step's metrics row (reference
    ``LearningRateMonitor``, ``callbacks/default.yaml:10-13``)."""

    def __init__(self, logging_interval: str = "step"):
        self.logging_interval = logging_interval

    def metrics(self, lr: float) -> Dict[str, float]:
        return {"lr-current": float(lr)}
