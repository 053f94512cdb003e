"""Training loop of the port: ``Trainer.fit`` and ``train(config)``.

Port of ``myria3d_tpu/train.py:33-450,646-741`` without JAX: an explicit
loop over fixed-shape padded batches on one device, with the host-side
control plane of the JAX package: sanity-val steps, ``limit_*_batches``,
``overfit_batches``, the val epoch, the LR scheduler (plateau per val
epoch, one-cycle per step), the best/last checkpoints, early stopping, and
the SIGTERM/SIGINT save (the in-flight step finishes, the "last"
checkpoint is written, a second signal stops at once).

``train(config)`` reads the composed config tree of ``configs/``: targets
that name JAX-package classes with a port (the model, optimizers,
schedulers, criterion, metric and logging callbacks, the datamodule, the
trainer config) are redirected to the port (:data:`PORTED_TARGETS`); the
checkpoint and early-stopping callbacks, datasets and transforms are the
JAX package's own, which use no JAX. ``test``, ``finetune`` and the LR
range test are not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import signal
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from myria3d_tpu.utils.config import instantiate
from myria3d_tpu_torch.models.model import Model
from myria3d_tpu_torch.models.optimizers import set_learning_rate_scale

log = logging.getLogger(__name__)

# JAX-package target prefix -> the port's (see the module docstring)
PORTED_TARGETS = {
    "myria3d_tpu.models.model.Model": "myria3d_tpu_torch.models.model.build_model",
    "myria3d_tpu.models.optimizers.": "myria3d_tpu_torch.models.optimizers.",
    "myria3d_tpu.models.criterion.": "myria3d_tpu_torch.models.criterion.",
    "myria3d_tpu.callbacks.metric_callbacks.": "myria3d_tpu_torch.callbacks.metric_callbacks.",
    "myria3d_tpu.callbacks.logging_callbacks.": "myria3d_tpu_torch.callbacks.logging_callbacks.",
    "myria3d_tpu.pctl.datamodule.hdf5.HDF5LidarDataModule": "myria3d_tpu_torch.data.HDF5LidarDataModule",
    "myria3d_tpu.train.TrainerConfig": "myria3d_tpu_torch.train.TrainerConfig",
}


def port_targets(node: Any) -> Any:
    """The config tree with every ported JAX-package target (``_target_``
    values and ``${get_method:...}`` strings) redirected to the port."""
    if isinstance(node, dict):
        return {k: port_targets(v) for k, v in node.items()}
    if isinstance(node, list):
        return [port_targets(v) for v in node]
    if isinstance(node, str):
        for old, new in PORTED_TARGETS.items():
            if old in node:
                return node.replace(old, new)
    return node


@dataclasses.dataclass
class TrainerConfig:
    """Trainer knobs (``configs/trainer/default.yaml``). ``accelerator``:
    "auto" takes the first CUDA device when there is one, else the CPU;
    "gpu"/"cuda" require a CUDA device; "cpu". One device per process."""

    min_epochs: int = 1
    max_epochs: int = 1
    log_every_n_steps: int = 1
    accelerator: str = "auto"
    devices: Any = "auto"
    num_nodes: int = 1
    limit_train_batches: Optional[int] = None
    limit_val_batches: Optional[int] = None
    num_sanity_val_steps: int = 0
    accumulate_grad_batches: int = 1
    overfit_batches: int = 0
    save_on_interrupt: bool = True

    def __init__(self, **kwargs: Any):
        for f in dataclasses.fields(self):
            setattr(self, f.name, kwargs.pop(f.name, f.default))
        self.extra = kwargs

    def device(self) -> torch.device:
        if self.devices not in ("auto", None, 1, [0]) or int(self.num_nodes or 1) != 1:
            raise NotImplementedError("multi-device training (DDP) is not ported yet")
        acc = str(self.accelerator).lower()
        if acc == "cpu":
            return torch.device("cpu")
        if acc in ("gpu", "cuda") and not torch.cuda.is_available():
            raise RuntimeError(f"trainer.accelerator={self.accelerator} asks for CUDA, "
                               "but none is available")
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _limited(loader: Iterable, limit: Optional[int]) -> Iterable:
    for i, item in enumerate(loader):
        if limit and i >= limit:
            break
        yield item


class Trainer:
    """Explicit training loop owning callbacks, logger and scheduler state."""

    def __init__(self, trainer_config: TrainerConfig, callbacks: Optional[Dict[str, Any]] = None,
                 logger: Optional[Any] = None, seed: int = 12345):
        self.cfg = trainer_config
        self.callbacks = callbacks or {}
        self.logger = logger
        self.seed = int(seed)
        self.metrics = self.callbacks.get("model_detailed_metrics")
        self.checkpoint_cb = self.callbacks.get("model_checkpoint")
        self.early_stopping = self.callbacks.get("early_stopping")
        self.lr_monitor = self.callbacks.get("lr_monitor")
        self.device = trainer_config.device()
        self.global_step = 0
        self.interrupted = False
        self.train_losses: List[float] = []  # every step's loss, for callers

    @contextlib.contextmanager
    def _graceful_interrupts(self):
        """The first SIGTERM/SIGINT only sets ``self.interrupted``: the loop
        finishes its step, saves the "last" checkpoint and returns; a
        second one raises ``KeyboardInterrupt``. No-op off the main thread
        or with ``save_on_interrupt: false``."""
        if not getattr(self.cfg, "save_on_interrupt", True):
            yield
            return
        previous: Dict[int, Any] = {}

        def handler(signum, frame):
            if self.interrupted:
                for s, h in previous.items():
                    signal.signal(s, h)
                raise KeyboardInterrupt
            self.interrupted = True
            log.info(f"Received signal {signum}: finishing the current step, saving the "
                     "last checkpoint, then stopping.")

        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                previous[s] = signal.signal(s, handler)
        except ValueError:  # not in the main thread
            previous = {}
        try:
            yield
        finally:
            for s, h in previous.items():
                signal.signal(s, h)

    def _log(self, metrics: Dict[str, float]) -> None:
        if self.logger is not None:
            self.logger.log_metrics(metrics, step=self.global_step)

    def _arrays(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
                for k, v in batch.device_arrays().items()}

    def _generator(self, offset: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed * 1_000_003 + offset)

    def _apply_lr(self, model: Model, scale: float) -> None:
        set_learning_rate_scale(model.optimizer, model.lr, scale)

    # ------------------------------------------------------------------

    def fit(self, model: Model, datamodule, ckpt_path: Optional[str] = None) -> Model:
        datamodule.prepare_data()
        datamodule.setup("fit")
        model.to(self.device)
        model.init_train_state()
        if ckpt_path:
            log.info(f"Restoring weights and optimizer state from {ckpt_path}")
            model.restore_train_state(ckpt_path)
        log.info(f"Model has {sum(p.numel() for p in model.parameters()):,} parameters")
        self._apply_lr(model, 1.0)
        scheduler = model.lr_scheduler_factory() if model.lr_scheduler_factory else None
        per_step = bool(getattr(scheduler, "per_step", False))
        if per_step:
            self._apply_lr(model, scheduler.scale)  # one-cycle starts below max_lr

        if self.cfg.num_sanity_val_steps:
            self._val_epoch(model, datamodule, limit=self.cfg.num_sanity_val_steps,
                            log_prefix=None)
        overfit = None
        if self.cfg.overfit_batches:
            overfit = [b for b in _limited(datamodule.train_dataloader(seed=self.seed),
                                           self.cfg.overfit_batches) if b is not None]

        epoch = 0
        with self._graceful_interrupts():
            for epoch in range(self.cfg.max_epochs):
                if self.interrupted:
                    break
                stop = self._fit_one_epoch(model, datamodule, epoch, scheduler, per_step, overfit)
                if self.interrupted:
                    break
                if stop and epoch + 1 >= self.cfg.min_epochs:
                    log.info(f"Early stopping at epoch {epoch}")
                    break
        if self.interrupted:
            path = None
            if self.checkpoint_cb is not None:
                path = self.checkpoint_cb.save_interrupt(model, None)
            log.info(f"Training interrupted at epoch {epoch}, step {self.global_step}"
                     + (f"; resumable checkpoint: {path}" if path else ""))
        return model

    def _fit_one_epoch(self, model, datamodule, epoch, scheduler, per_step, overfit):
        """One train + val epoch; returns the early-stopping decision, or
        None when interrupted before it was taken."""
        from myria3d_tpu.pctl.loader import BackgroundIterator

        losses: List[torch.Tensor] = []
        iterator: Iterable = overfit if overfit is not None else BackgroundIterator(
            _limited(datamodule.train_dataloader(seed=self.seed + epoch),
                     self.cfg.limit_train_batches), max_prefetch=2)
        try:
            for batch in iterator:
                if batch is None:
                    continue
                a = self._arrays(batch)
                loss, logits = model.train_step(a["x"], a["pos"], a["y"], a["mask"],
                                                self._generator(model.step))
                self.global_step += 1
                losses.append(loss)
                if self.metrics is not None:
                    self.metrics.update("train", logits, a["y"], a["mask"])
                if self.global_step % max(1, self.cfg.log_every_n_steps) == 0:
                    row = {"train/loss_step": float(loss)}
                    if self.lr_monitor is not None and scheduler is not None:
                        row.update(self.lr_monitor.metrics(
                            model.lr * getattr(scheduler, "scale", 1.0)))
                    self._log(row)
                if per_step:
                    self._apply_lr(model, scheduler.step())
                if self.interrupted:
                    break
        finally:
            if hasattr(iterator, "close"):
                iterator.close()
        step_losses = torch.stack(losses).tolist() if losses else []
        self.train_losses.extend(step_losses)
        if self.interrupted:
            return None

        epoch_metrics: Dict[str, float] = {
            "epoch": float(epoch),
            "train/loss_epoch": float(np.mean(step_losses)) if step_losses else float("nan"),
        }
        if self.metrics is not None:
            epoch_metrics.update(self.metrics.compute_and_reset("train"))
        val_metrics = self._val_epoch(model, datamodule, limit=self.cfg.limit_val_batches,
                                      overfit=overfit)
        if self.interrupted:
            return None
        epoch_metrics.update(val_metrics)
        self._log(epoch_metrics)

        stop = False
        monitor_value = epoch_metrics.get(model.monitor)
        if scheduler is not None and not per_step and monitor_value is not None:
            self._apply_lr(model, scheduler.step(monitor_value))
        if self.checkpoint_cb is not None:
            self.checkpoint_cb.on_validation_end(model, None, epoch_metrics, epoch)
        if self.early_stopping is not None:
            stop = self.early_stopping.on_validation_end(epoch_metrics)
        log.info(f"epoch {epoch}: " + " ".join(
            f"{k}={v:.4f}" for k, v in epoch_metrics.items()
            if isinstance(v, float) and k.count("/") == 1))
        return stop

    def _val_epoch(self, model, datamodule, limit=None, log_prefix: Optional[str] = "val",
                   overfit=None) -> Dict[str, float]:
        losses: List[torch.Tensor] = []
        iterator = overfit if overfit is not None else _limited(datamodule.val_dataloader(), limit)
        for batch in iterator:
            if batch is None:
                continue
            a = self._arrays(batch)
            loss, logits = model.eval_step(a["x"], a["pos"], a["y"], a["mask"],
                                           self._generator(-1))
            losses.append(loss)
            if self.metrics is not None and log_prefix:
                self.metrics.update(log_prefix, logits, a["y"], a["mask"])
            if self.interrupted:
                break
        if log_prefix is None:
            return {}
        out = {f"{log_prefix}/loss_epoch":
               float(torch.stack(losses).mean()) if losses else float("nan")}
        if self.metrics is not None:
            out.update(self.metrics.compute_and_reset(log_prefix))
        return out


def build_trainer(config: dict):
    """``(trainer, model)`` from the composed config: the model, callbacks,
    logger and trainer knobs, with the ported targets (no datamodule)."""
    config = port_targets(config)
    seed = int(config.get("seed", 12345))
    np.random.seed(seed)
    torch.manual_seed(seed)
    model_cfg = dict(config["model"])
    accumulate = int((config.get("trainer") or {}).get("accumulate_grad_batches", 1) or 1)
    model: Model = instantiate({**model_cfg, "accumulate_grad_batches": accumulate})
    callbacks: Dict[str, Any] = {}
    for name, cb_conf in (config.get("callbacks") or {}).items():
        if isinstance(cb_conf, dict) and "_target_" in cb_conf:
            callbacks[name] = instantiate(cb_conf)
    logger = None
    for lg_conf in (config.get("logger") or {}).values():
        if isinstance(lg_conf, dict) and "_target_" in lg_conf:
            if not lg_conf["_target_"].startswith("myria3d_tpu_torch."):
                raise NotImplementedError(
                    f"logger {lg_conf['_target_']} is not ported (use logger=csv)")
            logger = instantiate(lg_conf)
            break
    trainer_cfg = dict(config.get("trainer") or {})
    trainer_cfg.pop("_target_", None)
    trainer = Trainer(TrainerConfig(**trainer_cfg), callbacks=callbacks, logger=logger, seed=seed)
    if logger is not None:
        logger.log_hyperparams({"model": model.hparams, "trainer": trainer_cfg, "seed": seed})
    return trainer, model


def train(config: dict) -> Trainer:
    """Instantiate the datamodule, model, callbacks and logger from the
    composed config and run ``task.task_name=fit`` (the JAX package's test
    after fit is skipped: ``Trainer.test`` is not ported yet)."""
    task = config.get("task") or {}
    if task.get("task_name", "fit") not in ("fit", "fit+test"):
        raise NotImplementedError(f"task.task_name={task['task_name']} is not ported yet (fit only)")
    if task.get("auto_lr_find"):
        raise NotImplementedError("task.auto_lr_find (the LR range test) is not ported yet")
    trainer, model = build_trainer(config)
    datamodule = instantiate(port_targets(config["datamodule"]))
    if getattr(datamodule, "num_features", None) is None:
        datamodule.num_features = int(model.net.fc0.in_features)
    log.info("Starting training!")
    trainer.fit(model, datamodule, ckpt_path=config["model"].get("ckpt_path"))
    log.info(f"Best checkpoint: {getattr(trainer.checkpoint_cb, 'best_model_path', None)}")
    if not trainer.interrupted:
        log.warning("Trainer.test is not ported yet: the test after fit is skipped")
    return trainer
