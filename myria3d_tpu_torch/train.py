"""Training loop of the port: ``Trainer.fit``, ``Trainer.test``,
``lr_range_test`` and ``train(config)``.

Port of ``myria3d_tpu/train.py:33-741`` without JAX: an explicit
loop over fixed-shape padded batches on one device per process, with the host-side
control plane of the JAX package: sanity-val steps, ``limit_*_batches``,
``overfit_batches``, the val epoch, the LR scheduler (plateau per val
epoch, one-cycle per step), the best/last checkpoints, early stopping, and
the SIGTERM/SIGINT save (the in-flight step finishes, the "last"
checkpoint is written, a second signal stops at once), the finetune regime
(weights only, the ``finetune`` callback's multipliers per epoch) and the
``trainer.profiler`` trace of epoch 0's train loop. ``Trainer.test`` is
the full-cloud evaluation: each test batch's logits are interpolated back
to every raw point of its subtiles (``Model.interp_step``: K1, K2 and K3 on
the card) before the loss and the confusion matrix.

Data parallel (``parallel/ddp.py``): in a process group (``run.py``
spawns ``trainer.devices`` ranks, or torchrun starts them) each rank fits
on its shard of every split under DDP, with sync BN or local BN
(``trainer.sync_batchnorm``) and draws its decimation and dropout from its
own generators (seed plus rank); the epoch's losses and confusion matrices
are summed over the ranks, rank 0 writes the checkpoints and logs, and the
ranks take the same scheduler and early-stopping decisions. In one process,
``trainer.devices`` > 1 tests over replicas of the model on the local
devices (``_setup_parallel``).

The logger (``logger=csv`` or ``logger=comet``) gets the metrics rows, the
whole composed config (``utils.log_hyperparameters``), and where it has
the hooks the code directory and the logs path at fit start and the
``train_cm`` / ``val_cm`` / ``test_cm`` confusion matrices
(``myria3d_tpu/train.py:184-195,444-458``), from rank 0.

``train(config)`` reads the composed config tree of ``configs/``, whose
targets name the JAX package's classes: :func:`port_targets` redirects
every one of them to the port's counterpart (and raises
``NotImplementedError`` for one the port lacks). ``fit`` and ``fit+test``
run the LR range test first under ``task.auto_lr_find`` and the test after
fit on the best checkpoint; ``test`` evaluates ``model.ckpt_path``;
``finetune`` fits from its weights.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import logging
import os
import re
import signal
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from myria3d_tpu_torch.models.model import Model
from myria3d_tpu_torch.models.optimizers import set_learning_rate_scale
from myria3d_tpu_torch.parallel import ddp
from myria3d_tpu_torch.pctl.batching import pad_full_cloud, pad_sampled_pos
from myria3d_tpu_torch.pctl.loader import BackgroundIterator
from myria3d_tpu_torch.utils.checkpoint import load_checkpoint
from myria3d_tpu_torch.utils.config import instantiate
from myria3d_tpu_torch.utils.profiling import StageTimer, trace
from myria3d_tpu_torch.utils.utils import log_hyperparameters

log = logging.getLogger(__name__)

# JAX-package targets whose counterpart lives at another path in the port;
# every other ``myria3d_tpu.<path>`` maps to ``myria3d_tpu_torch.<path>``
PORTED_TARGETS = {
    "myria3d_tpu.models.model.Model": "myria3d_tpu_torch.models.model.build_model",
    "myria3d_tpu.pctl.datamodule.hdf5.HDF5LidarDataModule": "myria3d_tpu_torch.data.HDF5LidarDataModule",
}
_JAX_TARGET = re.compile(r"\bmyria3d_tpu\.[A-Za-z0-9_.]+")
_END = object()   # the end of a train loader (a batch may be None)


def _port_target(name: str) -> str:
    """The port's counterpart of the JAX-package object ``name``; raises
    ``NotImplementedError`` when the port has none."""
    new = PORTED_TARGETS.get(name, "myria3d_tpu_torch." + name[len("myria3d_tpu."):])
    module, _, attr = new.rpartition(".")
    try:
        found = hasattr(importlib.import_module(module), attr)
    except ModuleNotFoundError as e:   # the port's module, not one it imports
        if not (e.name == module or module.startswith(f"{e.name}.")):
            raise
        found = False
    if not found:
        raise NotImplementedError(f"{name} has no counterpart in the port (no {new})")
    return new


def port_targets(node: Any) -> Any:
    """The config tree with every JAX-package target (``_target_`` values
    and ``${get_method:...}`` strings) redirected to the port. Callers
    redirect only the subtrees they instantiate: resolving a target imports
    its module."""
    if isinstance(node, dict):
        return {k: port_targets(v) for k, v in node.items()}
    if isinstance(node, list):
        return [port_targets(v) for v in node]
    if isinstance(node, str):
        return _JAX_TARGET.sub(lambda m: _port_target(m.group(0)), node)
    return node


@dataclasses.dataclass
class TrainerConfig:
    """Trainer knobs (``configs/trainer/default.yaml``). ``accelerator``:
    "auto", "gpu" and "cuda" take the first CUDA device and raise when
    there is none; "cpu" the CPU. In a process group each rank takes its
    own device. ``devices`` and ``num_nodes`` give the ranks that
    ``run.py`` (or torchrun) starts; ``sync_batchnorm`` picks sync BN (the
    JAX default) or local BN (the reference's DDP) for data-parallel
    training. Other keys land in ``extra``: ``profiler`` "torch" (or "jax",
    the JAX package's value) traces epoch 0's train loop to
    ``$LOGS_DIR/profile``."""

    min_epochs: int = 1
    max_epochs: int = 1
    log_every_n_steps: int = 1
    accelerator: str = "auto"
    devices: Any = "auto"
    num_nodes: int = 1
    limit_train_batches: Optional[int] = None
    limit_val_batches: Optional[int] = None
    limit_test_batches: Optional[int] = None
    num_sanity_val_steps: int = 0
    accumulate_grad_batches: int = 1
    overfit_batches: int = 0
    # True: BN moments over the global batch (the JAX package's sync BN);
    # False: per-rank moments, the reference's DDP
    sync_batchnorm: bool = True
    save_on_interrupt: bool = True

    def __init__(self, **kwargs: Any):
        for f in dataclasses.fields(self):
            setattr(self, f.name, kwargs.pop(f.name, f.default))
        self.extra = kwargs

    def device(self) -> torch.device:
        if ddp.is_initialized():
            return ddp.device()
        if int(self.num_nodes or 1) != 1:
            raise NotImplementedError("trainer.num_nodes > 1: start each node's ranks with "
                                      "torchrun (the port spawns the ranks of one node)")
        acc = str(self.accelerator).lower()
        if acc == "cpu":
            return torch.device("cpu")
        if acc not in ("auto", "gpu", "cuda"):
            raise ValueError(f"trainer.accelerator={self.accelerator}: auto, gpu, cuda or cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(f"trainer.accelerator={self.accelerator} runs on CUDA, but none "
                               "is available (trainer.accelerator=cpu runs on the CPU)")
        return torch.device("cuda")


def _limited(loader: Iterable, limit: Optional[int]) -> Iterable:
    for i, item in enumerate(loader):
        if limit and i >= limit:
            break
        yield item


def _arrays(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in arrays.items()}


def _generator(device: torch.device, seed: int, offset: int) -> torch.Generator:
    """The generator of a step: each rank draws from its own (seed plus rank)."""
    return torch.Generator(device=device).manual_seed((seed + ddp.rank()) * 1_000_003 + offset)


def _mean_over_ranks(losses: List[torch.Tensor]) -> float:
    """The mean of every rank's batch losses (nan when there is none)."""
    if ddp.world_size() == 1:
        return float(torch.stack(losses).mean()) if losses else float("nan")
    total = torch.stack(losses).sum() if losses else torch.zeros((), device=ddp.device())
    tot = ddp.all_reduce(torch.stack([total.double(), torch.tensor(
        float(len(losses)), dtype=torch.float64, device=total.device)]))
    return float(tot[0] / tot[1]) if float(tot[1]) else float("nan")


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
        self.finetune_cb = self.callbacks.get("finetune")
        self.device = trainer_config.device()
        self.par = None  # parallel.ParallelSteps, set by fit and test
        self.global_step = 0
        self.interrupted = False
        self.train_losses: List[float] = []  # every step's loss, for callers
        # the predict section's knobs that also govern test (as in the JAX
        # package): the two-op f32 interpolation, the error instead of the
        # subsampled fallback, full-scan searches, the x-sorted window
        self.exact_interpolation = False
        self.strict_full_cloud = False
        self.exact_knn = False
        self.sorted_window = 0
        self._warned_subsampled_test = False

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
        if self.logger is not None and ddp.is_rank_zero():
            self.logger.log_metrics(metrics, step=self.global_step)

    def _log_run_paths(self) -> None:
        """The fit's start hooks (reference ``LogCode`` / ``LogLogsPath``,
        ``myria3d_tpu/train.py:184-195``): the port's source directory and
        the logs directory, to a logger that takes them."""
        if self.logger is None or not ddp.is_rank_zero():
            return
        if hasattr(self.logger, "log_code"):
            self.logger.log_code(os.path.dirname(os.path.abspath(__file__)))
        if hasattr(self.logger, "log_logs_path"):
            self.logger.log_logs_path(os.environ.get("LOGS_DIR", os.getcwd()))

    def _phase_metrics(self, phase: str, epoch: int = 0) -> Dict[str, float]:
        """The phase's epoch metrics, its confusion matrix summed over the
        ranks first and pushed as ``<phase>_cm`` to a logger that takes one
        (``_log_confusion_matrix``, ``myria3d_tpu/train.py:448-458``)."""
        cm = self.metrics.summed(phase)
        if (self.logger is not None and ddp.is_rank_zero()
                and hasattr(self.logger, "log_confusion_matrix")):
            labels = [self.metrics.class_names.get(i, str(i))
                      for i in range(self.metrics.num_classes)]
            self.logger.log_confusion_matrix(cm, labels, epoch, f"{phase}_cm")
        return self.metrics.compute_and_reset(phase)

    def _setup_parallel(self, model: Model, batch_size: int, train: bool) -> None:
        """``myria3d_tpu/train.py:114-129``: ``self.par`` for a process
        group (DDP) or for ``trainer.devices`` > 1 local devices (replicas,
        which test but do not train), else None."""
        self.par = ddp.auto_parallel(model, batch_size, self.cfg.devices,
                                     sync_bn=bool(self.cfg.sync_batchnorm))
        if self.par is None:
            return
        if ddp.is_initialized():
            if train:   # a grad_microbatch that cannot map raises here, before any step
                self.par.chunks(batch_size, model.grad_microbatch)
            if train and ddp.is_rank_zero():
                log.info(f"Data-parallel over {ddp.world_size()} ranks (batch {batch_size} a "
                         f"rank, {'sync' if self.cfg.sync_batchnorm else 'local'}-BN)")
        elif train:
            raise RuntimeError(
                f"trainer.devices={self.cfg.devices} trains one process per device: launch "
                "through myria3d_tpu_torch.run (which starts the ranks) or torchrun")
        else:
            log.info(f"Testing over {len(self.par.devices)} replicas (batch {batch_size})")

    def _place(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self.par is not None:
            return self.par.place_batch(arrays)
        return _arrays(arrays, self.device)

    # ------------------------------------------------------------------

    def fit(self, model: Model, datamodule, ckpt_path: Optional[str] = None,
            finetune: bool = False) -> Model:
        """Fit ``model``; ``ckpt_path`` resumes from a checkpoint, or with
        ``finetune`` takes its weights only (a fresh optimizer) and applies
        the ``finetune`` callback's multipliers at each epoch's start."""
        self._log_run_paths()
        datamodule.prepare_data()
        datamodule.setup("fit")
        model.to(self.device)
        model.init_train_state(per_module=finetune)
        if ckpt_path:
            log.info(f"Restoring weights{'' if finetune else ' and optimizer state'} "
                     f"from {ckpt_path}")
            model.restore_train_state(ckpt_path, optimizer=not finetune)
        log.info(f"Model has {sum(p.numel() for p in model.parameters()):,} parameters")
        self._setup_parallel(model, datamodule.batch_size, train=True)
        model.set_lr_scale(1.0)
        scheduler = model.lr_scheduler_factory() if model.lr_scheduler_factory else None
        per_step = bool(getattr(scheduler, "per_step", False))
        if per_step:
            model.set_lr_scale(scheduler.scale)  # one-cycle starts below max_lr

        if self.cfg.num_sanity_val_steps:
            self._val_epoch(model, datamodule, limit=self.cfg.num_sanity_val_steps,
                            log_prefix=None)
        overfit = None
        if self.cfg.overfit_batches:
            overfit = [b for b in _limited(datamodule.train_dataloader(seed=self.seed),
                                           self.cfg.overfit_batches) if b is not None]
        profile_dir = None
        if self.cfg.extra.get("profiler") in ("torch", "jax"):
            profile_dir = os.path.join(os.environ.get("LOGS_DIR", "logs"), "profile")
            log.info(f"Profiling epoch 0 to {profile_dir}")

        epoch = 0
        with self._graceful_interrupts():
            for epoch in range(self.cfg.max_epochs):
                if self.interrupted:
                    break
                if finetune and self.finetune_cb is not None:
                    model.set_lr_mult(self.finetune_cb.lr_mult_for_epoch(model.net, epoch))
                stop = self._fit_one_epoch(model, datamodule, epoch, scheduler, per_step,
                                           overfit, profile_dir if epoch == 0 else None)
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

    def _fit_one_epoch(self, model, datamodule, epoch, scheduler, per_step, overfit,
                       profile_dir=None):
        """One train + val epoch; returns the early-stopping decision, or
        None when interrupted before it was taken. ``profile_dir`` traces
        the train loop, each step the region "train_step" (the model's
        ``model.forward``, ``model.backward`` and ``model.optimizer`` in
        it) and each wait for the loader's next batch the region
        "data_wait", and logs the host's time in both (``profile/
        train_step_s``, the time to enqueue the steps where the device runs
        behind, ``profile/data_wait_s``, and their ``_mean_s``)."""
        losses: List[torch.Tensor] = []
        timer = StageTimer()
        iterator: Iterable = overfit if overfit is not None else BackgroundIterator(
            _limited(datamodule.train_dataloader(seed=self.seed + epoch),
                     self.cfg.limit_train_batches), max_prefetch=2)
        batches = iter(iterator)
        try:
            with trace(profile_dir):
                while True:
                    with timer.stage("data_wait"):
                        batch = next(batches, _END)
                    if batch is _END:
                        break
                    if batch is None:
                        continue
                    with timer.stage("train_step"):
                        a = _arrays(batch.device_arrays(), self.device)
                        gen = _generator(self.device, self.seed, model.step)
                        step = self.par.train_step if self.par is not None else model.train_step
                        loss, logits = step(a["x"], a["pos"], a["y"], a["mask"], gen)
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
                        model.set_lr_scale(scheduler.step())
                    if self.interrupted:
                        break
        finally:
            if hasattr(iterator, "close"):
                iterator.close()
        if profile_dir:
            self._log(timer.metrics())
        step_losses = torch.stack(losses).tolist() if losses else []
        self.train_losses.extend(step_losses)
        if self.interrupted:
            return None

        epoch_metrics: Dict[str, float] = {
            "epoch": float(epoch),
            "train/loss_epoch": float(np.mean(step_losses)) if step_losses else float("nan"),
        }
        if self.metrics is not None:
            epoch_metrics.update(self._phase_metrics("train", epoch))
        val_metrics = self._val_epoch(model, datamodule, limit=self.cfg.limit_val_batches,
                                      overfit=overfit)
        if self.interrupted:
            return None
        epoch_metrics.update(val_metrics)
        self._log(epoch_metrics)

        stop = False
        monitor_value = epoch_metrics.get(model.monitor)
        if scheduler is not None and not per_step and monitor_value is not None:
            model.set_lr_scale(scheduler.step(monitor_value))
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
            a = _arrays(batch.device_arrays(), self.device)
            loss, logits = model.eval_step(a["x"], a["pos"], a["y"], a["mask"],
                                           _generator(self.device, self.seed, -1))
            losses.append(loss)
            if self.metrics is not None and log_prefix:
                self.metrics.update(log_prefix, logits, a["y"], a["mask"])
            if self.interrupted:
                break
        if log_prefix is None:
            return {}
        out = {f"{log_prefix}/loss_epoch": _mean_over_ranks(losses)}
        if self.metrics is not None:
            out.update(self._phase_metrics(log_prefix))
        return out

    # ------------------------------------------------------------------

    def test(self, model: Model, datamodule, ckpt_path: Optional[str] = None) -> Dict[str, float]:
        """Full-cloud evaluation (``myria3d_tpu/train.py:462-582``): each
        test batch's logits are interpolated back to every raw point of its
        subtiles before the loss and the ``test`` confusion matrix
        (reference ``task=test`` regime, ``models/model.py:86-103``).

        ``ckpt_path`` replaces ``model``'s net by the checkpoint's (its
        criterion stays). A batch without full-cloud copies falls back to
        subsampled eval with one warning, or raises under
        ``predict.strict_full_cloud``."""
        if self.sorted_window > 0 and not self.exact_knn and hasattr(datamodule, "_stages"):
            # windowed searches need x-sorted clouds: append the sort to the
            # eval pipeline before the dataset composes its transforms (and
            # drop a dataset built without it during fit)
            from myria3d_tpu_torch.pctl.transforms.transforms import SortPointsByX

            stages = datamodule._stages["eval"]
            if not any(isinstance(t, SortPointsByX) for t in stages):
                datamodule._stages["eval"] = list(stages) + [SortPointsByX()]
                datamodule._dataset = None
        datamodule.prepare_data()
        datamodule.setup("test")
        if ckpt_path:
            criterion = model.criterion
            model = load_checkpoint(ckpt_path, self.device)
            model.criterion = criterion
        model.to(self.device)
        if self.exact_knn:
            model.set_exact_knn(True)
        elif self.sorted_window > 0:
            model.set_sorted_window(self.sorted_window)
        fused = not self.exact_interpolation
        self._setup_parallel(model, datamodule.batch_size, train=False)
        interp_step = self.par.interp_step if self.par is not None else model.interp_step

        losses: List[torch.Tensor] = []
        for batch in _limited(datamodule.test_dataloader(), self.cfg.limit_test_batches):
            if batch is None:
                continue
            a = self._place(batch.device_arrays())
            full = pad_full_cloud(batch.copies)
            sampled_pos = pad_sampled_pos(batch.copies, batch.num_points)
            if full is None or sampled_pos is None or "full_y" not in full:
                # the subsampled regime is EASIER (metrics on the decimated
                # cloud, not every raw point): a missing Copy*Pos transform
                # would otherwise silently report the wrong mIoU
                if self.strict_full_cloud:
                    raise RuntimeError(
                        "predict.strict_full_cloud=true but a test batch carries no "
                        "full-cloud copies: the eval transform list is missing the "
                        "Copy*Pos transforms, so full-cloud test metrics cannot be computed.")
                if not self._warned_subsampled_test:
                    self._warned_subsampled_test = True
                    log.warning(
                        "Test batch without full-cloud copies: falling back to "
                        "SUBSAMPLED-regime eval (reference task=test is always full-cloud). "
                        "Check the eval transform list (Copy*Pos transforms); set "
                        "predict.strict_full_cloud=true to make this an error. This warning "
                        "is logged once per run.")
                loss, logits = model.eval_step(a["x"], a["pos"], a["y"], a["mask"],
                                               _generator(self.device, self.seed, -777))
                losses.append(loss)
                if self.metrics is not None:
                    self.metrics.update("test", logits, a["y"], a["mask"])
                continue
            # the replicas pad the rows to their count: filler rows carry the
            # ignore code and False masks (myria3d_tpu/train.py:555-563)
            dev = self._place({"sampled_pos": sampled_pos, "full_pos": full["full_pos"],
                               "full_mask": full["full_mask"], "full_y": full["full_y"]})
            full_logits = interp_step(a["x"], a["pos"], a["mask"], dev["sampled_pos"],
                                      dev["full_pos"], dev["full_mask"],
                                      _generator(self.device, self.seed, -777), fused=fused)
            full_y = dev["full_y"].long()
            losses.append(model.criterion(full_logits, full_y))
            if self.metrics is not None:
                self.metrics.update("test", full_logits, full_y, dev["full_mask"])
        out = {"test/loss_epoch": _mean_over_ranks(losses)}
        if self.metrics is not None:
            out.update(self._phase_metrics("test"))
        self._log(out)
        log.info("test: " + " ".join(f"{k}={v:.4f}" for k, v in out.items() if k.count("/") == 1))
        return out


def build_trainer(config: dict):
    """``(trainer, model)`` from the composed config: the model, callbacks,
    logger and trainer knobs, with their targets redirected to the port
    (the datamodule is the caller's). The logger gets the composed config
    as it is (``myria3d_tpu/train.py:706-707``)."""
    composed = config
    config = {k: port_targets(config[k]) if k in ("model", "callbacks", "logger", "trainer")
              else v for k, v in config.items()}
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
            logger = instantiate(lg_conf)
            break
    trainer_cfg = dict(config.get("trainer") or {})
    trainer_cfg.pop("_target_", None)
    trainer = Trainer(TrainerConfig(**trainer_cfg), callbacks=callbacks, logger=logger, seed=seed)
    pcfg = config.get("predict") or {}
    trainer.exact_interpolation = bool(pcfg.get("exact_interpolation", False))
    trainer.strict_full_cloud = bool(pcfg.get("strict_full_cloud", False))
    trainer.exact_knn = bool(pcfg.get("exact_knn", False))
    trainer.sorted_window = int(pcfg.get("sorted_window", 0) or 0)
    log_hyperparameters(logger, composed, model, None)
    return trainer, model


def lr_range_test(model: Model, datamodule, seed: int = 12345, min_lr: float = 1e-4,
                  max_lr: float = 3.0, num_steps: int = 100, beta: float = 0.98) -> float:
    """LR range test (``myria3d_tpu/train.py:592-643``; reference
    ``auto_lr_find``): train on up to 8 cached batches while the LR grows
    geometrically from ``min_lr`` to ``max_lr``, track the bias-corrected
    EMA of the loss, stop on a non-finite loss or once the smoothed loss
    exceeds 4x its minimum after step 10, and suggest the LR of the
    steepest descent of the smoothed loss over log(LR) (``model.lr`` when
    fewer than 3 points were taken).

    The sweep runs on the model's device with a fresh optimizer (under a
    per-step scheduler its step i runs at ``lr_i * scale_at(i)``, as the
    JAX optimizer's fused one-cycle schedule does); the net's state dict,
    the step and the optimizer are restored afterwards."""
    import math

    datamodule.prepare_data()
    datamodule.setup("fit")
    batches = [b for b in _limited(datamodule.train_dataloader(seed=seed), 8) if b is not None]
    if not batches:
        raise RuntimeError("No batches for the LR range test")
    device = next(model.net.parameters()).device
    arrays = [_arrays(b.device_arrays(), device) for b in batches]
    probe = model.lr_scheduler_factory() if model.lr_scheduler_factory else None
    schedule = probe.scale_at if getattr(probe, "per_step", False) else None
    saved = ({k: v.detach().clone() for k, v in model.net.state_dict().items()},
             model.step, model.accum, model.optimizer, model.lr_scale, model.net.training)
    model.init_train_state()

    gamma = (max_lr / min_lr) ** (1.0 / max(1, num_steps - 1))
    lrs, losses = [], []
    avg = 0.0
    try:
        for i in range(num_steps):
            lr_i = min_lr * gamma**i
            updates = i // model.accumulate_grad_batches   # the schedule's count
            set_learning_rate_scale(model.optimizer, lr_i, schedule(updates) if schedule else 1.0)
            a = arrays[i % len(arrays)]
            loss, _ = model.train_step(a["x"], a["pos"], a["y"], a["mask"],
                                       _generator(device, seed, i))
            loss = float(loss)
            if not math.isfinite(loss):
                break
            avg = beta * avg + (1 - beta) * loss
            smoothed = avg / (1 - beta ** (i + 1))
            lrs.append(lr_i)
            losses.append(smoothed)
            if i > 10 and smoothed > 4 * min(losses):
                break  # diverged
    finally:
        state, model.step, model.accum, model.optimizer, model.lr_scale, training = saved
        model.net.load_state_dict(state)
        model.net.train(training)
    if len(losses) < 3:
        return model.lr
    grads = np.gradient(np.asarray(losses), np.log(np.asarray(lrs)))
    suggestion = float(lrs[int(np.argmin(grads))])
    log.info(f"LR range test suggests lr={suggestion:.6g} ({len(losses)} steps)")
    return suggestion


def train(config: dict) -> Trainer:
    """Instantiate the datamodule, model, callbacks and logger from the
    composed config and run ``task.task_name``: ``fit`` and ``fit+test``
    (the LR range test first under ``task.auto_lr_find``, fit, then the
    full-cloud test on the best checkpoint, or on the trained model when no
    checkpoint was kept; none after a SIGTERM stop), ``test`` (the
    checkpoint directory ``model.ckpt_path``) or ``finetune`` (fit from
    ``model.ckpt_path``'s weights with the ``finetune`` callback; no test
    after it)."""
    task = config.get("task") or {}
    task_name = task.get("task_name", "fit")
    if task_name not in ("fit", "fit+test", "test", "finetune"):
        raise ValueError(f"Unknown task for train(): {task_name}")
    ckpt_path = config["model"].get("ckpt_path")
    if task_name == "test" and not (ckpt_path and os.path.isdir(ckpt_path)):
        raise ValueError("task=test requires model.ckpt_path pointing to a checkpoint dir")
    trainer, model = build_trainer(config)
    datamodule = instantiate(port_targets(config["datamodule"]))
    if getattr(datamodule, "num_features", None) is None:
        datamodule.num_features = int(model.hparams["d_in"])
    if task_name == "test":
        log.info("Starting testing!")
        trainer.test(model, datamodule, ckpt_path=ckpt_path)
        return trainer
    if task_name == "finetune":
        log.info("Starting finetuning!")
        trainer.fit(model, datamodule, ckpt_path=ckpt_path, finetune=True)
        return trainer
    if task.get("auto_lr_find"):
        # fit starts from model.lr and re-applies it to every group; in a
        # process group rank 0 runs the range test alone (on its shard) and
        # every rank takes its suggestion
        model.to(trainer.device)
        datamodule.prepare_data()   # every rank: rank 0 builds the cache
        lr = lr_range_test(model, datamodule, seed=trainer.seed) if ddp.is_rank_zero() else 0.0
        model.lr = ddp.from_rank_zero(lr)
    log.info("Starting training!")
    trainer.fit(model, datamodule, ckpt_path=ckpt_path)
    if trainer.interrupted:
        return trainer  # preempted: checkpoint saved, no test after fit
    best = getattr(trainer.checkpoint_cb, "best_model_path", None)
    log.info(f"Best checkpoint: {best}")
    trainer.test(model, datamodule, ckpt_path=best or None)
    return trainer
