"""Task-level model: train, eval and predict steps over padded batches.

Port of ``myria3d_tpu/models/model.py``. The JAX package keeps an immutable
``TrainState`` (params, BN stats, optimizer state, step) and pure jitted
steps; here the train state lives in place: the net's parameters and BN
buffers, the ``torch.optim`` optimizer (one parameter group, or when
finetuning one per top-level module of the net with its ``lr_mult``), the
step count and the count of batches in the open accumulation group.

- ``grad_step`` (``build_grad_step``, ``model.py:238-323``): forward in
  training mode (batch moment BN, dropout and decimation drawn from the
  step's generator), the criterion and backward into ``.grad``; BN running
  stats move every batch. With ``grad_microbatch`` it runs over chunks of
  the batch (per-chunk BN moments, the mean of the chunks' gradients and
  running stats). Under DDP (``parallel/ddp.py``) it is one rank's share of
  the data-parallel step.
- ``train_step`` (``model.py:325-352``): ``grad_step``, then an optimizer
  update every ``accumulate_grad_batches`` batches on the mean of their
  gradients (optax ``MultiSteps``).
- ``eval_step`` (``model.py:354-363``): eval-mode forward and loss.
- ``interp_step`` (``model.py:366-398``): the predict and test step,
  forward on the sampled points then the k-NN interpolation of the logits
  to every raw point of each subtile, shipped as f16.

Checkpoints are ``state_dict.npz`` + ``hparams.json`` (which the
predict path reads) plus ``train_state.pt`` with the optimizer state and
the step (``utils.checkpoint``).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from myria3d_tpu_torch.models.criterion import CrossEntropyLoss
from myria3d_tpu_torch.models.modules import get_neural_net_class
from myria3d_tpu_torch.models.optimizers import adam, set_learning_rate_scale
from myria3d_tpu_torch.ops.cuda_knn import stage_window
from myria3d_tpu_torch.ops.interpolate import knn_interpolate

# JAX hparams that only steer TPU memory or search exactness: the port's
# backward keeps what autograd needs, and K1 is exact within its window
_IGNORED_NET_HPARAMS = {"remat", "exact_knn"}
TRAIN_STATE = "train_state.pt"


def chunk_generator(generator: torch.Generator | None, i: int) -> torch.Generator | None:
    """The generator of chunk ``i`` of a microbatched step, seeded from the
    step's generator's seed (JAX folds the chunk index into the step's
    keys, ``model.py:292-296``); None stays None."""
    if generator is None:
        return None
    seed = (generator.initial_seed() * 1_000_003 + i + 1) % (2**63 - 1)
    return torch.Generator(device=generator.device).manual_seed(seed)


def build_net(neural_net_class_name: str, neural_net_hparams: Dict[str, Any]) -> nn.Module:
    """The zoo's net (``models.modules.MODEL_ZOO``: RandLA-Net, PointNet++)
    from the JAX hparams; f32 logits only."""
    net_class = get_neural_net_class(neural_net_class_name)
    hp = {k: v for k, v in neural_net_hparams.items() if k not in _IGNORED_NET_HPARAMS}
    dtype = hp.pop("dtype", None)
    if dtype not in (None, "float32"):
        raise NotImplementedError(f"compute dtype {dtype!r} is not ported yet")
    if not hp.pop("return_logits", True):
        raise NotImplementedError("log-softmax outputs are not ported")
    return net_class(**hp)


class Model(nn.Module):
    """Segmentation model (reference ``Model``): the net, its criterion and
    optimizer, and the train/eval/predict steps."""

    def __init__(self, net: nn.Module, interpolation_k: int = 10, *, lr: float = 1e-3,
                 optimizer: Optional[Callable] = None, lr_scheduler: Optional[Callable] = None,
                 criterion: Optional[Callable] = None, monitor: str = "val/loss_epoch",
                 accumulate_grad_batches: int = 1, grad_microbatch: int = 0,
                 hparams: Optional[dict] = None):
        super().__init__()
        self.net = net
        self.interpolation_k = int(interpolation_k)
        # x-sorted window of the full-cloud interpolation search (key
        # positions; 0 is a full scan): set_sorted_window
        self.interp_window = 0
        self.lr = float(lr)
        self.optimizer_factory = optimizer if optimizer is not None else adam
        self.lr_scheduler_factory = lr_scheduler
        self.criterion = criterion if criterion is not None else CrossEntropyLoss()
        self.monitor = monitor
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches or 1))
        self.grad_microbatch = int(grad_microbatch or 0)
        self.hparams = hparams
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0   # train batches taken
        self.accum = 0  # batches in the open accumulation group
        self.lr_scale = 1.0
        # parallel.ParallelSteps under DDP (a plain attribute: not a module
        # of the model's state)
        self.data_parallel: Any = None

    def set_sorted_window(self, window: int) -> None:
        """Window the full-cloud interpolation search, and every search of a
        net that has a ``knn_window`` (RandLA-Net's encoder graphs and
        decoder upsampling), to ~``window`` sorted key positions per
        256-query tile. Requires x-sorted clouds (the predict pipeline
        appends ``SortPointsByX``, so the in-model sort is switched off as
        in ``model.py:192-211``); 0 is a full scan."""
        self.interp_window = int(window)
        if hasattr(self.net, "knn_window"):
            self.net.knn_window = int(window)
            self.net.sort_inputs = False

    # ------------------------------------------------------------------
    # train state

    def init_train_state(self, per_module: bool = False) -> None:
        """A fresh optimizer over the net's parameters, step 0: one
        parameter group, or with ``per_module`` (finetuning) one group per
        top-level module, each at ``lr_mult`` 1. The optimizer runs its
        update once per group, so a fit without multipliers keeps one."""
        params: Any = self.net.parameters()
        if per_module:
            groups: Dict[str, list] = {}
            for name, p in self.net.named_parameters():
                groups.setdefault(name.split(".", 1)[0], []).append(p)
            params = [{"params": ps, "name": top, "lr_mult": 1.0} for top, ps in groups.items()]
        self.optimizer = self.optimizer_factory(lr=self.lr)(params)
        self.optimizer.zero_grad(set_to_none=True)
        self.step = 0
        self.accum = 0
        self.lr_scale = 1.0

    def set_lr_scale(self, scale: float) -> None:
        """Every group's learning rate to ``lr * scale * lr_mult``."""
        self.lr_scale = float(scale)
        set_learning_rate_scale(self.optimizer, self.lr, self.lr_scale)

    def set_lr_mult(self, mults: Dict[str, float]) -> None:
        """The finetuning multipliers ``{parameter name: multiplier}``
        (``FinetuningFreezeUnfreeze.lr_mult_for_epoch``) written into the
        parameter groups, at the current LR scale. The parameters of one
        group (a top-level module) share one multiplier; the optimizer has
        the groups per module (``init_train_state(per_module=True)``)."""
        if "name" not in self.optimizer.param_groups[0]:
            raise ValueError("set_lr_mult needs init_train_state(per_module=True)")
        per_group: Dict[str, set] = {}
        for name, m in mults.items():
            per_group.setdefault(name.split(".", 1)[0], set()).add(float(m))
        for group in self.optimizer.param_groups:
            found = per_group.get(group["name"], set())
            if len(found) != 1:
                raise ValueError(f"parameter group {group['name']}: multipliers {sorted(found)}")
            group["lr_mult"] = found.pop()
        self.set_lr_scale(self.lr_scale)

    def grad_step(self, x, pos, y, mask, generator: torch.Generator | None = None):
        """Forward and backward of one batch in training mode, the gradients
        added to ``.grad`` over ``accumulate_grad_batches``: ``(loss,
        logits)``, both detached.

        With ``grad_microbatch`` = mb > 0 and a batch B > mb that mb divides,
        the step runs over the k = B / mb chunks in order, each on its own
        generator (``chunk_generator``) and from the same BN running stats,
        which end as the mean of the chunks' (``model.py:277-321``); the
        loss is the mean of the chunks' and each chunk's gradient enters
        scaled by 1 / k. The net routes each chunk by the chunk's batch
        (``fused_train_lfa: auto``): B=32 at mb=16 takes the fused route,
        B=16 at mb=8 the unfused one. Any other B is the monolithic step.

        Under DDP (``data_parallel``, set by ``parallel.ParallelSteps``) the
        forward runs through the DDP wrapper, the loss and the running stats
        take that step's reductions, and only the backward that completes an
        accumulation group (its last chunk) all-reduces the gradients: the
        others run under ``no_sync``. Chunks are the rank's own rows."""
        self.net.train()
        b, mb = x.shape[0], self.grad_microbatch
        k = b // mb if 0 < mb < b and b % mb == 0 else 1
        par = self.data_parallel
        net = self.net if par is None else par.ddp
        if par is not None:
            par.begin(mask)
        syncs = self.accum + 1 >= self.accumulate_grad_batches
        # the net updates its BN buffers in place on every forward: each
        # chunk starts from the step's stats, and the buffers end as the
        # chunks' mean
        stats = [t for t in self.net.buffers() if t.is_floating_point()]
        start = torch._foreach_mul(stats, 1.0) if k > 1 else None
        losses, logits = [], []
        for i in range(k):
            rows = slice(i * mb, (i + 1) * mb) if k > 1 else slice(None)
            if i:
                torch._foreach_copy_(stats, start)
            no_sync = par is not None and not (syncs and i == k - 1)
            with net.no_sync() if no_sync else contextlib.nullcontext():
                out = net(x[rows], pos[rows], mask[rows],
                          chunk_generator(generator, i) if k > 1 else generator)
                if par is None:
                    loss = shown = self.criterion(out, y[rows])
                else:
                    loss, shown = par.chunk_loss(self.criterion, out, y[rows])
                (loss / (k * self.accumulate_grad_batches)).backward()
            if k > 1:
                if i:
                    torch._foreach_add_(total, stats)
                else:
                    total = torch._foreach_mul(stats, 1.0)
            losses.append(shown.detach())
            logits.append(out.detach())
        if k > 1:
            torch._foreach_mul_(total, 1.0 / k)
            torch._foreach_copy_(stats, total)
        loss = losses[0] if k == 1 else sum(losses[1:], losses[0]) * (1.0 / k)
        if par is not None:
            loss = par.finish(stats, loss)
        return loss, logits[0] if k == 1 else torch.cat(logits)

    def train_step(self, x, pos, y, mask, generator: torch.Generator | None = None):
        """One training batch (``grad_step``): ``(loss, logits)``, both
        detached. The optimizer updates when the batch completes an
        accumulation group."""
        if self.optimizer is None:
            self.init_train_state()
        loss, logits = self.grad_step(x, pos, y, mask, generator)
        self.step += 1
        self.accum += 1
        if self.accum == self.accumulate_grad_batches:
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.accum = 0
        return loss, logits

    @torch.no_grad()
    def eval_step(self, x, pos, y, mask, generator: torch.Generator | None = None):
        """Eval-mode forward on the sampled points: ``(loss, logits)``."""
        self.net.eval()
        logits = self.net(x, pos, mask, generator)
        return self.criterion(logits, y), logits

    @torch.inference_mode()
    def interp_step(self, x, pos, mask, sampled_pos, full_pos, full_mask,
                    generator: torch.Generator | None = None, fused: bool = True) -> torch.Tensor:
        """Forward on the sampled points, then k-NN interpolation of the
        logits onto the full clouds: ``(B, M, num_classes)`` float16.
        ``fused=False`` takes the two-op f32 interpolation (K1, then the
        weighting in torch) instead of K3 (``exact_interp_step``,
        ``predict.exact_interpolation``)."""
        self.net.eval()
        logits = self.net(x, pos, mask, generator)
        full = knn_interpolate(
            logits, sampled_pos, mask, full_pos, full_mask,
            k=self.interpolation_k, fused_payload=fused,
            # density-scaled by the sampled (key) cloud's count
            window=stage_window(self.interp_window, sampled_pos.shape[1]),
        )
        return full.to(torch.float16)

    # ------------------------------------------------------------------
    # checkpoints

    def save_checkpoint(self, ckpt_dir: str, state: Any = None) -> str:
        """Weights, BN buffers and hparams (``state_dict.npz`` +
        ``hparams.json``) plus the optimizer state and step. ``state`` is
        accepted for the reused checkpoint callbacks; the model owns its
        state."""
        from myria3d_tpu_torch.utils.checkpoint import save_checkpoint

        ckpt_dir = os.path.abspath(ckpt_dir)
        save_checkpoint(ckpt_dir, self.net.state_dict(), self.hparams or {})
        train_state = {"step": self.step}
        if self.optimizer is not None:
            train_state["optimizer"] = self.optimizer.state_dict()
        torch.save(train_state, os.path.join(ckpt_dir, TRAIN_STATE))
        return ckpt_dir

    def restore_train_state(self, ckpt_dir: str, optimizer: bool = True) -> None:
        """Load a checkpoint's weights and BN buffers (strict) and its step.
        ``optimizer=True`` resumes a fit: the stored optimizer state, and
        the accumulation group at ``step % accumulate_grad_batches``.
        ``optimizer=False`` is the finetune restore (``restore_opt_state=
        False``, ``model.py:474-503``): a fresh optimizer with the groups
        per module and a fresh accumulation group, as a fresh optax
        ``MultiSteps`` state."""
        from myria3d_tpu_torch.utils.checkpoint import load_state_dict

        device = next(self.net.parameters()).device
        self.net.load_state_dict(load_state_dict(ckpt_dir, device), strict=True)
        self.init_train_state(per_module=not optimizer)
        path = os.path.join(ckpt_dir, TRAIN_STATE)
        if os.path.isfile(path):
            stored = torch.load(path, map_location=device, weights_only=True)
            self.step = int(stored.get("step", 0))
            if optimizer:
                if "optimizer" in stored:
                    self.optimizer.load_state_dict(stored["optimizer"])
                self.accum = self.step % self.accumulate_grad_batches


def build_model(neural_net_class_name: str, neural_net_hparams: Dict[str, Any],
                lr: float = 1e-3, optimizer: Optional[Callable] = None,
                lr_scheduler: Optional[Callable] = None, criterion: Optional[Callable] = None,
                monitor: str = "val/loss_epoch", interpolation_k: int = 10,
                d_in: Optional[int] = None, num_classes: Optional[int] = None,
                classification_dict: Optional[dict] = None, accumulate_grad_batches: int = 1,
                grad_microbatch: int = 0, **_: Any) -> Model:
    """:class:`Model` from the keyword arguments of the JAX ``Model``
    (``configs/model/*.yaml``); the checkpoint hparams are the model
    section's plain entries, as the JAX package stores them."""
    hp = dict(neural_net_hparams)
    hparams = {
        "neural_net_class_name": neural_net_class_name,
        "neural_net_hparams": hp,
        "interpolation_k": int(interpolation_k),
        "d_in": int(d_in or hp.get("num_features")),
        "num_classes": int(num_classes or hp.get("num_classes")),
        "classification_dict": {str(k): v for k, v in (classification_dict or {}).items()},
    }
    return Model(build_net(neural_net_class_name, hp), interpolation_k, lr=lr,
                 optimizer=optimizer, lr_scheduler=lr_scheduler, criterion=criterion,
                 monitor=monitor, accumulate_grad_batches=accumulate_grad_batches,
                 grad_microbatch=grad_microbatch, hparams=hparams)
