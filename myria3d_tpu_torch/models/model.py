"""Task-level model: train, eval and predict steps over padded batches.

Port of ``myria3d_tpu/models/model.py``. The JAX package keeps an immutable
``TrainState`` (params, BN stats, optimizer state, step) and pure jitted
steps; here the train state lives in place: the net's parameters and BN
buffers, the ``torch.optim`` optimizer and the step count.

- ``train_step`` (``model.py:238-352``): forward in training mode (batch
  moment BN, dropout and decimation drawn from the step's generator), the
  criterion, backward, and an optimizer update every
  ``accumulate_grad_batches`` batches on the mean of their gradients (optax
  ``MultiSteps``); BN running stats move every batch.
- ``eval_step`` (``model.py:354-363``): eval-mode forward and loss.
- ``interp_step`` (``model.py:366-398``): the predict step, forward on the
  sampled points then the k-NN interpolation of the logits to every raw
  point of each subtile, shipped as f16.

Checkpoints are ``state_dict.npz`` + ``hparams.json`` (which the
predict path reads) plus ``train_state.pt`` with the optimizer state and
the step (``utils.checkpoint``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from myria3d_tpu_torch.models.criterion import CrossEntropyLoss
from myria3d_tpu_torch.models.modules.randla_net import RandLANet
from myria3d_tpu_torch.models.optimizers import adam
from myria3d_tpu_torch.ops.cuda_knn import stage_window
from myria3d_tpu_torch.ops.interpolate import knn_interpolate

# JAX hparams that only steer TPU memory or search exactness: the port's
# backward keeps what autograd needs, and K1 is exact within its window
_IGNORED_NET_HPARAMS = {"remat", "exact_knn"}
TRAIN_STATE = "train_state.pt"


def build_net(neural_net_class_name: str, neural_net_hparams: Dict[str, Any]) -> nn.Module:
    if neural_net_class_name != "RandLANet":
        raise NotImplementedError(
            f"{neural_net_class_name} is not ported yet (RandLANet only)"
        )
    hp = {k: v for k, v in neural_net_hparams.items() if k not in _IGNORED_NET_HPARAMS}
    dtype = hp.pop("dtype", None)
    if dtype not in (None, "float32"):
        raise NotImplementedError(f"compute dtype {dtype!r} is not ported yet")
    if not hp.pop("return_logits", True):
        raise NotImplementedError("log-softmax outputs are not ported")
    return RandLANet(**hp)


class Model(nn.Module):
    """Segmentation model (reference ``Model``): the net, its criterion and
    optimizer, and the train/eval/predict steps."""

    def __init__(self, net: RandLANet, interpolation_k: int = 10, *, lr: float = 1e-3,
                 optimizer: Optional[Callable] = None, lr_scheduler: Optional[Callable] = None,
                 criterion: Optional[Callable] = None, monitor: str = "val/loss_epoch",
                 accumulate_grad_batches: int = 1, hparams: Optional[dict] = None):
        super().__init__()
        self.net = net
        self.interpolation_k = int(interpolation_k)
        self.lr = float(lr)
        self.optimizer_factory = optimizer if optimizer is not None else adam
        self.lr_scheduler_factory = lr_scheduler
        self.criterion = criterion if criterion is not None else CrossEntropyLoss()
        self.monitor = monitor
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches or 1))
        self.hparams = hparams
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0   # train batches taken

    def set_sorted_window(self, window: int) -> None:
        """Window every search (the encoder graphs, the decoder's k=1
        upsampling and the full-cloud interpolation) to ~``window`` sorted
        key positions per 256-query tile. Requires x-sorted clouds (the
        predict pipeline appends ``SortPointsByX``, so the in-model sort is
        switched off as in ``model.py:192-211``); 0 is a full scan."""
        self.net.knn_window = int(window)
        self.net.sort_inputs = False

    # ------------------------------------------------------------------
    # train state

    def init_train_state(self) -> None:
        """A fresh optimizer over the net's parameters, step 0."""
        self.optimizer = self.optimizer_factory(lr=self.lr)(self.net.parameters())
        self.optimizer.zero_grad(set_to_none=True)
        self.step = 0

    def train_step(self, x, pos, y, mask, generator: torch.Generator | None = None):
        """One training batch: ``(loss, logits)``, both detached. The
        optimizer updates when the batch completes an accumulation group."""
        if self.optimizer is None:
            self.init_train_state()
        self.net.train()
        logits = self.net(x, pos, mask, generator)
        loss = self.criterion(logits, y)
        (loss / self.accumulate_grad_batches).backward()
        self.step += 1
        if self.step % self.accumulate_grad_batches == 0:
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        return loss.detach(), logits.detach()

    @torch.no_grad()
    def eval_step(self, x, pos, y, mask, generator: torch.Generator | None = None):
        """Eval-mode forward on the sampled points: ``(loss, logits)``."""
        self.net.eval()
        logits = self.net(x, pos, mask, generator)
        return self.criterion(logits, y), logits

    @torch.inference_mode()
    def interp_step(self, x, pos, mask, sampled_pos, full_pos, full_mask,
                    generator: torch.Generator | None = None) -> torch.Tensor:
        """Forward on the sampled points, then k-NN interpolation of the
        logits onto the full clouds: ``(B, M, num_classes)`` float16."""
        self.net.eval()
        logits = self.net(x, pos, mask, generator)
        full = knn_interpolate(
            logits, sampled_pos, mask, full_pos, full_mask,
            k=self.interpolation_k, fused_payload=True,
            # density-scaled by the sampled (key) cloud's count
            window=stage_window(self.net.knn_window, sampled_pos.shape[1]),
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

    def restore_train_state(self, ckpt_dir: str) -> None:
        """Load a checkpoint's weights and BN buffers (strict) and, when
        stored, its optimizer state and step (resuming a fit)."""
        from myria3d_tpu_torch.utils.checkpoint import load_state_dict

        device = next(self.net.parameters()).device
        self.net.load_state_dict(load_state_dict(ckpt_dir, device), strict=True)
        self.init_train_state()
        path = os.path.join(ckpt_dir, TRAIN_STATE)
        if os.path.isfile(path):
            stored = torch.load(path, map_location=device, weights_only=True)
            self.step = int(stored.get("step", 0))
            if "optimizer" in stored:
                self.optimizer.load_state_dict(stored["optimizer"])


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
    if grad_microbatch:
        raise NotImplementedError("model.grad_microbatch is not ported yet")
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
                 hparams=hparams)
