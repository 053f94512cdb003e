"""Staged-unfreeze finetuning through per-subtree learning-rate multipliers.

Port of ``myria3d_tpu/callbacks/finetuning_callbacks.py:22-55`` (reference
``FinetuningFreezeUnfreeze``): everything frozen but the last FC from
epoch 0, the whole FC head at ``1 / lr_factor`` from
``unfreeze_fc_end_epoch``, the decoder at ``1 / lr_factor`` from
``unfreeze_decoder_train_epoch``. The multipliers are keyed on the first
component of a parameter's name, the top-level module of RandLA-Net, whose
names the port shares with the JAX package. ``Model.set_lr_mult`` applies
them to the optimizer's parameter groups (0 freezes, the moments still
move).
"""

from __future__ import annotations

from typing import Dict

from torch import nn

# top-level modules per group of the RandLA-Net tree
_LAST_FC = ("fc_classif",)
_FC_HEAD = ("fc_classif", "mlp_classif")
_DECODER = ("fp1", "fp2", "fp3", "fp4", "mlp_summit")


class FinetuningFreezeUnfreeze:
    def __init__(self, unfreeze_fc_end_epoch: int = 1, unfreeze_decoder_train_epoch: int = 3,
                 lr_factor: float = 100.0):
        self.unfreeze_fc_end_epoch = int(unfreeze_fc_end_epoch)
        self.unfreeze_decoder_train_epoch = int(unfreeze_decoder_train_epoch)
        self.lr_factor = float(lr_factor)

    def mult(self, top: str, epoch: int) -> float:
        """The multiplier of the top-level module ``top`` at ``epoch``."""
        if top in _LAST_FC:
            return 1.0
        if top in _FC_HEAD and epoch >= self.unfreeze_fc_end_epoch:
            return 1.0 / self.lr_factor
        if top in _DECODER and epoch >= self.unfreeze_decoder_train_epoch:
            return 1.0 / self.lr_factor
        return 0.0

    def lr_mult_for_epoch(self, net: nn.Module, epoch: int) -> Dict[str, float]:
        """``{parameter name: multiplier}`` for this epoch."""
        return {name: self.mult(name.split(".", 1)[0], epoch)
                for name, _ in net.named_parameters()}
