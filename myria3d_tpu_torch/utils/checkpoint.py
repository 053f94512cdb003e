"""Checkpoints of the port: ``state_dict.npz`` + ``hparams.json``.

The state dict carries the reference ``PyGRandLANet`` keys, so it is the
same mapping ``myria3d_tpu.utils.torch_ckpt.flax_to_torch_state_dict``
produces from a JAX checkpoint (``state_dict_from_jax``). The hparams are
the model section of the training config, as JSON. A checkpoint written by
training also holds ``train_state.pt`` (optimizer state and step,
``models.model.Model.save_checkpoint``), which predict does not read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from myria3d_tpu_torch.models.model import Model, build_net

STATE_DICT = "state_dict.npz"
HPARAMS = "hparams.json"


def state_dict_from_jax(params: Any, batch_stats: Any) -> Dict[str, torch.Tensor]:
    """Torch state dict (reference keys) from JAX ``params``/``batch_stats``
    trees held as numpy arrays."""
    from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict

    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in flax_to_torch_state_dict(params, batch_stats).items()
    }


def save_checkpoint(ckpt_dir: str, state_dict: Dict[str, torch.Tensor],
                    hparams: Dict[str, Any]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    np.savez(os.path.join(ckpt_dir, STATE_DICT),
             **{k: v.detach().cpu().numpy() for k, v in state_dict.items()})
    with open(os.path.join(ckpt_dir, HPARAMS), "w") as f:
        json.dump(hparams, f, indent=1)
    return ckpt_dir


def load_state_dict(ckpt_dir: str, device: str | torch.device = "cpu") -> Dict[str, torch.Tensor]:
    with np.load(os.path.join(ckpt_dir, STATE_DICT)) as npz:
        return {k: torch.from_numpy(npz[k]).to(device) for k in npz.files}


def load_checkpoint(ckpt_dir: str, device: str | torch.device = "cpu") -> Model:
    """The eval-mode :class:`Model` stored in ``ckpt_dir``, on ``device``.
    Searches are full scans until the caller windows x-sorted clouds
    (``Model.set_sorted_window``)."""
    with open(os.path.join(ckpt_dir, HPARAMS)) as f:
        hparams = json.load(f)
    net = build_net(hparams["neural_net_class_name"], hparams["neural_net_hparams"])
    model = Model(net, interpolation_k=hparams.get("interpolation_k", 10), hparams=hparams)
    model.net.load_state_dict(load_state_dict(ckpt_dir), strict=True)
    model.set_sorted_window(0)
    return model.to(device).eval()
