"""Checkpoints of the port: ``state_dict.npz`` + ``hparams.json``.

The state dict carries the reference ``PyGRandLANet`` keys. The weight
carry-over from a JAX checkpoint (``state_dict_from_jax``) maps the JAX
parameter trees, held as numpy arrays, with ``flax_to_torch_state_dict``:
that mapping and its inverse (``convert_randlanet_state_dict``) are copied
from ``myria3d_tpu/utils/torch_ckpt.py:28-141`` (numpy only; reading an
orbax checkpoint stays with ``scripts/export_torch_checkpoint.py``). The
hparams are the model section of the training config, as JSON. A
checkpoint written by training also holds ``train_state.pt`` (optimizer
state and step, ``models.model.Model.save_checkpoint``), which predict does
not read.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from myria3d_tpu_torch.models.model import Model, build_net

STATE_DICT = "state_dict.npz"
HPARAMS = "hparams.json"

_DENSE_RE = re.compile(r"^Dense_(\d+)$")
_BN_RE = re.compile(r"^MaskedBatchNorm_(\d+)$")
_FP_RE = re.compile(r"^fp(\d+)$")


def _torch_prefix(path: Tuple[str, ...]) -> str:
    """Translate a flax module path to the torch state_dict prefix."""
    parts = []
    for comp in path:
        m = _DENSE_RE.match(comp)
        if m:
            parts.append(f"lins.{m.group(1)}")
            continue
        m = _BN_RE.match(comp)
        if m:
            parts.append(f"norms.{m.group(1)}")
            continue
        m = _FP_RE.match(comp)
        if m:
            parts.append(f"{comp}.nn")
            continue
        parts.append(comp)
    return ".".join(parts)


_LEAF_MAP_PARAMS = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_LEAF_MAP_STATS = {"mean": "running_mean", "var": "running_var"}


def _convert_tree(
    tree: Any,
    state_dict: Dict[str, np.ndarray],
    leaf_map: Dict[str, str],
    path: Tuple[str, ...] = (),
    strict: bool = True,
):
    """Recursively fill a flax tree from the torch state_dict."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return type(dict(tree))(
            {
                k: _convert_tree(v, state_dict, leaf_map, path + (k,), strict)
                for k, v in dict(tree).items()
            }
        )
    # leaf: path[:-1] is the module path, path[-1] the leaf name
    *mods, leaf = path
    # torch top-level plain Linear layers have no pyg-MLP nesting
    prefix = _torch_prefix(tuple(mods))
    torch_leaf = leaf_map.get(leaf)
    if torch_leaf is None:
        raise KeyError(f"No torch mapping for flax leaf '{leaf}' at {path}")
    key = f"{prefix}.{torch_leaf}" if prefix else torch_leaf
    if key not in state_dict:
        if strict:
            raise KeyError(
                f"Missing '{key}' in torch state_dict (flax path {path})"
            )
        return tree
    value = np.asarray(state_dict[key], np.float32)
    if leaf == "kernel":
        value = value.T  # torch (out, in) -> flax (in, out)
    expected = np.shape(tree)
    if value.shape != tuple(expected):
        raise ValueError(
            f"Shape mismatch for {key}: torch {value.shape} vs flax {expected}"
        )
    return value


def strip_lightning_prefix(state_dict: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Lightning ckpts nest the net under ``model.`` (reference
    ``Model.__init__`` attribute name, ``models/model.py:62``)."""
    out = {}
    for k, v in state_dict.items():
        k = k[len("model."):] if k.startswith("model.") else k
        try:
            out[k] = np.asarray(v, np.float32)
        except Exception:
            out[k] = np.asarray(v.detach().cpu().numpy(), np.float32)
    return out


def convert_randlanet_state_dict(
    state_dict: Dict[str, np.ndarray], params: Any, batch_stats: Any
) -> Tuple[Any, Any]:
    """Map a PyGRandLANet state_dict onto (params, batch_stats) trees shaped
    like the flax RandLANet."""
    new_params = _convert_tree(params, state_dict, _LEAF_MAP_PARAMS)
    new_stats = _convert_tree(batch_stats, state_dict, _LEAF_MAP_STATS)
    return new_params, new_stats


def flax_to_torch_state_dict(params: Any, batch_stats: Any) -> Dict[str, np.ndarray]:
    """Inverse mapping (for tests and for exporting back to torch users)."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree, leaf_map, path=()):
        for k, v in dict(tree).items():
            p = path + (k,)
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, leaf_map, p)
            else:
                *mods, leaf = p
                key = _torch_prefix(tuple(mods))
                tl = leaf_map[leaf]
                val = np.asarray(v, np.float32)
                if leaf == "kernel":
                    val = val.T
                out[f"{key}.{tl}" if key else tl] = val

    walk(params, _LEAF_MAP_PARAMS)
    walk(batch_stats, _LEAF_MAP_STATS)
    return out


def state_dict_from_jax(params: Any, batch_stats: Any) -> Dict[str, torch.Tensor]:
    """Torch state dict (reference keys) from JAX ``params``/``batch_stats``
    trees held as numpy arrays."""
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
