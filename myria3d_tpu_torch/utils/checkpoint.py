"""Checkpoints of the port: ``state_dict.npz`` + ``hparams.json``.

The state dict carries the reference's pyg keys (``PyGRandLANet``, and
the same layout for PointNet++). The weight carry-over from a JAX
checkpoint (``state_dict_from_jax``) maps the JAX parameter trees, held as
numpy arrays, with ``flax_to_torch_state_dict``: that mapping and its
inverse (``convert_randlanet_state_dict``) are copied from
``myria3d_tpu/utils/torch_ckpt.py:28-141`` (numpy only; reading an orbax
checkpoint stays with ``scripts/export_torch_checkpoint.py``); both serve
every net of the zoo. The hparams are the model section of the training
config, as JSON. A checkpoint written by training also holds
``train_state.pt`` (optimizer state and step,
``models.model.Model.save_checkpoint``), which predict does not read.

A reference Lightning checkpoint (``.ckpt``) converts with
``convert_checkpoint_file``: its state dict is the port's, under the
``model.`` prefix (``torch_ckpt.py:97,143``). ``golden_pyg_state_shapes``
and ``make_synthetic_lightning_checkpoint`` (``torch_ckpt.py:176,234``)
build the stand-in the parity harness is tested on.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from myria3d_tpu_torch.models.model import Model, build_model, build_net

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
    (``Model.set_sorted_window``); a net whose hparams carry ``exact_knn``
    keeps it, and with it its full scans under any window."""
    with open(os.path.join(ckpt_dir, HPARAMS)) as f:
        hparams = json.load(f)
    net = build_net(hparams["neural_net_class_name"], hparams["neural_net_hparams"])
    model = Model(net, interpolation_k=hparams.get("interpolation_k", 10), hparams=hparams)
    model.net.load_state_dict(load_state_dict(ckpt_dir), strict=True)
    model.set_sorted_window(0)
    return model.to(device).eval()


def convert_checkpoint_file(torch_ckpt_path: str, out_dir: str, hparams: Dict[str, Any]) -> str:
    """A reference Lightning ``.ckpt`` -> the port's checkpoint directory
    (``torch_ckpt.py:143``): the net that ``hparams`` (``Model`` keyword
    arguments, as ``build_model`` takes them) describes, its weights and BN
    statistics read from the checkpoint's state dict (``model.`` prefix
    stripped; entries the net lacks, such as ``num_batches_tracked``, are
    ignored), loaded with ``strict=True``."""
    raw = torch.load(torch_ckpt_path, map_location="cpu", weights_only=False)
    state_dict = strip_lightning_prefix(raw.get("state_dict", raw))
    model = build_model(**{k: v for k, v in hparams.items() if k != "_target_"})
    want = model.net.state_dict()
    missing = sorted(k for k in want if k not in state_dict)
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} entries of the net: {missing[:5]}")
    for k, v in want.items():
        if state_dict[k].shape != tuple(v.shape):
            raise ValueError(f"shape mismatch for {k}: checkpoint {state_dict[k].shape} vs "
                             f"net {tuple(v.shape)}")
    model.net.load_state_dict({k: torch.from_numpy(state_dict[k]) for k in want}, strict=True)
    return model.save_checkpoint(out_dir)


def golden_pyg_state_shapes(num_features: int = 9, num_classes: int = 7) -> Dict[str, Tuple[int, ...]]:
    """Every ``PyGRandLANet(num_features, num_classes)`` state_dict entry ->
    shape, from the reference module definitions (``torch_ckpt.py:176``:
    ``pyg_randla_net.py:42-53`` net plan, ``:97-109`` SharedMLP = pyg MLP,
    ``:112-119`` LocalFeatureAggregation, ``:155-177``
    DilatedResidualBlock): the convertibility contract with the shipped
    proto151 checkpoint."""
    d_b = max(32, num_classes, num_features)
    shapes: Dict[str, Tuple[int, ...]] = {}

    def linear(prefix, din, dout, bias=True):
        shapes[f"{prefix}.weight"] = (dout, din)
        if bias:
            shapes[f"{prefix}.bias"] = (dout,)

    def bn(prefix, d):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{leaf}"] = (d,)

    def mlp(prefix, chans, bias=True, norm=True):
        for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
            linear(f"{prefix}.lins.{i}", a, b, bias=bias)
            if norm:
                bn(f"{prefix}.norms.{i}", b)

    def lfa(prefix, channels):
        mlp(f"{prefix}.mlp_encoder", [10, channels // 2])
        mlp(f"{prefix}.mlp_attention", [channels, channels], bias=False, norm=False)
        mlp(f"{prefix}.mlp_post_attention", [channels, channels])

    def block(prefix, d_in, d_out):
        mlp(f"{prefix}.mlp1", [d_in, d_out // 8])
        mlp(f"{prefix}.shortcut", [d_in, d_out])
        mlp(f"{prefix}.mlp2", [d_out // 2, d_out])
        lfa(f"{prefix}.lfa1", d_out // 4)
        lfa(f"{prefix}.lfa2", d_out // 2)

    linear("fc0", num_features, d_b)
    block("block1", d_b, 32)
    block("block2", 32, 128)
    block("block3", 128, 256)
    block("block4", 256, 512)
    mlp("mlp_summit", [512, 512])
    # decoder inputs concat the upsampled features with the decimated skips
    # (pyg_randla_net.py:48-51, 76-79)
    mlp("fp4.nn", [768, 256])
    mlp("fp3.nn", [384, 128])
    mlp("fp2.nn", [160, 32])
    mlp("fp1.nn", [64, d_b])
    mlp("mlp_classif", [d_b, 64, 32])
    linear("fc_classif", 32, num_classes)
    return shapes


def make_synthetic_lightning_checkpoint(path: str, num_features: int = 9, num_classes: int = 7,
                                        seed: int = 0) -> str:
    """A Lightning-style ``.ckpt`` with the reference ``PyGRandLANet`` state
    dict layout and random (BN-valid) values (``torch_ckpt.py:234``): the
    stand-in for the proto151 checkpoint, which is not in the repository."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in golden_pyg_state_shapes(num_features, num_classes).items():
        if key.endswith("running_var"):
            val = rng.uniform(0.5, 2.0, size=shape)  # rsqrt-safe
        else:
            val = rng.normal(0.0, 0.2, size=shape)
        sd[f"model.{key}"] = torch.from_numpy(val.astype(np.float32))
        if key.endswith("running_var"):
            sd[f"model.{key.rsplit('.', 1)[0]}.num_batches_tracked"] = torch.tensor(
                7, dtype=torch.int64)
    torch.save({"state_dict": sd, "epoch": 100}, path)
    return path
