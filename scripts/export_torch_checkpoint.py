"""Convert a JAX (orbax) checkpoint of myria3d_tpu into the PyTorch port's
format, and write the synthetic toy tile beside it.

    python scripts/export_torch_checkpoint.py \
        [--ckpt trained_model_assets/randlanet_toy_V0.5.0_ckpt] \
        [--out trained_model_assets/randlanet_toy_V0.5.0_torch]

Writes ``<out>/state_dict.npz`` (reference PyGRandLANet keys, via
``myria3d_tpu_torch.utils.checkpoint.flax_to_torch_state_dict``),
``<out>/hparams.json`` (the model hparams) and ``<out>/toy_tile.las``
(``write_synthetic_toy_las``, seed 42, 60 000 points), so the port's
predict path needs neither JAX, orbax nor h5py to run the toy checkpoint.
Runs on the CPU; needs the JAX package's dependencies.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEFAULT_CKPT = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_ckpt")
DEFAULT_OUT = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_torch")
TOY_TILE = "toy_tile.las"

# hparams the port's Model reads (the rest configure training)
_KEPT = ("neural_net_class_name", "neural_net_hparams", "interpolation_k",
         "d_in", "num_classes", "classification_dict")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from myria3d_tpu.models.model import Model
    from myria3d_tpu.pctl.dataset.toy_dataset import write_synthetic_toy_las
    from myria3d_tpu_torch.utils.checkpoint import save_checkpoint, state_dict_from_jax

    model, state = Model.load_from_checkpoint(args.ckpt)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    stats = jax.tree_util.tree_map(np.asarray, jax.device_get(state.batch_stats))
    hparams = {k: model.raw_hparams[k] for k in _KEPT if k in model.raw_hparams}
    if "classification_dict" in hparams:  # JSON keys are strings
        hparams["classification_dict"] = {
            str(k): v for k, v in hparams["classification_dict"].items()
        }
    save_checkpoint(args.out, state_dict_from_jax(params, stats), hparams)
    write_synthetic_toy_las(os.path.join(args.out, TOY_TILE), n_points=60_000, seed=42)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
