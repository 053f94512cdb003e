"""The JAX package's own bfloat16 train-step gradient against its float32
one, for the PointNet++ step of ``chip_smoke.py`` phase 18d, beside the
port's on the CPU.

    python scripts/bf16_gradient_reference.py [--b 4] [--seeds 0 1 2]

Phase 18d holds the card's bf16 step (B=16, N=12288) to a whole-gradient
cosine against its f32 step. How far bf16 moves that gradient is a property
of the net and the batch, not of the port: this script measures it on the
JAX package with the card's weights (``chip_smoke.pn2_model``: a full-width
PointNet++ from torch seed 0, converted to the flax tree) and
``bench.py --train``'s batch in normalized units, at N=12288 and the
batch the CPU has room for (B=4 by default: a quarter of the card's, so
more bf16 noise a gradient than the card's step sees). Both dtypes of a
side run from the same weights on the same batch, the head's dropout on
with one key (JAX) or one generator (the port). JAX ranks neighbours by an
exact scan summed in the port's association (its Pallas kernel replaced
by a jnp scan), so both sides group the same points.

Prints one line per batch seed (the whole-gradient cosine bf16/f32 of JAX
and of the port, and the three least cosines per tensor of JAX), then the
least JAX cosine: ``DTYPE_COS["PointNet2"]`` in ``chip_smoke.py``. Runs on
the CPU (~45 s a seed at B=4); needs the JAX package's dependencies.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def exact_scan(q4, k4, k, window=0, **_):
    """JAX's kNN kernel as a full jnp scan: w^2, then dx^2, dy^2, dz^2 (the
    port's K1 association), the k smallest by ``lax.top_k``."""
    import jax
    import jax.numpy as jnp

    s = k4[:, None, :, 3] * k4[:, None, :, 3]
    for c in range(3):
        d = q4[:, :, None, c] - k4[:, None, :, c]
        s = s + d * d
    neg, idx = jax.lax.top_k(-s, k)
    return idx.astype(jnp.int32), -neg


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=4, help="clouds a batch (the card's step: 16)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2], help="batch seeds")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from myria3d_tpu.models.criterion import CrossEntropyLoss as JaxCrossEntropy
    from myria3d_tpu.models.modules.pointnet2 import PointNet2 as JaxPointNet2
    from myria3d_tpu.ops import pallas_knn
    from myria3d_tpu.utils.torch_ckpt import convert_randlanet_state_dict, flax_to_torch_state_dict

    torch.set_num_threads(args.threads)
    pallas_knn.knn_pallas_available = lambda k, nk: True
    pallas_knn.knn_topk_pallas = exact_scan

    state = {k: v.numpy() for k, v in chip_smoke.pn2_model("cpu").net.state_dict().items()}
    n = chip_smoke.TRAIN_N
    template = jax.jit(lambda r, x, p, m: JaxPointNet2(**chip_smoke.PN2_HPARAMS).init(
        r, x, p, m, train=False))(jax.random.PRNGKey(0), jnp.zeros((1, n, 9)),
                                  jnp.zeros((1, n, 3)), jnp.ones((1, n), bool))
    params, stats = convert_randlanet_state_dict(state, template["params"],
                                                 template["batch_stats"])

    def jax_grads(dtype, x, pos, y, mask):
        net = JaxPointNet2(**chip_smoke.PN2_HPARAMS, dtype=dtype)

        def loss_fn(p):
            logits, _ = net.apply({"params": p, "batch_stats": stats}, x, pos, mask, train=True,
                                  mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(7)})
            return JaxCrossEntropy()(logits, y)

        grads = jax.jit(jax.grad(loss_fn))(params)
        g = flax_to_torch_state_dict(jax.device_get(grads), {})
        return {k: np.asarray(v, np.float64) for k, v in g.items()}

    def port_grads(dtype, batch):
        model = chip_smoke.pn2_model("cpu")
        model.set_compute_dtype(dtype)
        model.init_train_state()
        model.grad_step(*batch, torch.Generator().manual_seed(7))
        return {k: p.grad.double().numpy() for k, p in model.net.named_parameters()}

    least = 1.0
    for seed in args.seeds:
        x, pos, y, mask = chip_smoke.train_batch(args.b, seed)
        pos = pos / 25.0
        jargs = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(y.astype(np.int32)), jnp.asarray(mask))
        j32 = jax_grads(jnp.float32, *jargs)
        j16 = jax_grads(jnp.bfloat16, *jargs)
        batch = tuple(torch.from_numpy(a) for a in (x, pos, y, mask))
        p32, p16 = port_grads("float32", batch), port_grads("bfloat16", batch)
        keys = sorted(p32)
        flat = lambda g: np.concatenate([g[k].ravel() for k in keys])   # noqa: E731
        c_jax, c_port = cosine(flat(j16), flat(j32)), cosine(flat(p16), flat(p32))
        per = sorted((cosine(j16[k].ravel(), j32[k].ravel()), k) for k in keys
                     if np.linalg.norm(j32[k]) > 1e-6 * np.linalg.norm(flat(j32)))
        print(f"B={args.b} N={n} seed {seed}: gradient cosine bf16/f32 JAX {c_jax:.6f}, "
              f"port (CPU) {c_port:.6f}; JAX's least per tensor: "
              + ", ".join(f"{k} {c:.4f}" for c, k in per[:3]), flush=True)
        least = min(least, c_jax)
    print(f"least JAX cosine over seeds {args.seeds}: {least:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
