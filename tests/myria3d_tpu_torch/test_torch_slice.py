"""The whole predict slice of the PyTorch port held against the JAX
package: RandLA-Net eval forward and the full-cloud interpolation of the
predict step (``myria3d_tpu/models/model.py:372-396``) on weights converted
from a randomly initialised JAX model, and the converted toy checkpoint.

Decimation is made deterministic on both sides (keep the first
``max(1, valid // 4)`` slots, as in ``test_randla_torch_oracle.py:211``):
JAX's and torch's random draws cannot match. Tolerance rtol 1e-4 /
atol 1e-5, the oracle test's.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myria3d_tpu.models.modules.randla_net as jax_rl
import myria3d_tpu_torch.models.modules.randla_net as port_rl
from myria3d_tpu.models.modules.randla_net import RandLANet as JaxRandLANet
from myria3d_tpu.ops.interpolate import knn_interpolate as jax_knn_interpolate
from myria3d_tpu.utils.torch_ckpt import golden_pyg_state_shapes
from myria3d_tpu_torch.models.model import Model, build_net
from myria3d_tpu_torch.ops.interpolate import knn_interpolate
from myria3d_tpu_torch.utils.checkpoint import load_checkpoint, state_dict_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TORCH_CKPT = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_torch")
JAX_CKPT = os.path.join(REPO, "trained_model_assets", "randlanet_toy_V0.5.0_ckpt")


def _jax_det_decimation(rng, mask, decimation):
    b, n = mask.shape
    n_out = n // decimation
    idx = jnp.broadcast_to(jnp.arange(n_out, dtype=jnp.int32)[None], (b, n_out))
    valid = jnp.sum(mask, axis=1)
    kept = jnp.where(valid > 0, jnp.maximum(1, valid // decimation), 0)
    new_mask = jnp.arange(n_out)[None, :] < kept[:, None]
    return jnp.where(new_mask, idx, 0), new_mask


def _port_det_decimation(mask, decimation, generator=None):
    b, n = mask.shape
    n_out = n // decimation
    idx = torch.arange(n_out).expand(b, n_out)
    valid = mask.sum(1)
    kept = torch.where(valid > 0, (valid // decimation).clamp(min=1), 0)
    new_mask = torch.arange(n_out)[None, :] < kept[:, None]
    return torch.where(new_mask, idx, 0), new_mask


@pytest.fixture
def det_decimation(monkeypatch):
    monkeypatch.setattr(jax_rl, "random_decimation", _jax_det_decimation)
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)


def _random_jax_variables(net, n, seed=0):
    vs = flax.core.unfreeze(jax.jit(lambda r, x, p, m: net.init(r, x, p, m, train=False))(
        {"params": jax.random.PRNGKey(seed), "decimation": jax.random.PRNGKey(1)},
        jnp.zeros((1, n, 9)), jnp.zeros((1, n, 3)), jnp.ones((1, n), bool)))
    rng = np.random.default_rng(seed)

    def walk(tree, in_bn=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, in_bn or k.startswith("MaskedBatchNorm"))
            elif in_bn:   # exercise eval BN: non-trivial affine + running stats
                lo, hi = (0.5, 1.5) if k in ("var", "scale") else (-0.3, 0.3)
                out[k] = rng.uniform(lo, hi, np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(vs["params"]), walk(vs["batch_stats"])


def test_forward_and_interp_step_match_jax(det_decimation, jax_search_on_its_kernel):
    n, m = 1280, 2048
    rng = np.random.default_rng(42)
    pos = rng.uniform(-1.0, 1.0, (2, n, 3)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (2, n, 9)).astype(np.float32)
    mask = np.arange(n)[None] < np.array([[n], [1088]])
    full_pos = rng.uniform(-1.0, 1.0, (2, m, 3)).astype(np.float32)
    full_mask = np.arange(m)[None] < np.array([[m], [1500]])

    jnet = JaxRandLANet(num_features=9, num_classes=7)
    params, stats = _random_jax_variables(jnet, n)
    want_logits = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             jnp.asarray(pos), jnp.asarray(mask), train=False,
                             rngs={"decimation": jax.random.PRNGKey(2)})
    # the predict step's interpolation body; on the CPU JAX runs its
    # two-op f32 path, here on its own search kernel (see the fixture)
    jax_search_on_its_kernel()
    want_full = np.asarray(jax_knn_interpolate(
        want_logits, jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(full_pos),
        jnp.asarray(full_mask), k=10))

    net = build_net("RandLANet", {"num_features": 9, "num_classes": 7})
    net.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    model = Model(net, interpolation_k=10).eval()
    args = [torch.from_numpy(a) for a in (x, pos, mask, pos, full_pos, full_mask)]
    with torch.no_grad():
        logits = net(*args[:3])
        full = knn_interpolate(logits, args[3], args[2], args[4], args[5], k=10,
                               fused_payload=True)
    step = model.interp_step(*args)

    v = mask
    np.testing.assert_allclose(logits.numpy()[v], np.asarray(want_logits)[v],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(logits.numpy()[v].argmax(-1),
                                  np.asarray(want_logits)[v].argmax(-1))
    np.testing.assert_allclose(full.numpy(), want_full, rtol=1e-4, atol=1e-5)
    assert step.dtype == torch.float16 and step.shape == (2, m, 7)
    torch.testing.assert_close(step, full.half(), rtol=0, atol=0)


def test_converted_toy_checkpoint_loads_and_matches_export():
    """The committed port checkpoint has the reference layout and equals a
    fresh conversion of the committed JAX checkpoint."""
    from myria3d_tpu.models.model import Model as JaxModel

    model = load_checkpoint(TORCH_CKPT)
    shapes = golden_pyg_state_shapes(9, 7)
    sd = model.net.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == shapes
    _, state = JaxModel.load_from_checkpoint(JAX_CKPT)
    fresh = state_dict_from_jax(jax.device_get(state.params), jax.device_get(state.batch_stats))
    assert fresh.keys() == sd.keys()
    for k, v in fresh.items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    assert not model.training and model.interpolation_k == 10
