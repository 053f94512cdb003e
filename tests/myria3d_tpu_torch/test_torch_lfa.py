"""The port's LocalFeatureAggregation (K2's plain version on the CPU) held
against the JAX package:

- the whole module (folded encoder, pooled attention, post-attention MLP)
  within 1e-4 of JAX's unfused LFA path on the same converted weights;
- the pooled features within the 2e-2 envelope of
  ``lfa_attention_pallas`` in interpret mode, whose gather rides bf16
  (``tests/myria3d_tpu/ops/test_pallas_lfa.py:76``).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myria3d_tpu.models.modules.randla_net import LocalFeatureAggregation as JaxLFA
from myria3d_tpu.ops.pallas_lfa import lfa_attention_pallas
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch.models.modules.randla_net import LocalFeatureAggregation
from myria3d_tpu_torch.ops.cuda_knn import knn_topk_plain
from myria3d_tpu_torch.ops.cuda_lfa import lfa_attention, lfa_attention_plain
from myria3d_tpu_torch.ops.knn import centred_clouds, knn_graph

torch.set_num_threads(1)


def _sorted_batch(rng, b, n, c_in, n_valid):
    pos = np.stack([rng.uniform(0, 50, (b, n)), rng.uniform(0, 50, (b, n)),
                    rng.uniform(0, 3, (b, n))], axis=-1).astype(np.float32)
    pos = np.take_along_axis(pos, np.argsort(pos[..., :1], axis=1), axis=1)
    mask = np.arange(n)[None] < np.asarray(n_valid)[:, None]
    x = rng.uniform(-1, 1, (b, n, c_in)).astype(np.float32)
    return x, pos, mask


def _jax_standard_inputs(pos, idx, nv):
    """The channels-first tensors JAX's DilatedResidualBlock builds."""
    idx_t, nv_t = jnp.swapaxes(idx, 1, 2), jnp.swapaxes(nv, 1, 2)
    pos_cf = jnp.swapaxes(pos, 1, 2)
    pos_j = jax.vmap(lambda t, i: t[:, i])(pos_cf, idx_t)
    pos_i = pos_cf[:, :, None, :]
    diff = pos_j - pos_i
    dist = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=1, keepdims=True), 0.0))
    rel = jnp.concatenate([jnp.broadcast_to(pos_i, pos_j.shape), pos_j, diff, dist], axis=1)
    return rel, idx_t, nv_t


def _randomized_variables(lfa, args, seed):
    """Initialised variables with every BatchNorm's affine and running
    statistics randomised, so the eval-BN fold is exercised."""
    vs = flax.core.unfreeze(jax.jit(lambda r, *a: lfa.init(r, *a, False))(
        {"params": jax.random.PRNGKey(seed)}, *args))
    rng = np.random.default_rng(seed)

    def walk(tree, in_bn=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, in_bn or k.startswith("MaskedBatchNorm"))
            elif in_bn:
                lo, hi = (0.5, 1.5) if k in ("var", "scale") else (-0.5, 0.5)
                out[k] = rng.uniform(lo, hi, np.shape(v)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return {"params": walk(vs["params"]), "batch_stats": walk(vs["batch_stats"])}


@pytest.mark.parametrize("channels,k", [(16, 16), (64, 16), (32, 8)])
def test_lfa_module_matches_jax_unfused(channels, k):
    rng = np.random.default_rng(channels + k)
    x, pos, mask = _sorted_batch(rng, 2, 1024, channels // 2, [1024, 700])
    idx, _, nv = knn_graph(torch.from_numpy(pos), torch.from_numpy(mask), k)
    rel, idx_t, nv_t = _jax_standard_inputs(jnp.asarray(pos), jnp.asarray(idx.numpy()),
                                            jnp.asarray(nv.numpy()))
    lfa = JaxLFA(channels)
    args = (jnp.asarray(x), rel, idx_t, nv_t, jnp.asarray(mask))
    vs = _randomized_variables(lfa, args, seed=channels)
    want = np.asarray(jax.jit(lambda v, *a: lfa.apply(v, *a, False))(vs, *args))

    port = LocalFeatureAggregation(channels, bn_momentum=0.01).eval()
    state = {k_: torch.tensor(v) for k_, v in
             flax_to_torch_state_dict(vs["params"], vs["batch_stats"]).items()}
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(pos), idx, nv).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pooled_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    c_in, k, window = 8, 8, 1024
    x, pos, mask = _sorted_batch(rng, 1, 2048, c_in, [1800])
    q4, k4 = centred_clouds(*map(torch.from_numpy, (pos, pos, mask)))
    idx, d2 = knn_topk_plain(q4, k4, k, window=window, query_mask=torch.from_numpy(mask))
    nv = (d2 < 0.25e8) & torch.from_numpy(mask)[..., None]
    idx = torch.where(nv, idx, 0)
    enc_a = rng.normal(0, 0.3, (c_in, 10)).astype(np.float32)
    enc_c = rng.normal(0, 0.3, c_in).astype(np.float32)
    att_w = rng.normal(0, 0.3, (2 * c_in, 2 * c_in)).astype(np.float32)
    got = lfa_attention(torch.from_numpy(x), torch.from_numpy(pos), idx, nv,
                        *map(torch.from_numpy, (enc_a, enc_c, att_w))).numpy()
    want = np.asarray(lfa_attention_pallas(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(idx.numpy()),
        jnp.asarray(nv.numpy()), jnp.asarray(enc_a), jnp.asarray(enc_c),
        jnp.asarray(att_w.T), window=window, interpret=True))
    a, b = want[mask], got[mask]
    rel_err = np.abs(a - b) / (np.abs(a) + 1e-2)
    assert np.median(rel_err) < 0.02, np.median(rel_err)
    assert (rel_err < 0.2).mean() > 0.99


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    x, pos, mask = _sorted_batch(rng, 1, 64, 4, [64])
    idx, _, nv = knn_graph(torch.from_numpy(pos), torch.from_numpy(mask), 8)
    args = (torch.from_numpy(x), torch.from_numpy(pos), idx, nv, torch.ones(4, 10),
            torch.zeros(4), torch.eye(8))
    before = lfa_attention.launches
    torch.testing.assert_close(lfa_attention(*args), lfa_attention_plain(*args))
    assert lfa_attention.launches == before
