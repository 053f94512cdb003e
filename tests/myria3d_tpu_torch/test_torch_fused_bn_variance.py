"""The port's fused train LFA held against the JAX package's fused route
(``myria3d_tpu/ops/pallas_lfa_train.py``, its Pallas kernels in interpret
mode), where the port's fused train step misses the train slice's bar
against the JAX unfused step: the train slice's second cloud alone, block
4's lfa2 (~20 points a cloud), whose d(W_e) misses by ~9x.

Both fused routes take the encoder BN's variance from raw second moments
(``Cov = Srr / n - r_bar r_bar^T``, ``pallas_lfa_train.py:416-428`` and
``ops/cuda_lfa_train.py`` ``moments``); the unfused routes take the
two-pass variance of the encoder's outputs. The test runs the port's
train-slice step on the fused route and takes block 4's lfa2 as it runs
there: its inputs and the cotangent that reaches its output. It then runs
that LFA alone, from the same parameters, on the port's fused route, the
JAX fused route (``LocalFeatureAggregation`` with ``fused_train_window``)
and the JAX standard route, twice:

- on inputs rounded to what the JAX fused kernels' payload carries exactly
  (features to bf16, positions to a bf16 hi/lo pair), where the two fused
  routes compute the same function: they agree at the train slice's
  tolerance (every gradient within 1e-3 of its tensor's largest entry plus
  1e-5 of the LFA's largest gradient; the output within 1e-5 of its scale;
  the BN running stats rtol 1e-4 / atol 1e-5). There the raw moments are
  near exact, and no route misses another;
- on the inputs as the step has them, where the JAX fused route's d(W_e)
  misses the JAX standard route's as the port's fused route does (each by
  more than five times the bar; the two misses within a factor of two):
  the miss is the raw-moment variance, which the JAX package's fused
  route shares, and no fault of the port.
"""

import copy

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myria3d_tpu.models.modules.randla_net as jax_rl
import myria3d_tpu.ops.pallas_lfa_train as plt_mod
import myria3d_tpu_torch.models.modules.randla_net as port_rl
from myria3d_tpu.models.modules.randla_net import LocalFeatureAggregation as JaxLFA
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch.models.model import build_net
from myria3d_tpu_torch.ops.cuda_lfa_train import rel_stats
from myria3d_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.myria3d_tpu_torch.test_torch_slice import (
    _jax_det_decimation,
    _port_det_decimation,
    _random_jax_variables,
)
from tests.myria3d_tpu_torch.test_torch_train_slice import HPARAMS, N, _batch, _NoDropout

torch.set_num_threads(1)
CLOUD = 1          # the train slice's cloud whose fused step misses (1088 valid points)
WINDOW = 1024      # covers every key of block 4's ~20-point clouds (one 512-key chunk)
W_E = "mlp_encoder.lins.0.weight"


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _hi_lo_exact(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to a bf16 hi part plus a bf16 lo part, which the JAX
    fused kernels' payload carries exactly."""
    hi = _bf16(a)
    return (hi + _bf16(a - hi)).astype(np.float32)


@pytest.fixture(scope="module")
def block4_lfa2():
    """The port's fused train-slice step on the missing cloud: block 4's
    lfa2 inputs (as the step has them, and rounded to what the JAX fused
    payload carries), its output's cotangent, and the JAX variables."""
    x, pos, mask, y = (a[CLOUD:CLOUD + 1] for a in _batch())
    jnet = jax_rl.RandLANet(**HPARAMS, fused_train_lfa=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rl, "random_decimation", _jax_det_decimation)
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        params, stats = _random_jax_variables(jnet, N)
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_rl, "random_decimation", _port_det_decimation)
        net = build_net("RandLANet", {**HPARAMS, "fused_train_lfa": True})
        net.load_state_dict(state_dict_from_jax(params, stats), strict=True)
        net.mlp_classif.dropout = [0.0, 0.0]
        net.train()
        seen = {}

        def pre(module, args, kwargs):
            seen["args"] = [a.detach().clone() for a in args]

        def post(module, args, kwargs, out):
            out.register_hook(lambda g: seen.__setitem__("cotangent", g.detach().clone()))

        lfa = net.block4.lfa2
        fresh = copy.deepcopy(lfa)     # the running stats before the step moves them
        hooks = [lfa.register_forward_pre_hook(pre, with_kwargs=True),
                 lfa.register_forward_hook(post, with_kwargs=True)]
        from myria3d_tpu_torch.models.criterion import CrossEntropyLoss

        loss = CrossEntropyLoss()(net(*(torch.from_numpy(np.asarray(a)) for a in (x, pos, mask))),
                                  torch.from_numpy(y))
        loss.backward()
        for h in hooks:
            h.remove()
    x4, pos4, idx4, nv4, mask4 = seen["args"]
    return dict(x=_bf16(x4.numpy()), pos=_hi_lo_exact(pos4.numpy()), raw_x=x4.numpy(),
                raw_pos=pos4.numpy(), idx=idx4.numpy(),
                nv=nv4.numpy(), mask=mask4.numpy(), g=seen["cotangent"].numpy(),
                lfa=fresh, params=params["block4"]["lfa2"],
                stats=stats["block4"]["lfa2"])


def _port_fused(case):
    """The port's fused route (the kernels' plain versions on the CPU):
    output, gradients by parameter name and the encoder BN's running stats."""
    lfa = copy.deepcopy(case["lfa"]).train()
    for p in lfa.parameters():
        p.grad = None
    x, pos, nv, mask = (torch.from_numpy(case[k].copy()) for k in ("x", "pos", "nv", "mask"))
    idx = torch.from_numpy(np.where(case["nv"], case["idx"], 0))
    stats = rel_stats(pos, idx, nv, None)
    out = lfa(x, pos, idx, nv, mask, fused=True, stats=stats)
    (out * torch.from_numpy(case["g"])).sum().backward()
    return (out.detach().numpy(), {k: p.grad.numpy() for k, p in lfa.named_parameters()},
            {k: b.numpy() for k, b in lfa.named_buffers()})


def _jax_lfa(case, fused: bool):
    """The JAX package's LFA (256 channels, BN momentum 0.2) on the same
    inputs, fused (Pallas in interpret mode) or standard: output, gradients
    and BN running stats keyed as the port's."""
    x, pos, mask, g = (jnp.asarray(case[k]) for k in ("x", "pos", "mask", "g"))
    idx = jnp.asarray(np.where(case["nv"], case["idx"], 0).astype(np.int32))
    nv = jnp.asarray(case["nv"])
    lfa = JaxLFA(256, bn_momentum=HPARAMS["bn_momentum"])
    idx_t, nv_t = jnp.swapaxes(idx, 1, 2), jnp.swapaxes(nv, 1, 2)
    pos_cf = jnp.swapaxes(pos, 1, 2)
    pos_j = jax.vmap(lambda t, i: t[:, i])(pos_cf, idx_t)
    pos_i = pos_cf[:, :, None, :]
    diff = pos_j - pos_i
    dist = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=1, keepdims=True), 0.0))
    rel = jnp.concatenate([jnp.broadcast_to(pos_i, pos_j.shape), pos_j, diff, dist], axis=1)

    def run(params):
        vs = {"params": params, "batch_stats": case["stats"]}
        if fused:
            return lfa.apply(vs, x, None, None, None, mask, True, mutable=["batch_stats"],
                             pos=pos, idx=idx, neigh_valid=nv, fused_train_window=WINDOW)
        return lfa.apply(vs, x, rel, idx_t, nv_t, mask, True, mutable=["batch_stats"])

    def loss(params):
        out, upd = run(params)
        return jnp.sum(out * g), (out, upd["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(plt_mod, "FORCE_INTERPRET", True)
        (_, (out, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            case["params"])
    jax.clear_caches()
    strip = lambda d: {k.split(".", 2)[2]: v for k, v in d.items()}  # noqa: E731
    return (np.asarray(out),
            strip(flax_to_torch_state_dict({"block4": {"lfa2": jax.device_get(grads)}}, {})),
            strip(flax_to_torch_state_dict({}, {"block4": {"lfa2": jax.device_get(new_stats)}})))


def _gap(a: dict, b: dict, key: str) -> float:
    return float(np.abs(np.asarray(a[key]) - np.asarray(b[key])).max())


def _miss_bar(grads: dict) -> float:
    top = max(float(np.abs(g).max()) for g in grads.values())
    return 1e-3 * float(np.abs(grads[W_E]).max()) + 1e-5 * top


def test_fused_route_matches_the_jax_fused_route(block4_lfa2):
    """Inputs the JAX payload carries exactly: the two fused routes agree."""
    out_p, grads_p, stats_p = _port_fused(block4_lfa2)
    out_f, grads_f, stats_f = _jax_lfa(block4_lfa2, fused=True)
    m = block4_lfa2["mask"]
    scale = float(np.abs(out_f[m]).max())
    assert float(np.abs(out_p[m] - out_f[m]).max()) <= 1e-5 * scale
    assert grads_p.keys() == grads_f.keys()
    top = max(float(np.abs(g).max()) for g in grads_f.values())
    for k, g in grads_p.items():
        tol = 1e-3 * float(np.abs(grads_f[k]).max()) + 1e-5 * top
        assert _gap(grads_p, grads_f, k) <= tol, k
    for k, s in stats_f.items():
        np.testing.assert_allclose(stats_p[k], s, rtol=1e-4, atol=1e-5, err_msg=k)
    # there the raw moments are near exact: the unfused route agrees too
    _, grads_s, _ = _jax_lfa(block4_lfa2, fused=False)
    assert _gap(grads_f, grads_s, W_E) <= _miss_bar(grads_s)


def test_the_jax_fused_route_misses_the_unfused_route_as_the_port_does(block4_lfa2):
    """The step's own inputs: both fused routes miss the JAX standard route's
    d(W_e) by the same amount."""
    case = dict(block4_lfa2, x=block4_lfa2["raw_x"], pos=block4_lfa2["raw_pos"])
    _, grads_p, _ = _port_fused(case)
    _, grads_f, _ = _jax_lfa(case, fused=True)
    _, grads_s, _ = _jax_lfa(case, fused=False)
    bar = _miss_bar(grads_s)
    port_miss, jax_miss = _gap(grads_p, grads_s, W_E), _gap(grads_f, grads_s, W_E)
    assert port_miss > 5 * bar and jax_miss > 5 * bar, (port_miss, jax_miss, bar)
    assert 0.5 <= jax_miss / port_miss <= 2.0, (port_miss, jax_miss)
