"""``remat: true`` (RandLA-Net): each residual block recomputed in the
backward (``torch.utils.checkpoint``), as the JAX package wraps it in
``nn.remat`` (``myria3d_tpu/models/modules/randla_net.py:422-429,490-494``;
``tests/myria3d_tpu/models/test_randla_net.py:156``).

- On both train routes (unfused and fused, N=512, K=8), the step with
  ``remat`` gives the gradients, the loss and the BN running stats of the
  step without it, bit for bit: the recompute repeats deterministic work
  (the searches, K4's inverse map, K5's statistics) and skips the
  running-stat updates, which happen once a step, as flax discards the
  recompute's state. Each block's forward runs twice a training step, once
  at eval.
- Against the JAX package's ``remat=True`` step (the unfused f32 program,
  deterministic decimation, no dropout) at the train slice's tolerances
  (``test_torch_train_slice.py``): loss 1e-5 relative, every gradient
  within 1e-3 of its tensor's largest entry plus 1e-5 of the net's
  largest, BN running stats rtol 1e-4 / atol 1e-5.
- Under sync-BN DDP on two gloo ranks (one cloud each, both routes) the
  recomputed forward issues its collectives again in the backward, in the
  same order on every rank: the step with ``remat`` equals the step
  without, on both ranks. Every rank is joined with a timeout.
"""

import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myria3d_tpu_torch.models.modules.randla_net as port_rl
from myria3d_tpu.models.criterion import CrossEntropyLoss as JaxCrossEntropy
from myria3d_tpu.models.modules.randla_net import RandLANet as JaxRandLANet
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch.models.model import Model, build_net
from myria3d_tpu_torch.parallel import ParallelSteps, ddp, spawn
from myria3d_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.myria3d_tpu_torch.test_torch_mixed_precision import _batch, _torch
from tests.myria3d_tpu_torch.test_torch_slice import (
    _jax_det_decimation,
    _port_det_decimation,
    _random_jax_variables,
)
from tests.myria3d_tpu_torch.test_torch_train_slice import _NoDropout

torch.set_num_threads(1)

N = 512
HP = {"num_features": 9, "num_classes": 7, "num_neighbors": 8, "bn_momentum": 0.2}
RANKS_TIMEOUT = 240


@pytest.fixture(scope="module")
def jax_remat_step():
    """Loss, gradients and updated BN stats of the JAX ``remat=True`` train
    step, with the variables it started from."""
    x, pos, mask, y = _batch(6)
    jnet = JaxRandLANet(**HP, remat=True, fused_train_lfa=False)
    with pytest.MonkeyPatch.context() as mp:
        import myria3d_tpu.models.modules.randla_net as jax_rl

        mp.setattr(jax_rl, "random_decimation", _jax_det_decimation)
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        params, stats = _random_jax_variables(JaxRandLANet(**HP), N)

        def loss_fn(p):
            logits, upd = jnet.apply(
                {"params": p, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(pos),
                jnp.asarray(mask), train=True, mutable=["batch_stats"],
                rngs={"decimation": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)})
            return JaxCrossEntropy()(logits, jnp.asarray(y)), upd["batch_stats"]

        (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        jax.clear_caches()
    return dict(batch=(x, pos, mask, y), state_dict=state_dict_from_jax(params, stats),
                loss=float(loss), grads=flax_to_torch_state_dict(jax.device_get(grads), {}),
                stats=flax_to_torch_state_dict({}, jax.device_get(new_stats)))


def _count_block_forwards(monkeypatch) -> list:
    """A list that grows by one at each residual block's forward (a
    recompute included)."""
    calls, forward = [], port_rl.DilatedResidualBlock.forward

    def counted(self, *args, **kwargs):
        calls.append(1)
        return forward(self, *args, **kwargs)

    monkeypatch.setattr(port_rl.DilatedResidualBlock, "forward", counted)
    return calls


def _step(state_dict, batch, remat, fused, par=False):
    """One grad step of the port: loss, gradients, buffers."""
    net = build_net("RandLANet", {**HP, "remat": remat, "fused_train_lfa": fused})
    net.load_state_dict(state_dict, strict=True)
    net.mlp_classif.dropout = [0.0, 0.0]
    model = Model(net)
    model.init_train_state()
    x, pos, mask, y = _torch(*batch)
    step = ParallelSteps(model, sync_bn=True) if par else model
    loss, _ = step.grad_step(x, pos, y, mask)
    return (float(loss), {k: p.grad.clone() for k, p in net.named_parameters()},
            {k: b.clone() for k, b in net.named_buffers()})


@pytest.mark.parametrize("fused", [False, True])
def test_remat_step_equals_the_plain_step(jax_remat_step, monkeypatch, fused):
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    sd, batch = jax_remat_step["state_dict"], jax_remat_step["batch"]
    calls = _count_block_forwards(monkeypatch)
    plain = _step(sd, batch, False, fused)
    assert len(calls) == 4
    remat = _step(sd, batch, True, fused)
    assert len(calls) == 4 + 8   # the blocks recomputed in the backward
    assert remat[0] == plain[0]
    for got, want in ((remat[1], plain[1]), (remat[2], plain[2])):
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    # one running-stat update a step: the stats moved from the start
    moved = [k for k in plain[2] if k.endswith("running_mean")
             and not torch.equal(plain[2][k], sd[k])]
    assert len(moved) == sum(k.endswith("running_mean") for k in sd)


def test_remat_leaves_eval_untouched(jax_remat_step, monkeypatch):
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    x, pos, mask, _ = _torch(*jax_remat_step["batch"])
    out = {}
    calls = _count_block_forwards(monkeypatch)
    for remat in (False, True):
        net = build_net("RandLANet", {**HP, "remat": remat})
        net.load_state_dict(jax_remat_step["state_dict"], strict=True)
        with torch.no_grad():
            out[remat] = net.eval()(x, pos, mask)
    assert len(calls) == 8
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=0)


def test_remat_step_matches_the_jax_remat_step(jax_remat_step, monkeypatch):
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    loss, grads, stats = _step(jax_remat_step["state_dict"], jax_remat_step["batch"], True, False)
    assert loss == pytest.approx(jax_remat_step["loss"], rel=1e-5)
    want_grads = jax_remat_step["grads"]
    assert grads.keys() == want_grads.keys()
    top = max(float(np.abs(g).max()) for g in want_grads.values())
    for k, g in grads.items():
        tol = 1e-3 * float(np.abs(want_grads[k]).max()) + 1e-5 * top
        assert float((g - torch.from_numpy(np.array(want_grads[k]))).abs().max()) <= tol, k
    for k, want in jax_remat_step["stats"].items():
        np.testing.assert_allclose(stats[k].numpy(), want, rtol=1e-4, atol=1e-5, err_msg=k)


def _rank_remat(out_dir, state_dict, batch, fused):
    """One rank's sync-BN DDP grad steps on its cloud, without and with
    ``remat``: writes both to ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    port_rl.random_decimation = _port_det_decimation
    r = ddp.rank()
    rows = tuple(np.ascontiguousarray(a[r:r + 1]) for a in batch)
    steps = {remat: _step(state_dict, rows, remat, fused, par=True) for remat in (False, True)}
    torch.save(steps, os.path.join(out_dir, f"rank{r}.pt"))


@pytest.mark.parametrize("fused", [False, True])
def test_remat_under_sync_bn_ddp(jax_remat_step, tmp_path, monkeypatch, fused):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # one core a rank
    spawn(_rank_remat, ["cpu", "cpu"],
          args=(str(tmp_path), jax_remat_step["state_dict"], jax_remat_step["batch"], fused),
          timeout=RANKS_TIMEOUT)
    for r in range(2):
        steps = torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
        plain, remat = steps[False], steps[True]
        assert remat[0] == plain[0]
        for i in (1, 2):
            for k in plain[i]:
                torch.testing.assert_close(remat[i][k], plain[i][k], rtol=0, atol=0, msg=k)
