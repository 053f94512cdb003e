"""``model.grad_microbatch`` in the port: the microbatched grad step held
against JAX ``build_grad_step`` with ``grad_microbatch=2`` at B=4 on both
train routes, against a manual accumulation of the same chunks on the same
generators, the monolithic step for a batch it does not divide, and with
``accumulate_grad_batches``.

Against JAX: the full-width net from the same random JAX variables,
deterministic decimation and no dropout, as in
``test_torch_train_slice.py``, on two chunks of different clouds with
different valid counts (the port's monolithic step misses there, so the
comparison sees the chunking); loss within 1e-5 (relative), every gradient
within 1e-3 of its tensor's largest entry plus 1e-5 of the net's largest
gradient (the train slice's tolerance), BN running stats within 1e-4
relative (1e-5 absolute), logits within 1e-4 relative (1e-5 absolute).
Against the manual accumulation (random decimation and dropout drawn from
``chunk_generator``): within 1e-6 of scale; a non-dividing batch is
bit-equal to ``grad_microbatch=0``.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myria3d_tpu.models.modules.randla_net as jax_rl
import myria3d_tpu_torch.models.modules.randla_net as port_rl
from myria3d_tpu.models.model import Model as JaxModel
from myria3d_tpu.models.model import TrainState
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch.models.model import Model, build_model, build_net, chunk_generator
from myria3d_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.myria3d_tpu_torch.test_torch_slice import (
    _jax_det_decimation,
    _port_det_decimation,
    _random_jax_variables,
)
from tests.myria3d_tpu_torch.test_torch_train_slice import HPARAMS, LR, N, _NoDropout
from tests.myria3d_tpu_torch.test_torch_train_slice import _batch as _slice_batch

torch.set_num_threads(1)
B, MB = 4, 2


def _batch():
    """Two chunks of four different clouds, in the order of the steps'
    arguments (x, pos, y, mask): the train slice's batch, then a second
    draw of its generator with other valid counts. The chunks' masked BN
    moments differ from each other and from the whole batch's, so the
    monolithic step misses the microbatched one
    (``test_jax_comparison_detects_chunking``)."""
    x, pos, mask, y = _slice_batch()
    rng = np.random.default_rng(22)
    pos2 = rng.uniform(-10.0, 10.0, (2, N, 3)).astype(np.float32)
    x2 = rng.uniform(0.0, 1.0, (2, N, 9)).astype(np.float32)
    mask2 = np.arange(N)[None] < np.array([[1216], [960]])
    y2 = np.where(mask2, rng.integers(0, 7, (2, N)), 65)
    return (np.concatenate([x, x2]), np.concatenate([pos, pos2]),
            np.concatenate([y, y2]), np.concatenate([mask, mask2]))


@pytest.fixture(scope="module")
def jax_grad_step():
    """Loss, gradients, BN stats and logits of JAX ``build_grad_step`` at
    ``grad_microbatch=2`` (a ``lax.scan`` over two chunks; unfused f32)."""
    model = JaxModel("RandLANet", {**HPARAMS, "fused_train_lfa": False}, lr=LR,
                     grad_microbatch=MB)
    params, stats = _random_jax_variables(model.net, N)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=model.tx.init(params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rl, "random_decimation", _jax_det_decimation)
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        loss, grads, new_stats, logits = jax.jit(model.build_grad_step())(
            state, *(jnp.asarray(a) for a in _batch()), jax.random.PRNGKey(0))
        jax.clear_caches()
    return dict(params=params, stats=stats, loss=float(loss), logits=np.asarray(logits),
                grads=flax_to_torch_state_dict(jax.device_get(grads), {}),
                new_stats=flax_to_torch_state_dict({}, jax.device_get(new_stats)))


def _port_step(want, fused, grad_microbatch):
    """The port's grad step on ``_batch()`` from the JAX variables:
    (loss, logits, net)."""
    net = build_net("RandLANet", {**HPARAMS, "fused_train_lfa": fused})
    net.load_state_dict(state_dict_from_jax(want["params"], want["stats"]), strict=True)
    net.mlp_classif.dropout = [0.0, 0.0]
    model = Model(net, lr=LR, grad_microbatch=grad_microbatch)
    model.init_train_state()
    loss, logits = model.grad_step(*(torch.from_numpy(np.asarray(a)) for a in _batch()))
    return loss, logits, net


def _misses(want, loss, logits, net):
    """The names of what lies outside this file's tolerances against
    ``want``: "loss", "logits", parameters (their gradients) and BN
    buffers."""
    misses = []
    if abs(float(loss) - want["loss"]) > 1e-5 * abs(want["loss"]):
        misses.append("loss")
    if not np.allclose(logits.numpy(), want["logits"], rtol=1e-4, atol=1e-5):
        misses.append("logits")
    grads = want["grads"]
    top = max(float(np.abs(g).max()) for g in grads.values())
    named = dict(net.named_parameters())
    assert named.keys() == grads.keys()
    for k, p in named.items():
        tol = 1e-3 * float(np.abs(grads[k]).max()) + 1e-5 * top
        if float((p.grad - torch.from_numpy(np.array(grads[k]))).abs().max()) > tol:
            misses.append(k)
    state = net.state_dict()
    assert want["new_stats"].keys() == {k for k in state if k not in named}
    for k, v in want["new_stats"].items():
        if not np.allclose(state[k].numpy(), v, rtol=1e-4, atol=1e-5):
            misses.append(k)
    return misses


@pytest.mark.parametrize("fused", [False, True])
def test_microbatched_grad_step_matches_jax(jax_grad_step, monkeypatch, fused):
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    assert _misses(jax_grad_step, *_port_step(jax_grad_step, fused, MB)) == []


@pytest.mark.parametrize("fused", [False, True])
def test_jax_comparison_detects_chunking(jax_grad_step, monkeypatch, fused):
    """The port's monolithic step (``grad_microbatch=0``) on the same batch
    misses the JAX microbatched step's loss, gradients and BN stats."""
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    misses = set(_misses(jax_grad_step, *_port_step(jax_grad_step, fused, 0)))
    assert "loss" in misses
    assert {"fc0.weight", "fc_classif.weight"} <= misses
    assert {"fp1.nn.norms.0.running_mean", "fp1.nn.norms.0.running_var"} <= misses


def _small(grad_microbatch=0, accumulate=1, fused="auto"):
    torch.manual_seed(0)
    model = build_model("RandLANet", {"num_features": 9, "num_classes": 7, "num_neighbors": 8,
                                      "fused_train_lfa": fused},
                        lr=0.01, grad_microbatch=grad_microbatch,
                        accumulate_grad_batches=accumulate)
    model.init_train_state()
    return model


def _small_batch(b, seed=0, n=256):
    """(x, pos, y, mask), the order of ``train_step``'s arguments."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(0, 1, (b, n, 9)).astype(np.float32)),
            torch.from_numpy(rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 7, (b, n))),
            torch.from_numpy(np.arange(n)[None] < rng.integers(n // 2, n + 1, (b, 1))))


def _stats(model):
    return [t.clone() for t in model.net.buffers()]


@pytest.mark.parametrize("fused", [False, True])
def test_microbatched_step_equals_manual_accumulation(fused):
    """The step over 2 chunks equals running each chunk from the same BN
    stats on ``chunk_generator(gen, i)`` (random decimation and dropout),
    averaging the losses, gradients and stats and concatenating logits."""
    x, pos, y, mask = _small_batch(B)
    micro, ref = _small(MB, fused=fused), _small(fused=fused)
    gen = torch.Generator().manual_seed(7)
    loss, logits = micro.grad_step(x, pos, y, mask, gen)

    start = _stats(ref)
    ref.net.train()
    losses, outs, grads, stats = [], [], [], []
    for i in range(B // MB):
        for t, s in zip(ref.net.buffers(), start):
            t.copy_(s)
        ref.optimizer.zero_grad(set_to_none=True)
        rows = slice(i * MB, (i + 1) * MB)
        out = ref.net(x[rows], pos[rows], mask[rows], chunk_generator(gen, i))
        chunk_loss = ref.criterion(out, y[rows])
        chunk_loss.backward()
        losses.append(chunk_loss.detach())
        outs.append(out.detach())
        grads.append([p.grad.clone() for p in ref.net.parameters()])
        stats.append(_stats(ref))

    assert float(loss) == pytest.approx(float(sum(losses) / 2), rel=1e-6)
    torch.testing.assert_close(logits, torch.cat(outs), rtol=0, atol=0)
    mean_grads = [(a + b) / 2 for a, b in zip(*grads)]
    top = max(float(g.abs().max()) for g in mean_grads)
    for p, g in zip(micro.net.parameters(), mean_grads):
        assert float((p.grad - g).abs().max()) <= 1e-6 * top
    for t, a, b in zip(micro.net.buffers(), *stats):
        want = (a + b) / 2
        assert float((t - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_non_dividing_batch_is_the_monolithic_step():
    """B=3 at ``grad_microbatch=2``: bit-equal to ``grad_microbatch=0``."""
    x, pos, y, mask = _small_batch(3)
    got, want = _small(2), _small(0)
    outs = [m.grad_step(x, pos, y, mask, torch.Generator().manual_seed(3)) for m in (got, want)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    for p, q in zip(got.net.parameters(), want.net.parameters()):
        assert torch.equal(p.grad, q.grad)
    for s, t in zip(got.net.buffers(), want.net.buffers()):
        assert torch.equal(s, t)


def test_microbatch_with_accumulation_updates_every_second_batch():
    model = _small(MB, accumulate=2)
    params = list(model.net.parameters())
    before = [p.detach().clone() for p in params]
    model.train_step(*_small_batch(B, 1), torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(before, params))
    assert model.accum == 1 and model.step == 1
    x, pos, y, mask = _small_batch(B, 2)
    loss, logits = model.train_step(x, pos, y, mask, torch.Generator().manual_seed(2))
    assert not all(torch.equal(a, b) for a, b in zip(before, params))
    assert model.accum == 0 and model.step == 2
    assert torch.isfinite(loss) and logits.shape == (B, 256, 7)
