"""The train path's building blocks in the PyTorch port held against the JAX
package on the CPU: masked moments, train-mode BatchNorm and its running
statistics, K4's gather and scatter VJP, K5's rel statistics, the fused
train LFA (K5/K6 plain versions, K2 plain forward), the criterion, one
optimizer step and the LR schedulers.

Inputs come from numpy seeds. The JAX Pallas kernels run in interpret mode
as their own tests run them; their LFA test helpers (bf16-exact inputs) are
reused. Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import myria3d_tpu.ops.pallas_gather as pallas_gather
import myria3d_tpu.ops.pallas_lfa_train as plt_mod
from myria3d_tpu.models import optimizers as jax_opt
from myria3d_tpu.models.criterion import CrossEntropyLoss as JaxCrossEntropy
from myria3d_tpu.models.modules.nn import MaskedBatchNorm as JaxMaskedBatchNorm
from myria3d_tpu.ops.masked import masked_mean as jax_masked_mean
from myria3d_tpu.ops.masked import masked_var as jax_masked_var
from myria3d_tpu_torch.models import optimizers as port_opt
from myria3d_tpu_torch.models.criterion import CrossEntropyLoss
from myria3d_tpu_torch.models.model import build_net
from myria3d_tpu_torch.models.modules.nn import MaskedBatchNorm
from myria3d_tpu_torch.models.modules import randla_net
from myria3d_tpu_torch.models.modules.randla_net import (
    FUSED_TRAIN_MIN_BATCH,
    DilatedResidualBlock,
    use_fused_train_lfa,
)
from myria3d_tpu_torch.ops import cuda_lfa_train
from myria3d_tpu_torch.ops.cuda_gather import gather_bwd_plain, gather_neighbors, inverse_map
from myria3d_tpu_torch.ops.cuda_lfa_train import lfa_train, rel_stats_plain
from myria3d_tpu_torch.ops.knn import knn_graph
from myria3d_tpu_torch.ops.masked import masked_mean, masked_var
from tests.myria3d_tpu.ops import test_pallas_lfa_train as jax_lfa_case

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# masked moments and train-mode BatchNorm


def test_masked_moments_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (2, 50, 8)).astype(np.float32)
    mask = np.arange(50)[None, :, None] < np.array([50, 31])[:, None, None]
    want_mean = jax_masked_mean(jnp.asarray(x), jnp.asarray(mask), axis=(0, 1))
    want_var = jax_masked_var(jnp.asarray(x), jnp.asarray(mask), axis=(0, 1))
    np.testing.assert_allclose(masked_mean(_t(x), _t(mask), dim=(0, 1)).numpy(),
                               want_mean, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(masked_var(_t(x), _t(mask), dim=(0, 1)).numpy(),
                               want_var, rtol=1e-5, atol=1e-6)


def _bn_case(shape, padded, momentum, seed=1):
    """One train-mode BN call on both sides from the same affine and
    running stats: (x, valid, port output, port module, JAX output, JAX
    stats, the initial running var)."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(1.5, 2.0, shape).astype(np.float32)
    valid = None
    if padded:   # pad rows (and, for 3-d inputs, invalid neighbour slots)
        valid = rng.uniform(size=shape[:-1]) < 0.7
        valid[0, 0] = True
    scale, bias = rng.uniform(0.5, 1.5, c), rng.normal(0, 0.3, c)
    r_mean, r_var = rng.normal(0, 0.3, c), rng.uniform(0.5, 1.5, c)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": r_mean, "var": r_var}}
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), variables)
    want, upd = JaxMaskedBatchNorm(c, momentum=momentum).apply(
        variables, jnp.asarray(x), None if valid is None else jnp.asarray(valid), True,
        mutable=["batch_stats"])
    bn = MaskedBatchNorm(c, momentum=momentum).train()
    with torch.no_grad():
        for p, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, r_mean),
                     (bn.running_var, r_var)):
            p.copy_(_t(v.astype(np.float32)))
    got = bn(_t(x), None if valid is None else _t(valid))
    return x, valid, got, bn, np.asarray(want), upd["batch_stats"], r_var


@pytest.mark.parametrize("shape,padded", [((2, 64, 6), False), ((2, 64, 6), True),
                                          ((2, 32, 8, 5), True)])
def test_train_batchnorm_matches_jax(shape, padded):
    """Masked moments over valid rows (or valid neighbour slots for a
    (B, N, K, C) input), biased-variance normalization and the running
    update: 1e-5."""
    _, valid, got, bn, want, stats, _ = _bn_case(shape, padded, momentum=0.01)
    keep = np.ones(shape[:-1], bool) if valid is None else valid
    np.testing.assert_allclose(got.detach().numpy()[keep], want[keep], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], rtol=1e-5, atol=1e-6)


def test_bn_momentum_comes_from_hparams():
    """Every BatchNorm of the net takes ``bn_momentum`` from the hparams (the
    toy checkpoint carries 0.2), and a running update at 0.2 equals the JAX
    module's."""
    net = build_net("RandLANet", {"num_features": 9, "num_classes": 7, "bn_momentum": 0.2})
    norms = [m for m in net.modules() if isinstance(m, MaskedBatchNorm)]
    assert len(norms) == 35 and all(m.momentum == 0.2 for m in norms)
    _, _, _, bn, _, stats, _ = _bn_case((2, 40, 4), True, momentum=0.2, seed=3)
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], rtol=1e-5, atol=1e-6)


def test_bn_running_var_is_unbiased():
    """The running variance moves toward ``var * n / (n - 1)`` of the valid
    rows (torch semantics), as the JAX module does."""
    x, valid, _, bn, _, stats, r_var = _bn_case((2, 40, 4), True, momentum=0.2, seed=4)
    rows = x[valid].astype(np.float64)
    want = 0.8 * r_var + 0.2 * rows.var(axis=0, ddof=1)
    np.testing.assert_allclose(bn.running_var.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# K4: the neighbour gather and its scatter VJP


def _sorted_graph(b, n, k, c, seed):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, 50, (b, n)), rng.uniform(0, 50, (b, n)),
                    rng.uniform(0, 3, (b, n))], axis=-1).astype(np.float32)
    pos = np.take_along_axis(pos, np.argsort(pos[..., :1], axis=1), axis=1)
    mask = np.arange(n)[None] < np.array([n, n - n // 4])[:, None]
    x = rng.uniform(-1, 1, (b, n, c)).astype(np.float32)
    idx, _, nv = knn_graph(_t(pos), _t(mask), k, window=1024)
    return x, pos, mask, idx, nv


def test_k4_gather_and_vjp_match_jax_kernel():
    """Forward (zeros on invalid slots) and the payload gradient against
    ``gather_neighbors_windowed(interpret=True, grad_precision="exact")``:
    the same f32 sums in another order, 1e-5."""
    b, n, k, p = 2, 2048, 8, 11
    x, pos, mask, idx, nv = _sorted_graph(b, n, k, p, seed=5)
    ct = np.random.default_rng(6).normal(size=(b, n, k, p)).astype(np.float32)

    def jax_gather(payload_cf):
        return pallas_gather.gather_neighbors_windowed(
            payload_cf, jnp.asarray(idx.numpy()), jnp.asarray(nv.numpy()), 1024,
            interpret=True, grad_precision="exact")

    want, vjp = jax.vjp(jax_gather, jnp.asarray(np.swapaxes(x, 1, 2)))
    (want_grad,) = vjp(jnp.asarray(ct.transpose(0, 3, 2, 1)))        # (B, P, K, N)

    payload = _t(x).requires_grad_(True)
    got = gather_neighbors(payload, idx, nv)
    got.backward(_t(ct))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want).transpose(0, 3, 2, 1))
    np.testing.assert_allclose(payload.grad.numpy(), np.swapaxes(np.asarray(want_grad), 1, 2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gather_bwd_plain(_t(ct), idx, nv, n).numpy(),
                               payload.grad.numpy(), rtol=1e-6, atol=1e-6)


def _inverse_map_case(case):
    """(idx, nv, n_keys): a kNN graph with pads; every query of a cloud
    choosing key 3 in every slot; a cloud with no valid slot; random keys
    with random validity."""
    if case == "knn":
        _, _, _, idx, nv = _sorted_graph(2, 256, 8, 1, seed=11)
        return idx, nv, 256
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 40, (3, 90, 4)).astype(np.int32)
    nv = rng.uniform(size=(3, 90, 4)) < 0.8
    if case == "hub":
        idx[1], nv[1] = 3, True
    elif case == "all_invalid_cloud":
        nv[0] = False
    return _t(idx), _t(nv), 40


@pytest.mark.parametrize("case", ["knn", "hub", "all_invalid_cloud", "random"])
def test_inverse_map_properties(case):
    """What K4 needs of its map, and what the card's hand-built map is held
    to: ``offsets`` ascending from 0 to the count of valid slots; key q's
    range lists exactly the valid slots that chose q, in ascending order;
    invalid slots are in no range."""
    idx, nv, n_keys = _inverse_map_case(case)
    inv = inverse_map(idx, nv, n_keys)
    b = idx.shape[0]
    perm, offsets = inv.perm.numpy(), inv.offsets.numpy()
    assert offsets.shape == (b * n_keys + 1,) and offsets[0] == 0
    assert (np.diff(offsets) >= 0).all() and offsets[-1] == int(nv.sum())
    key = (idx.numpy().astype(np.int64) + np.arange(b)[:, None, None] * n_keys).reshape(-1)
    valid = nv.numpy().reshape(-1)
    for q in range(b * n_keys):
        want = np.flatnonzero(valid & (key == q))
        np.testing.assert_array_equal(perm[offsets[q]:offsets[q + 1]], want)
    if case == "hub":
        assert offsets[n_keys + 4] - offsets[n_keys + 3] == idx[1].numel()
    if case == "all_invalid_cloud":
        assert offsets[n_keys] == 0


# ---------------------------------------------------------------------------
# K5 and the fused train LFA (the JAX kernel test's bf16-exact case)


@pytest.fixture(scope="module")
def lfa_case():
    """The JAX fused-LFA test's inputs (positions on a 1/256 grid, features
    bf16-exact, pads on both clouds), its windowed graph, parameters and a
    loss weight; plus the JAX unfused reference and kernel results."""
    x, pos, mask = jax_lfa_case._batch(n_valid=[900, 500])
    idx, nv = jax_lfa_case._graph(pos, mask)
    params = jax_lfa_case._params()
    w = np.random.default_rng(7).normal(
        size=(jax_lfa_case.B, jax_lfa_case.N, jax_lfa_case.C)).astype(np.float32)
    w = jnp.asarray(w) * mask[..., None]

    def loss_of(fn):
        def loss(x, w_e, b_e, gamma, beta, att_t):
            pooled = fn(x, pos, mask, idx, nv, w_e, b_e, gamma, beta, att_t)[0]
            return jnp.sum((pooled * w) ** 2)
        return loss

    def kernel(*a):
        return plt_mod.lfa_train_pallas(*a, window=jax_lfa_case.WINDOW, interpret=True)

    out = {}
    for name, fn in (("ref", jax_lfa_case._reference), ("kernel", kernel)):
        out[name] = (fn(x, pos, mask, idx, nv, *params),
                     jax.grad(loss_of(fn), argnums=tuple(range(6)))(x, *params))
    stats = plt_mod.rel_stats(x, pos, mask, idx, nv, jax_lfa_case.WINDOW, interpret=True)
    return dict(x=x, pos=pos, mask=mask, idx=idx, nv=nv, params=params, w=w,
                stats=np.asarray(stats), **out)


def _port_lfa(case):
    """The port's fused train LFA on the case (CPU: K5, K2, K6 plain
    versions): (pooled, mu, var, n, grads in the JAX argument order)."""
    w_e, b_e, gamma, beta, att_t = (_t(a).requires_grad_(True) for a in case["params"])
    x = _t(case["x"]).requires_grad_(True)
    w_port = w_e.T   # the port's Linear weight (C_in, 10)
    pooled, mu, var, n = lfa_train(x, _t(case["pos"]), _t(case["idx"]), _t(case["nv"]),
                                   w_port, b_e, gamma, beta, att_t)
    ((pooled * _t(case["w"])) ** 2).sum().backward()
    grads = [t.grad.numpy() for t in (x, w_e, b_e, gamma, beta, att_t)]
    return pooled.detach().numpy(), mu.numpy(), var.numpy(), float(n), grads


def test_k5_rel_stats_match_jax_kernel(lfa_case):
    """The (B, 16, 16) masked moments of [rel; 1] against ``rel_stats``
    (interpret mode; bf16-exact positions, f32 HIGHEST dots): 1e-6 of each
    entry's scale."""
    got = rel_stats_plain(_t(lfa_case["pos"]), _t(lfa_case["idx"]), _t(lfa_case["nv"]))
    want = lfa_case["stats"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_fused_lfa_matches_jax_unfused_autograd(lfa_case):
    """Against autograd of the JAX unfused train LFA, all f32: pooled 1e-5,
    the moments 1e-5 (the variance from raw second moments), every
    gradient 1e-4 of the largest gradient (b_e's is 0 on the port's side
    and f32 cancellation noise on the reference's)."""
    pooled, mu, var, n, grads = _port_lfa(lfa_case)
    (want_pooled, want_mu, want_var, want_n), want_grads = lfa_case["ref"]
    m = np.asarray(lfa_case["mask"])
    np.testing.assert_allclose(pooled[m], np.asarray(want_pooled)[m], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mu, want_mu, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var, want_var, rtol=1e-5, atol=1e-5)
    assert n == float(want_n)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want_grads)
    for name, a, b in zip(["x", "w_e", "b_e", "gamma", "beta", "att_t"], grads, want_grads):
        np.testing.assert_allclose(a / scale, np.asarray(b) / scale, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_fused_lfa_matches_jax_kernel(lfa_case):
    """Against ``lfa_train_pallas(interpret=True)`` at that kernel test's own
    tolerances (its forward rides the bf16 payload): pooled 2e-3, moments
    1e-4 / 1e-3, gradients 2e-3 of the largest."""
    pooled, mu, var, n, grads = _port_lfa(lfa_case)
    (want_pooled, want_mu, want_var, want_n), want_grads = lfa_case["kernel"]
    m = np.asarray(lfa_case["mask"])
    np.testing.assert_allclose(pooled[m], np.asarray(want_pooled)[m], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(mu, want_mu, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(var, want_var, rtol=1e-3, atol=1e-3)
    assert n == float(want_n)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want_grads)
    for name, a, b in zip(["x", "w_e", "b_e", "gamma", "beta", "att_t"], grads, want_grads):
        np.testing.assert_allclose(a / scale, np.asarray(b) / scale, rtol=0, atol=2e-3,
                                   err_msg=name)


def test_fused_block_shares_one_rel_stats(monkeypatch):
    """The fused train block computes K5's statistics once (they depend on
    the graph alone) and hands them to both LFAs; output, running moments
    and every gradient equal those with per-LFA statistics exactly."""
    rng = np.random.default_rng(13)
    b, n, d_in, d_out = 2, 160, 8, 32
    pos = np.sort(rng.uniform(0, 20, (b, n, 3)).astype(np.float32), axis=1)
    mask = np.arange(n)[None] < np.array([n, n - 37])[:, None]
    x = rng.normal(size=(b, n, d_in)).astype(np.float32)
    calls = {"block": 0, "lfa": 0}

    def counted(where, fn):
        def wrapper(*args, **kwargs):
            calls[where] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(randla_net, "rel_stats", counted("block", randla_net.rel_stats))
    monkeypatch.setattr(cuda_lfa_train, "rel_stats", counted("lfa", cuda_lfa_train.rel_stats))

    def run(shared):
        torch.manual_seed(0)
        block = DilatedResidualBlock(8, d_in, d_out, bn_momentum=0.1).train()
        if not shared:   # each LFA computes its own statistics
            for lfa in (block.lfa1, block.lfa2):
                fwd = lfa.forward
                lfa.forward = lambda *a, _fwd=fwd, **kw: _fwd(*a, **{**kw, "stats": None})
        xt = _t(x).requires_grad_(True)
        out = block(xt, _t(pos), _t(mask), fused_train=True)
        (out * out).sum().backward()
        grads = [xt.grad] + [p.grad for p in block.parameters()]
        return out.detach(), grads, [buf.clone() for buf in block.buffers()]

    out, grads, bufs = run(shared=True)
    assert calls == {"block": 1, "lfa": 0}
    out2, grads2, bufs2 = run(shared=False)
    assert calls == {"block": 2, "lfa": 2}
    assert torch.equal(out, out2)
    assert all(torch.equal(a, c) for a, c in zip(grads, grads2))
    assert all(torch.equal(a, c) for a, c in zip(bufs, bufs2))


# ---------------------------------------------------------------------------
# criterion, optimizers, schedulers


@pytest.mark.parametrize("weight,smoothing", [(None, 0.0), ([0.25, 0.1, 0.1, 0.5, 2.0], 0.0),
                                              ([0.25, 0.1, 0.1, 0.5, 2.0], 0.1)])
def test_criterion_matches_jax(weight, smoothing):
    """Class weights, label smoothing and the ignore index 65 (pads and
    out-of-range targets drop out): 1e-6, and the gradient of the logits."""
    rng = np.random.default_rng(8)
    logits = rng.normal(0, 2, (2, 30, 5)).astype(np.float32)
    y = rng.integers(0, 5, (2, 30))
    y[0, :4] = 65
    y[1, -6:] = 65
    y[1, 0] = 7
    want, want_grad = jax.value_and_grad(
        lambda lg: JaxCrossEntropy(smoothing, 65, weight)(lg, jnp.asarray(y)))(jnp.asarray(logits))
    lg = _t(logits).requires_grad_(True)
    got = CrossEntropyLoss(smoothing, 65, weight)(lg, _t(y))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_steps_match_optax(name):
    """Three updates of the port's optimizers against the JAX package's
    optax factories on the same parameters and gradients: 1e-6."""
    rng = np.random.default_rng(9)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = getattr(jax_opt, name)(lr=0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = getattr(port_opt, name)(lr=0.01)(list(tp.values()))
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)


def test_lr_schedulers_match_jax():
    """The host-side schedulers give the JAX package's scales step for step,
    and the scale rewrites every parameter group's learning rate."""
    plateau_j, plateau_p = jax_opt.ReduceLROnPlateau(patience=2), port_opt.ReduceLROnPlateau(patience=2)
    for metric in [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.5, 0.6, 0.7, 0.8]:
        assert plateau_p.step(metric) == plateau_j.step(metric)
    cycle_j = jax_opt.OneCycleLR(epochs=2, steps_per_epoch=10)
    cycle_p = port_opt.OneCycleLR(epochs=2, steps_per_epoch=10)
    assert [cycle_p.step() for _ in range(25)] == [cycle_j.step() for _ in range(25)]
    opt = port_opt.adam(lr=0.1)([torch.nn.Parameter(torch.zeros(2))])
    port_opt.set_learning_rate_scale(opt, 0.004, 0.5)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.002)


def test_dropout_draws_from_the_generator():
    """Train-mode dropout of ``mlp_classif`` (rate 0.5) keeps about half the
    activations, rescaled by 2, and repeats for one generator seed; eval
    mode is the identity."""
    net = build_net("RandLANet", {"num_features": 9, "num_classes": 7})
    mlp = net.mlp_classif
    x = torch.rand(2, 400, 32)
    mlp.train()
    a = mlp(x, None, torch.Generator().manual_seed(3))
    b = mlp(x, None, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    zeros = float((a == 0).float().mean())
    assert 0.4 < zeros < 0.6
    mlp.eval()
    assert torch.equal(mlp(x), mlp(x, None, torch.Generator().manual_seed(3)))


@pytest.mark.parametrize("setting,batch,fused", [
    ("auto", FUSED_TRAIN_MIN_BATCH - 1, False), ("auto", FUSED_TRAIN_MIN_BATCH, True),
    ("auto", 2 * FUSED_TRAIN_MIN_BATCH, True), (True, 1, True), (False, 64, False)])
def test_train_lfa_routing(setting, batch, fused):
    """``fused_train_lfa: auto`` goes fused from FUSED_TRAIN_MIN_BATCH (placed
    by the card's train-step turns); a bool forces a route."""
    assert use_fused_train_lfa(setting, batch) is fused


def test_train_lfa_routing_rejects_other_settings():
    with pytest.raises(ValueError, match="fused_train_lfa"):
        use_fused_train_lfa("yes", 16)
