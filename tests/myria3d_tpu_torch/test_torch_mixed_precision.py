"""The compute dtype of the port (``neural_net_hparams.dtype``,
``predict.compute_dtype``: float32, bfloat16, float16) held against the JAX
package (``myria3d_tpu/models/model.py:39-47,213-221``,
``tests/myria3d_tpu/models/test_mixed_precision.py``).

The invariants: parameters and buffers stay f32 through a 16-bit train
step, the logits are f32, each block's output is in the dtype the JAX
package gives it, RandLA-Net takes the unfused train route under 16-bit
whatever ``fused_train_lfa`` says, an unknown dtype raises ``ValueError``.

Both families at small size (N=512, K=8; PointNet++ at widths
16/32/64/128) on weights carried over from a randomly initialised JAX
model (``test_torch_slice._random_jax_variables``), with deterministic
decimation and no dropout on both sides. Tolerances:

- eval forward: on the CPU the JAX package takes its unfused XLA LFA in
  bf16 where the port takes K2's plain version (f32 arithmetic on the bf16
  features), so the bar is a ratio: the port-bf16 logits' largest error
  against JAX-f32 is at most twice the JAX-bf16 logits' plus 1e-3 of the
  JAX-f32 logits' scale (valid points);
- one train step at B=8, port-bf16 against JAX-bf16: the loss within 2e-2
  relative; the whole gradient (every parameter's, flattened together) at
  a cosine of at least 0.995 (PointNet++; reading 0.99938) and 0.99
  (RandLA-Net; reading 0.99163) against the JAX-bf16 gradient, and no
  further from the JAX-f32 gradient than twice the JAX-bf16 gradient is,
  in cosine distance, plus 1e-3 (readings: 0.0671 against 0.0674 for
  PointNet++, 0.0105 against 0.0115 for RandLA-Net). At this size bf16
  moves a gradient far (the deepest stages' BN normalizes a few rows a
  channel, which amplifies each rounding), so the two bf16 gradients agree
  only as far as their ops round alike. RandLA-Net's gap to 0.995 lies in
  two places where XLA rounds otherwise than per op: its fusions keep f32
  between some bf16 ops (0.99269 with that off, ``_per_op``), and the
  sums of its attention softmax's VJP are bf16 reductions (the tests
  below);
- op by op, one train-mode block on the same bf16 inputs, weights and
  output cotangent (PointNet++'s ``fc0``, ``sa1`` and ``fp1``; RandLA-Net's
  ``block1`` on the unfused route), JAX compiled with every op rounded to
  its dtype (``_per_op``; with XLA's default, block1's output lies 0.75 of
  bf16's error from the port's): the output's rms difference from JAX-bf16
  at most 0.05 of JAX-bf16's own from JAX-f32 (readings: 0 for ``fc0``
  and ``sa1``, bit-equal; 0.005 for ``fp1``, 0.012 for ``block1``;
  0.12-0.63 before the LeakyReLU's slope was rounded to the dtype as JAX
  rounds it); the gradients of the parameters (the analytically
  zero Linear biases before a BatchNorm left out) at a cosine of at least
  0.99999 (PointNet++; readings 1.0000000) and 0.998 (RandLA-Net; reading
  0.99922, JAX-bf16 against JAX-f32 0.99753), those of the inputs 0.9999
  (readings >= 0.99998: K4 sums the gathers' cotangents in f32 where XLA
  sums bf16) and 0.998 (reading 0.99912); the masked softmax's VJP no
  further from f32 than JAX's;
- ``predict(config, device="cpu")`` with ``predict.compute_dtype=bfloat16``
  runs the net in bf16, and its class map agrees with the f32 run's on at
  least 0.99 of the predicted points; predict's replicas carry the dtype.
"""

import flax
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myria3d_tpu.models.modules.pointnet2 as jax_pn2
import myria3d_tpu.models.modules.randla_net as jax_rl
import myria3d_tpu_torch.models.modules.randla_net as port_rl
from myria3d_tpu.models.criterion import CrossEntropyLoss as JaxCrossEntropy
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch import predict as predict_mod
from myria3d_tpu_torch import run
from myria3d_tpu_torch.models import model as model_mod
from myria3d_tpu_torch.models.model import Model, build_model, build_net
from myria3d_tpu_torch.models.modules.nn import SharedMLP, as_dtype
from myria3d_tpu_torch.utils.checkpoint import load_checkpoint, state_dict_from_jax
from tests.myria3d_tpu_torch.test_torch_predict import CKPT, _overrides, small_tile  # noqa: F401
from tests.myria3d_tpu_torch.test_torch_slice import (
    _jax_det_decimation,
    _port_det_decimation,
    _random_jax_variables,
)
from tests.myria3d_tpu_torch.test_torch_train_slice import _NoDropout

torch.set_num_threads(1)

N = 512
HP = {
    "RandLANet": {"num_features": 9, "num_classes": 7, "num_neighbors": 8},
    "PointNet2": {"num_features": 9, "num_classes": 7, "num_neighbors": 8,
                  "widths": (16, 32, 64, 128)},
}
JAX_NET = {"RandLANet": jax_rl.RandLANet, "PointNet2": jax_pn2.PointNet2}
DTYPES = ("bfloat16", "float16")


def _batch(seed=0, b=2, n=N):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (b, n, 9)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[-1, n * 3 // 4:] = False
    y = rng.integers(0, 7, (b, n))
    y[~mask] = 65
    return x, pos, mask, y


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.fixture(scope="module")
def jax_vars():
    """Random JAX variables (non-trivial BN affines and running stats) of
    each family."""
    return {name: _random_jax_variables(cls(**HP[name]), 256) for name, cls in JAX_NET.items()}


def _port_net(name, jax_vars, **hp):
    net = build_net(name, {**HP[name], **hp})
    net.load_state_dict(state_dict_from_jax(*jax_vars[name]), strict=True)
    return net


def _no_dropout(net):
    if hasattr(net, "mlp_classif"):
        net.mlp_classif.dropout = [0.0, 0.0]
    else:
        net.head.dropout = [0.0]


@pytest.mark.parametrize("name", list(HP))
@pytest.mark.parametrize("dtype", DTYPES)
def test_state_stays_f32_and_logits_are_f32(name, dtype):
    model = build_model(name, {**HP[name], "dtype": dtype})
    assert model.net.dtype == as_dtype(dtype)
    assert model.hparams["neural_net_hparams"]["dtype"] == dtype
    x, pos, mask, y = _torch(*_batch())
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    loss, logits = model.train_step(x, pos, y, mask, torch.Generator().manual_seed(0))
    assert logits.dtype == torch.float32 and bool(torch.isfinite(loss))
    after = model.net.state_dict()
    assert all(v.dtype == torch.float32 for v in after.values())
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in model.net.parameters())
    _, logits = model.eval_step(x, pos, y, mask, torch.Generator().manual_seed(0))
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits[mask]).all())


def _block_dtypes(net, training, x, pos, mask):
    """Output dtype of each module of the net (the first tensor of a tuple
    output) in one forward, and the input dtypes of its ``SharedMLP`` s."""
    seen, inputs = {}, {}
    for n, mod in net.named_modules():
        def hook(_, __, out, n=n):
            seen[n] = (out[0] if isinstance(out, tuple) else out).dtype

        mod.register_forward_hook(hook)
        if isinstance(mod, SharedMLP):
            mod.register_forward_pre_hook(lambda _, args, n=n: inputs.__setitem__(n, args[0].dtype))
    net.train(training)
    with torch.set_grad_enabled(training):
        net(x, pos, mask, torch.Generator().manual_seed(0))
    seen["inputs"] = inputs
    return seen


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_each_block_outputs_the_compute_dtype(dtype, training):
    """The outputs of the blocks, LFAs, set abstractions, feature
    propagations and MLPs in the dtype; the head's Linear in f32."""
    dt = as_dtype(dtype)
    x, pos, mask, _ = _torch(*_batch())
    rl = _block_dtypes(build_net("RandLANet", {**HP["RandLANet"], "dtype": dtype}),
                       training, x, pos, mask)
    for n in ("block1", "block2", "block3", "block4", "block1.lfa1", "block4.lfa2",
              "block2.mlp1", "block3.shortcut", "mlp_summit", "fp4.nn", "fp1.nn",
              "mlp_classif"):
        assert rl[n] == dt, (n, rl[n])
    assert rl["fc_classif"] == torch.float32
    pn = _block_dtypes(build_net("PointNet2", {**HP["PointNet2"], "dtype": dtype}),
                       training, x, pos, mask)
    for n in ("fc0", "sa1", "sa4", "sa1.pointnet", "fp4", "fp1", "fp4.nn.mlp", "head"):
        assert pn[n] == dt, (n, pn[n])
    assert pn["fc_classif"] == torch.float32
    # no f32 promotion on the way (a cat of an f32 and a 16-bit tensor is
    # f32): every MLP, the LocSE encoder and the attention included, reads
    # the compute dtype
    for inputs in (rl["inputs"], pn["inputs"]):
        assert len(inputs) >= 10 and set(inputs.values()) == {dt}, inputs


@pytest.mark.parametrize("dtype", ["float32", *DTYPES])
@pytest.mark.parametrize("setting", ["auto", True])
def test_randla_net_takes_the_unfused_route_under_16_bit(monkeypatch, dtype, setting):
    """At B=16 ``fused_train_lfa`` auto or true takes the fused route in
    f32 and the unfused one under 16-bit (``randla_net.py:268-271``)."""
    calls = []
    real = port_rl.lfa_train
    monkeypatch.setattr(port_rl, "lfa_train", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    net = build_net("RandLANet", {**HP["RandLANet"], "dtype": dtype,
                                  "fused_train_lfa": setting})
    x, pos, mask, _ = _torch(*_batch(b=16, n=256))
    net.train()
    out = net(x, pos, mask, torch.Generator().manual_seed(0))
    out.sum().backward()
    assert bool(calls) == (dtype == "float32")


@pytest.mark.parametrize("bad", ["float64", "int8", "bf16", torch.float64])
def test_an_unknown_dtype_raises(bad):
    with pytest.raises(ValueError, match="compute dtype"):
        build_model("RandLANet", {**HP["RandLANet"], "dtype": bad})
    model = build_model("PointNet2", HP["PointNet2"])
    with pytest.raises(ValueError, match="compute dtype"):
        model.set_compute_dtype(bad)


def _per_op(fn, *args):
    """``fn(*args)`` compiled with every op rounded to its dtype: XLA's
    ``xla_allow_excess_precision`` (on by default) lets a fusion keep f32
    between the 16-bit ops of a chain, which eager JAX and torch round."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax_forward(name, jax_vars, dtype, train, x, pos, mask, y=None):
    """JAX eval logits, or (loss, gradients as torch entries) of a train
    step, in ``dtype``, deterministic decimation, no dropout."""
    net = JAX_NET[name](**HP[name], dtype=dtype)
    params, stats = jax_vars[name]
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(mask))
    if not train:
        return np.asarray(jax.jit(lambda p: net.apply(
            {"params": p, "batch_stats": stats}, *args, train=False,
            rngs={"decimation": jax.random.PRNGKey(2)}))(params))

    def loss_fn(p):
        logits, _ = net.apply({"params": p, "batch_stats": stats}, *args, train=True,
                              mutable=["batch_stats"],
                              rngs={"decimation": jax.random.PRNGKey(2),
                                    "dropout": jax.random.PRNGKey(3)})
        return JaxCrossEntropy()(logits, jnp.asarray(y))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), flax_to_torch_state_dict(jax.device_get(grads), {})


@pytest.fixture
def det_no_dropout(monkeypatch):
    """Deterministic decimation on both sides, and no dropout in JAX (the
    port's is switched off on the net)."""
    monkeypatch.setattr(jax_rl, "random_decimation", _jax_det_decimation)
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    orig = jax_pn2.SharedMLP

    def no_dropout(*args, dropout=None, **kwargs):
        return orig(*args, **kwargs)

    monkeypatch.setattr(jax_pn2, "SharedMLP", no_dropout)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("name", list(HP))
def test_bf16_eval_forward_holds_against_jax(name, jax_vars, det_no_dropout,
                                             jax_search_on_its_kernel):
    jax_search_on_its_kernel()
    x, pos, mask, _ = _batch(1)
    want32 = _jax_forward(name, jax_vars, jnp.float32, False, x, pos, mask)[mask]
    jax16 = _jax_forward(name, jax_vars, jnp.bfloat16, False, x, pos, mask)[mask]
    net = _port_net(name, jax_vars, dtype="bfloat16").eval()
    with torch.no_grad():
        got = net(*_torch(x, pos, mask))
    assert got.dtype == torch.float32
    got = got.numpy()[mask]
    scale = float(np.abs(want32).max())
    e_jax, e_port = (float(np.abs(a - want32).max()) for a in (jax16, got))
    assert e_port <= 2 * e_jax + 1e-3 * scale, (e_port, e_jax, scale)
    assert np.isfinite(got).all()


def _flat(grads: dict) -> np.ndarray:
    return np.concatenate([np.asarray(grads[k], np.float64).ravel() for k in sorted(grads)])


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# the train step's whole-gradient cosine, port-bf16 against JAX-bf16
DIRECT_COS = {"PointNet2": 0.995, "RandLANet": 0.99}


@pytest.mark.parametrize("name", list(HP))
def test_bf16_train_step_holds_against_jax(name, jax_vars, det_no_dropout,
                                           jax_search_on_its_kernel):
    jax_search_on_its_kernel()
    x, pos, mask, y = _batch(2, b=8)
    want_loss, want16 = _jax_forward(name, jax_vars, jnp.bfloat16, True, x, pos, mask, y)
    _, want32 = _jax_forward(name, jax_vars, jnp.float32, True, x, pos, mask, y)
    net = _port_net(name, jax_vars, dtype="bfloat16")
    _no_dropout(net)
    model = Model(net)
    model.init_train_state()
    tx, tpos, tmask, ty = _torch(x, pos, mask, y)
    loss, _ = model.grad_step(tx, tpos, ty, tmask)
    assert float(loss) == pytest.approx(want_loss, rel=2e-2)
    got = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert got.keys() == want16.keys()
    ref = _flat(want32)
    d_port, d_jax = 1 - _cos(_flat(got), ref), 1 - _cos(_flat(want16), ref)
    assert d_port <= 2 * d_jax + 1e-3, (d_port, d_jax)
    direct = _cos(_flat(got), _flat(want16))
    assert direct >= DIRECT_COS[name], (direct, d_port, d_jax)


# the blocks of the op-by-op check: PointNet++ with radii that hold ~7
# points of the N=512 test cloud in sa1's ball (the net's 0.05 holds one)
BLOCK_HP = {"PointNet2": {**HP["PointNet2"], "radii": (0.3, 0.5, 0.8, 1.2)},
            "RandLANet": HP["RandLANet"]}
BLOCKS = [("PointNet2", "fc0"), ("PointNet2", "sa1"), ("PointNet2", "fp1"),
          ("RandLANet", "block1")]


def _jax_block(name, block, dtype):
    """The JAX module of one block of ``name``'s net at ``BLOCK_HP``."""
    from myria3d_tpu.models.modules.nn import SharedMLP as JaxSharedMLP

    hp = BLOCK_HP[name]
    if block == "fc0":
        return JaxSharedMLP([32], dtype=dtype)
    if block == "sa1":
        w = hp["widths"][0]
        return jax_pn2.SetAbstraction(4, hp["radii"][0], hp["num_neighbors"],
                                      [w // 2, w // 2, w], dtype=dtype)
    if block == "fp1":
        return jax_pn2.FeaturePropagation([128], dtype=dtype)
    return jax_rl.DilatedResidualBlock(hp["num_neighbors"], 32, dtype=dtype,
                                       fused_train_lfa=False)


def _bf16_values(a):
    """``a`` rounded to bf16, held in f32."""
    return np.asarray(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                      .to(torch.bfloat16).float())


def _block_inputs(block, seed=5, b=2, n=N):
    """The block's inputs (features hold bf16 values) and the positions of
    its feature inputs among them."""
    rng = np.random.default_rng(seed)
    x, pos, mask, _ = _batch(seed, b, n)
    if block == "fc0":
        return (_bf16_values(x), mask), [0]
    if block == "fp1":
        m = n // 4
        return (_bf16_values(rng.normal(0, 1, (b, m, 128))), pos[:, :m], mask[:, :m],
                _bf16_values(rng.normal(0, 1, (b, n, 32))), pos, mask), [0, 3]
    return (_bf16_values(rng.normal(0, 1, (b, n, 32))), pos, mask), [0]


def _cotangent(shape):
    return _bf16_values(np.random.default_rng(9).normal(0, 1, shape))


def _jax_block_step(name, block, variables, dtype, inputs, feats):
    """JAX, one train-mode forward of the block in ``dtype`` and its VJP at
    ``_cotangent``: (output, the parameters' gradients under the net's
    torch names, the feature inputs' gradients), as f32 arrays."""
    mod = _jax_block(name, block, dtype)
    params, stats = (v[block] for v in variables)

    def f(p, *fs):
        args = [jnp.asarray(a) for a in inputs]
        for i, v in zip(feats, fs):
            args[i] = v
        out, _ = mod.apply({"params": p, "batch_stats": stats}, *args, True,
                           mutable=["batch_stats"])
        return (out[0] if isinstance(out, tuple) else out).astype(jnp.float32)

    fs = [jnp.asarray(inputs[i]).astype(dtype) for i in feats]
    cot = jnp.asarray(_cotangent(jax.eval_shape(f, params, *fs).shape))
    out, (gp, *gx) = _per_op(lambda p, c, *fs: (lambda o, vjp: (o, vjp(c)))(
        *jax.vjp(f, p, *fs)), params, cot, *fs)
    grads = flax_to_torch_state_dict({block: jax.device_get(gp)}, {})
    return np.asarray(out), grads, [np.asarray(g, np.float32) for g in gx]


def _port_block_step(name, block, variables, inputs, feats):
    """The port's bf16 block, as ``_jax_block_step``."""
    net = _port_net(name, {name: variables}, dtype="bfloat16", **BLOCK_HP[name])
    mod = getattr(net, block).train()
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in inputs]
    for i in feats:
        args[i] = args[i].to(torch.bfloat16).requires_grad_()
    out = mod(*args)
    out = out[0] if isinstance(out, tuple) else out
    assert out.dtype == torch.bfloat16
    out.float().backward(torch.from_numpy(_cotangent(tuple(out.shape))))
    grads = {f"{block}.{k}": p.grad.numpy() for k, p in mod.named_parameters()}
    return out.detach().float().numpy(), grads, [args[i].grad.float().numpy() for i in feats]


def _rms_of(d, ref):
    return float(np.sqrt(np.mean(np.square(d, dtype=np.float64))
                         / np.mean(np.square(ref, dtype=np.float64))))


@pytest.mark.parametrize("name,block", BLOCKS)
def test_bf16_blocks_hold_against_jax_op_by_op(name, block, jax_search_on_its_kernel):
    jax_search_on_its_kernel()
    variables = _random_jax_variables(JAX_NET[name](**BLOCK_HP[name]), 256)
    inputs, feats = _block_inputs(block)
    j32 = _jax_block_step(name, block, variables, jnp.float32, inputs, feats)
    j16 = _jax_block_step(name, block, variables, jnp.bfloat16, inputs, feats)
    p16 = _port_block_step(name, block, variables, inputs, feats)
    e_ref, e_port = _rms_of(j16[0] - j32[0], j32[0]), _rms_of(p16[0] - j16[0], j32[0])
    assert e_port <= 0.05 * e_ref, (e_port, e_ref)
    assert p16[1].keys() == j16[1].keys()
    # not the Linear biases before a BatchNorm: their gradient is
    # analytically zero, and only rounding is left of it
    top = max(np.linalg.norm(v) for v in j32[1].values())
    kept = [k for k, v in j32[1].items() if np.linalg.norm(v) > 1e-4 * top]
    c_params = _cos(*(_flat({k: g[k] for k in kept}) for g in (p16[1], j16[1])))
    c_inputs = [_cos(a.ravel().astype(np.float64), b.ravel().astype(np.float64))
                for a, b in zip(p16[2], j16[2])]
    bar = 0.99999 if name == "PointNet2" else 0.998
    assert c_params >= bar, (c_params, _cos(*(_flat({k: g[k] for k in kept}) for g in (j16[1], j32[1]))))
    assert min(c_inputs) >= (0.9999 if name == "PointNet2" else 0.998), c_inputs


def test_bf16_masked_softmax_holds_against_jax():
    """The attention's masked softmax and pooling in bf16 (``masked.py``,
    ``randla_net.py:186-197``): the forward bit-equal to JAX's. The VJP is
    not: the sums over the K slots that JAX's autodiff adds (the transposes
    of its broadcasts) are bf16 reductions, which torch's autograd takes in
    f32, and the scores' cotangent cancels in them. The port's VJP must be
    no further from the f32 VJP than JAX's bf16 one is (rms of the f32
    VJP's scale; readings 5.42e-3 against 6.34e-3, and 5.50e-3 between the
    two bf16 VJPs, whose entries are equal on 0.67 of the slots)."""
    from myria3d_tpu.ops.masked import masked_softmax as jax_masked_softmax
    from myria3d_tpu_torch.ops.masked import masked_softmax

    rng = np.random.default_rng(3)
    scores, feats = (_bf16_values(rng.normal(0, s, (2, 256, 8, 32))) for s in (2.0, 1.0))
    valid = rng.uniform(size=(2, 256, 8, 1)) < 0.9
    valid[0, :4] = False
    cot = _bf16_values(rng.normal(0, 1, (2, 256, 32)))

    def jax_step(dtype):
        def f(a, b):
            return jnp.sum(jax_masked_softmax(a, jnp.asarray(valid), axis=2) * b, axis=2)

        out, vjp = jax.vjp(f, *(jnp.asarray(v).astype(dtype) for v in (scores, feats)))
        return [np.asarray(t, np.float32) for t in (out, *vjp(jnp.asarray(cot).astype(dtype)))]

    j32, j16 = jax_step(jnp.float32), jax_step(jnp.bfloat16)
    a, b = (torch.from_numpy(v).to(torch.bfloat16).requires_grad_() for v in (scores, feats))
    out = (masked_softmax(a, torch.from_numpy(valid), dim=2) * b).sum(dim=2)
    out.backward(torch.from_numpy(cot).to(torch.bfloat16))
    p16 = [t.detach().float().numpy() for t in (out, a.grad, b.grad)]
    assert np.array_equal(p16[0], j16[0]) and np.array_equal(p16[2], j16[2])
    e_jax, e_port = (_rms_of(v[1] - j32[1], j32[1]) for v in (j16, p16))
    assert e_port <= e_jax, (e_port, e_jax)


def test_predict_runs_with_a_compute_dtype(small_tile, tmp_path, monkeypatch):  # noqa: F811
    """``predict.compute_dtype=bfloat16`` on the CPU: the step runs the net
    in bf16 (f32 weights and wire logits), and the class map agrees with
    the f32 run's."""
    seen = []
    real = model_mod.Model.interp_step

    def spy(self, *args, **kwargs):
        seen.append(self.net.dtype)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(model_mod.Model, "interp_step", spy)
    classes = {}
    for dtype in (None, "bfloat16"):
        cfg = run.compose_config(run.CONFIG_DIR, "config.yaml",
                                 _overrides(small_tile, tmp_path / str(dtype)))
        cfg["predict"]["compute_dtype"] = dtype
        out = predict_mod.predict(cfg, device="cpu")
        from myria3d_tpu_torch.pctl.io.las import read_las

        classes[dtype] = np.asarray(read_las(out).points["PredictedClassification"])
    assert set(seen) == {torch.float32, torch.bfloat16} and seen[-1] == torch.bfloat16
    assert (classes[None] == classes["bfloat16"]).mean() >= 0.99


def test_predict_replicas_carry_the_dtype(monkeypatch):
    """``predict()`` sets the dtype before ``auto_parallel`` copies the model:
    each replica runs in it, and the rows split over two CPU replicas give
    the one-replica step's classes (deterministic decimation; on at least
    0.99 of the points, as a 16-bit sum may round apart at another batch
    size)."""
    from myria3d_tpu_torch.parallel import auto_parallel

    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    model = load_checkpoint(CKPT)
    model.set_compute_dtype("bfloat16")
    par = auto_parallel(model, 2, ["cpu", "cpu"])
    assert [r.net.dtype for r in par.replicas] == [torch.bfloat16] * 2
    x, pos, mask, _ = _torch(*_batch(7, b=2, n=256))
    args = (x, pos, mask, pos, pos, mask)
    split, whole = par.interp_step(*args), model.interp_step(*args)
    assert split.shape == whole.shape and bool(torch.isfinite(split).all())
    assert float((split.argmax(-1) == whole.argmax(-1))[mask].float().mean()) >= 0.99


def test_a_checkpoint_rebuilds_with_its_dtype(tmp_path):
    model = load_checkpoint(CKPT)
    model.set_compute_dtype("bfloat16")
    model.save_checkpoint(str(tmp_path / "ckpt"))
    back = load_checkpoint(str(tmp_path / "ckpt"))
    assert back.net.dtype == torch.bfloat16 and back.net.mlp_summit.dtype == torch.bfloat16
    for k, v in back.net.state_dict().items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(v, model.net.state_dict()[k], rtol=0, atol=0)
