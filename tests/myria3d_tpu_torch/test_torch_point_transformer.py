"""Point Transformer in the port (``models/modules/point_transformer.py``) held
against the benchmark's plain reference (``perfbench/reference/
point_transformer.py``) at the published widths (planes 32-512, blocks
2/3/4/6/3, nsample 8/16/16/16/16, share_planes 8) on two clouds of 4096
points padded to 4608 (stage 5 keeps 16 real points), on ``weights.make``'s
seeded weights.

Tolerances: both sides run the same float32 operations in the same order
and select the same neighbours (K1's and FPS's plain versions against the
reference's searches, ties to the lower index), so the eval logits are
held within 1e-6 of their largest; the reference with every product's
operands rounded to a 10-bit mantissa (float16's, and TF32's) moves them
by more than 1e-3 of it, so a float16 forward fails. The interp step is
held within one float16 rounding of the reference's logits interpolated
by ``search.interpolate``. One train step's loss within 1e-6 relative,
every gradient within 1e-4 of its leaf's largest (float32 moment sums in
another order); the leaves whose gradient is analytically zero (a bias
under a BatchNorm's batch moments, or under the softmax) are held within
1e-5 of the net's largest gradient instead.
"""

import json
import os

import numpy as np
import pytest
import torch

from myria3d_tpu_torch import predict as predict_mod
from myria3d_tpu_torch import run
from myria3d_tpu_torch.models.criterion import CrossEntropyLoss
from myria3d_tpu_torch.models.model import build_model
from myria3d_tpu_torch.models.modules import get_neural_net_class
from myria3d_tpu_torch.models.modules.point_transformer import (
    Graph,
    PointTransformerSeg,
    VectorAttention,
)
from myria3d_tpu_torch.ops.knn import gather_rows
from myria3d_tpu_torch.pctl.dataset.toy_dataset import write_synthetic_toy_las
from myria3d_tpu_torch.pctl.io.las import read_las
from perfbench import weights
from perfbench.reference import point_transformer as ref
from perfbench.reference import search

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(REPO, "perfbench", "configs", "point_transformer.json")) as _f:
    CONFIG = json.load(_f)
HP = CONFIG["neural_net_hparams"]
N_PAD, N_REAL, M_FULL = 4608, 4096, 6000
SEED = 2 ** 31 + 17


@pytest.fixture(scope="module")
def seeded():
    return weights.make(ref.param_shapes(HP), SEED, "cpu")


def _model(w, **kw):
    model = build_model("PointTransformerSeg", dict(HP), interpolation_k=10, **kw)
    model.net.load_state_dict({k: v.clone() for k, v in w.items()}, strict=True)
    return model


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(2, N_PAD, 3, generator=g) * 2 - 1
    x = torch.randn(2, N_PAD, 9, generator=g)
    mask = torch.arange(N_PAD)[None].expand(2, -1) < N_REAL
    y = torch.randint(0, 7, (2, N_PAD), generator=g)
    return x, pos, mask, torch.where(mask, y, 65)


def _reference(w, x, pos, mask, tf32=False):
    net = ref.Net({k: v.clone() for k, v in w.items()}, dict(HP))
    net.tf32 = tf32
    with torch.no_grad():
        return net(x, pos, mask)


def test_builds_at_published_widths_and_loads_the_seeded_names(seeded):
    assert get_neural_net_class("PointTransformer") is PointTransformerSeg
    model = _model(seeded)
    layers = [m for m in model.net.modules() if isinstance(m, VectorAttention)]
    assert len(layers) == 18
    assert [len(getattr(model.net, f"enc{i}")) for i in range(1, 6)] == HP["blocks"]
    assert model.net.enc5[1].attn.linear_w[1].weight.shape == (64, 64)
    assert set(model.net.state_dict()) == set(seeded)
    for k, v in model.net.state_dict().items():
        assert torch.equal(v, seeded[k]), k
    with pytest.raises(RuntimeError):
        model.net.load_state_dict({k: v for k, v in seeded.items() if "norms" not in k},
                                  strict=True)


def test_logits_match_the_reference(seeded):
    x, pos, mask, _ = _batch()
    model = _model(seeded).eval()
    with torch.no_grad():
        got = model.net(x, pos, mask)
    want = _reference(seeded, x, pos, mask)
    assert got.shape == (2, N_PAD, 7) and got.dtype == torch.float32
    scale = float(want[mask].abs().max())
    gap = float((got - want)[mask].abs().max()) / scale
    assert gap <= 1e-6, gap
    assert torch.isfinite(got[mask]).all()
    lower = _reference(seeded, x, pos, mask, tf32=True)
    assert float((lower - want)[mask].abs().max()) / scale > 1e-3


def test_interp_step_matches_the_reference(seeded):
    x, pos, mask, _ = _batch(1)
    g = torch.Generator().manual_seed(5)
    full_pos = torch.rand(2, M_FULL, 3, generator=g) * 2 - 1
    full_mask = torch.arange(M_FULL)[None] < torch.tensor([[M_FULL], [5000]])
    model = _model(seeded).eval()
    full = model.interp_step(x, pos, mask, pos, full_pos, full_mask)
    assert full.dtype == torch.float16 and full.shape == (2, M_FULL, 7)
    want = search.interpolate(_reference(seeded, x, pos, mask), pos, mask, full_pos, full_mask,
                              10)
    np.testing.assert_allclose(full.float().numpy(), want.numpy(), rtol=2 ** -10,
                               atol=1e-6 * float(want.abs().max()))
    assert not full.float().numpy()[~full_mask.numpy()].any()


def test_pad_rows_change_no_valid_logit(seeded):
    x, pos, mask, _ = _batch(2)
    model = _model(seeded).eval()
    x2, pos2 = x.clone(), pos.clone()
    x2[~mask], pos2[~mask] = 999.0, -777.0
    with torch.no_grad():
        a = model.net(x, pos, mask)
        b = model.net(x2, pos2, mask)
    assert torch.equal(a[mask], b[mask])


def test_train_step_gives_the_references_loss_and_gradients(seeded):
    """One ``Model.train_step`` (two batches a group, so that the step
    leaves the gradients in ``.grad``, halved) against the reference's
    masked cross-entropy and autograd."""
    x, pos, mask, y = _batch(3)
    model = _model(seeded, accumulate_grad_batches=2)
    loss, logits = model.train_step(x, pos, y, mask)
    assert model.accum == 1 and logits.shape == (2, N_PAD, 7)

    P = {k: v.clone().requires_grad_(not k.endswith(("running_mean", "running_var")))
         for k, v in seeded.items()}
    out = ref.Net(P, dict(HP), train=True)(x, pos, mask)
    logp = torch.log_softmax(out, dim=-1)
    counted = y != 65
    nll = -logp.gather(-1, torch.where(counted, y, 0)[..., None])[..., 0]
    want_loss = (nll * counted).sum() / counted.sum()
    want_loss.backward()
    assert float(loss) == pytest.approx(float(want_loss.detach()), rel=1e-6)
    assert float(CrossEntropyLoss()(logits, y)) == pytest.approx(float(loss), rel=1e-6)

    grads = {k: 2.0 * p.grad for k, p in model.net.named_parameters()}
    want = {k: P[k].grad for k in grads}
    assert all(g is not None for g in want.values())
    top = max(float(g.abs().max()) for g in want.values())
    zero = {k for k, g in want.items() if float(g.abs().max()) <= 1e-5 * top}
    # biases under batch-moment BatchNorms, and linear_w's last under the softmax
    assert {k for k in zero if not k.endswith(".bias")} == set()
    assert any("linear_w.1.bias" in k for k in zero) and any("linear_q.bias" in k for k in zero)
    for k, g in grads.items():
        err = float((g - want[k]).abs().max())
        if k in zero:
            assert err <= 1e-5 * top, k
        else:
            assert err <= 1e-4 * float(want[k].abs().max()), (k, err)
    # the running statistics moved as the reference's did
    state = model.net.state_dict()
    for k in (k for k in P if k.endswith("running_var")):
        torch.testing.assert_close(state[k], P[k], rtol=1e-5, atol=1e-6)


def test_predict_writes_a_tile_with_a_point_transformer_checkpoint(seeded, tmp_path):
    """``model=point_transformer_model`` composes; a checkpoint of its net
    predicts a small synthetic tile through ``predict()`` on the CPU."""
    tile = write_synthetic_toy_las(str(tmp_path / "tile.las"), n_points=6000)
    overrides = ["task.task_name=predict", "model=point_transformer_model",
                 f"predict.src_las={tile}", f"predict.ckpt_path={tmp_path / 'ckpt'}",
                 f"predict.output_dir={tmp_path / 'out'}", "datamodule.batch_size=2",
                 "trainer.accelerator=cpu"]
    cfg = run.compose_config(run.CONFIG_DIR, "config.yaml", overrides)
    mcfg = cfg["model"]
    assert mcfg["neural_net_hparams"] == {k: v for k, v in HP.items()}
    model = build_model(mcfg["neural_net_class_name"], mcfg["neural_net_hparams"],
                        interpolation_k=mcfg["interpolation_k"], d_in=mcfg["d_in"],
                        num_classes=mcfg["num_classes"],
                        classification_dict=mcfg["classification_dict"])
    model.net.load_state_dict(seeded, strict=True)
    model.save_checkpoint(str(tmp_path / "ckpt"))
    phases = {}
    out = predict_mod.predict(cfg, phases=phases, device="cpu")
    src, res = read_las(tile).points, read_las(out).points
    assert len(res) == len(src) and phases["n_batches"] >= 1
    names = list(CONFIG["classification_dict"].values())
    probas = np.stack([np.asarray(res[c], np.float64) for c in names], axis=1)
    sums = probas.sum(1)
    covered = np.abs(sums - 1.0) < 1e-3
    assert np.isfinite(probas).all() and (covered | (sums == 0)).all() and covered.mean() > 0.9
    assert set(np.unique(res["PredictedClassification"][covered])) <= {1, 2, 5, 6, 9, 17, 64}


# K9's parameters on the CPU: the layer rebuilt on them
# (``ops.cuda_vector_attention.vector_attention_plain``, the route a CPU
# tensor takes, whose operations the kernel repeats in order) against
# ``VectorAttention.forward``'s torch composition at eval, at the five
# published (C, K) widths with share_planes 8: the same operations on the
# same values, so the outputs are equal.
K9_WIDTHS = [(32, 8), (64, 16), (128, 16), (256, 16), (512, 16)]


def _eval_layer(c, seed):
    """A ``VectorAttention(c, 8)`` at eval with seeded weights and
    BatchNorm statistics away from the identity."""
    torch.manual_seed(seed)
    layer = VectorAttention(c, 8)
    with torch.no_grad():
        for bn in layer.norms:
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0.0, 0.2)
            bn.running_mean.normal_(0.0, 0.5)
            bn.running_var.uniform_(0.5, 2.0)
    return layer.eval()


def _edges(b, n, k, c, seed):
    """x (B, N, C) and a Graph with invalid slots (index 0, as ``knn``
    leaves them), pad queries (the last rows of cloud 1, no valid slot) and
    one real query whose slots are all invalid."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(b, n, 3, generator=g) * 2 - 1
    x = torch.randn(b, n, c, generator=g)
    idx = torch.randint(0, n, (b, n, k), generator=g, dtype=torch.int32)
    valid = torch.rand(b, n, k, generator=g) < 0.8
    valid[..., 0] = True
    valid[1, n - n // 7:] = False
    valid[0, 3] = False
    idx = torch.where(valid, idx, 0)
    return x, Graph(idx, valid, gather_rows(pos, idx) - pos[:, :, None, :])


@pytest.mark.parametrize("c,k", K9_WIDTHS)
def test_kernel_params_rebuild_the_torch_route(c, k):
    from myria3d_tpu_torch.ops.cuda_vector_attention import vector_attention

    layer = _eval_layer(c, seed=c)
    x, g = _edges(2, 45, k, c, seed=k + c)
    with torch.no_grad():
        want = layer(x, g)
        q, kx, v = layer.linear_q(x), layer.linear_k(x), layer.linear_v(x)
        got = vector_attention(q, kx, v, g.idx, g.valid, g.rel, *layer.kernel_params())
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)
    # pad queries and the query with no valid slot give 0
    assert not got[1, 45 - 45 // 7:].any() and not got[0, 3].any()


def test_kernel_params_are_prepared_once_and_again_after_a_load_or_a_train_round_trip(
        monkeypatch):
    from myria3d_tpu_torch.models.modules import point_transformer as pt
    from myria3d_tpu_torch.ops.cuda_vector_attention import layer_params

    calls = []

    def counted(*a):
        calls.append(1)
        return layer_params(*a)

    monkeypatch.setattr(pt, "layer_params", counted)
    layer = _eval_layer(64, seed=1)
    first = layer.kernel_params()
    assert layer.kernel_params()[1] is first[1] and len(calls) == 1
    # a load of other weights prepares them again, from the new values
    other = _eval_layer(64, seed=2)
    layer.load_state_dict(other.state_dict())
    after_load = layer.kernel_params()
    assert len(calls) == 2
    for a, b in zip(after_load[0], layer_params(other.linear_p, other.linear_w, other.norms)):
        assert torch.equal(a, b)
    assert not torch.equal(after_load[1], first[1])
    # a train()/eval() round trip whose training forward moves the running
    # statistics prepares them again, from the new statistics; a round trip
    # that changes nothing keeps them, and an in-place update prepares them
    layer.train()
    x, g = _edges(2, 30, 16, 64, seed=7)
    layer(x, g)
    layer.eval()
    trained = layer.kernel_params()
    assert len(calls) == 3 and not torch.equal(trained[0].bn1[0], after_load[0].bn1[0])
    for a, b in zip(trained[0], layer_params(layer.linear_p, layer.linear_w, layer.norms)):
        assert torch.equal(a, b)
    layer.train()
    layer.eval()
    assert layer.kernel_params()[1] is trained[1] and len(calls) == 3
    with torch.no_grad():
        layer.norms[1].running_var.mul_(2.0)
    again = layer.kernel_params()
    assert len(calls) == 4 and not torch.equal(again[0].bn1[1], trained[0].bn1[1])


def test_kernel_params_of_a_layer_built_under_inference_mode_are_prepared_every_call():
    from myria3d_tpu_torch.ops.cuda_vector_attention import layer_params

    with torch.inference_mode():
        layer = _eval_layer(32, seed=5)
        first = layer.kernel_params()
        for a, b in zip(first[0], layer_params(layer.linear_p, layer.linear_w, layer.norms)):
            assert torch.equal(a, b)
        layer.norms[1].running_mean.add_(1.0)   # an in-place update keeps no version here
        again = layer.kernel_params()
    assert again[1] is not first[1] and torch.equal(again[0].bn1[0], first[0].bn1[0] + 1.0)


def test_cpu_and_training_keep_the_torch_route(monkeypatch):
    from myria3d_tpu_torch.models.modules import point_transformer as pt

    def refused(*a, **k):
        raise AssertionError("K9 on the CPU")

    monkeypatch.setattr(pt, "vector_attention", refused)
    layer = _eval_layer(32, seed=3)
    x, g = _edges(2, 30, 8, 32, seed=4)
    with torch.no_grad():
        want = layer.composed(layer.linear_q(x), layer.linear_k(x), layer.linear_v(x), g)
        assert torch.equal(layer(x, g), want)
    layer.train()
    assert layer(x, g).shape == (2, 30, 32)
