"""Point Transformer V3 in the port (``models/modules/point_transformer_v3.py``
over ``ops/serialize.py``, ``ops/sparse_conv.py`` and
``ops/patch_attention.py``) held against the benchmark's plain reference
(``perfbench/reference/point_transformer_v3.py``) at the published sizes
(encoder 2/2/2/6/2 x 32-512, decoder 2/2/2/2 x 64/64/128/256, 16 channels a
head, patches of 1024, four shuffled orders) on two clouds of ~3000 points
padded to 4096, on ``weights.make``'s seeded weights, and its parts against
hand counts.

Tolerances: the program and the reference select the same neighbours,
patches and parents and run the same float32 operations, but sum some of
them in other orders (the attention's softmax and products by the CPU's
SDPA against explicit ``q @ k^T``; each LayerNorm's moments), so the eval
logits are held within 2e-5 of their largest (a few float32 roundings at
each of 22 blocks). The reference with every product's operands rounded to
a 10-bit mantissa (float16's, and TF32's) moves them by more than 1e-3 of
it, so a float16 forward fails. The interp step is held within one float16
rounding of the reference's logits interpolated by ``search.interpolate``.
One train step's loss within 1e-5 relative; its gradients, in float64
(why: the test's docstring), within 1e-4 of each leaf's largest (the
program's BatchNorm takes its moments in float32), a leaf whose gradient is
analytically zero within 1e-6 of the net's largest.
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
from myria3d_tpu_torch.models.modules.point_transformer_v3 import Block, PointTransformerV3Seg
from myria3d_tpu_torch.ops import patch_attention, serialize, sparse_conv
from myria3d_tpu_torch.pctl.dataset.toy_dataset import write_synthetic_toy_las
from myria3d_tpu_torch.pctl.io.las import read_las
from perfbench import weights
from perfbench.reference import point_transformer_v3 as ref
from perfbench.reference import search

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(REPO, "perfbench", "configs", "point_transformer_v3.json")) as _f:
    CONFIG = json.load(_f)
HP = CONFIG["neural_net_hparams"]
N_PAD, COUNTS, M_FULL = 4096, (3100, 2900), 6000
SEED = 2 ** 31 + 23
GAP = 2e-5


@pytest.fixture(scope="module")
def seeded():
    return weights.make(ref.param_shapes(HP), SEED, "cpu")


def _model(w, **kw):
    model = build_model("PointTransformerV3Seg", dict(HP), interpolation_k=10, **kw)
    model.net.load_state_dict({k: v.clone() for k, v in w.items()}, strict=True)
    return model


def _batch(seed=0):
    """Two 2.5-D surfaces of 0.8 x 0.8 (80 x 80 cells of 0.01): a few
    points share a cell, and stage 4 keeps a few points a cloud."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(2, N_PAD, 2, generator=g) * 0.8 - 0.4
    z = 0.05 * torch.sin(8 * xy[..., 0]) * torch.cos(6 * xy[..., 1])
    z = z + 0.02 * torch.rand(2, N_PAD, generator=g)
    pos = torch.cat([xy, z[..., None]], dim=-1)
    x = torch.randn(2, N_PAD, 9, generator=g)
    mask = torch.arange(N_PAD)[None] < torch.tensor(COUNTS)[:, None]
    y = torch.randint(0, 7, (2, N_PAD), generator=g)
    return x, pos, mask, torch.where(mask, y, 65)


def _gen(seed=5):
    return torch.Generator().manual_seed(seed)


def _reference(w, x, pos, mask, tf32=False, seed=5):
    net = ref.Net({k: v.clone() for k, v in w.items()}, dict(HP))
    net.tf32 = tf32
    with torch.no_grad():
        out = net(x, pos, mask, _gen(seed))
    return out, net.slots


def test_builds_at_published_sizes_and_loads_the_seeded_names(seeded):
    assert get_neural_net_class("PointTransformerV3Seg") is PointTransformerV3Seg
    net = _model(seeded).net
    assert [len(s.blocks) for s in net.enc] == [2, 2, 2, 6, 2]
    assert [len(s.blocks) for s in net.dec] == [2, 2, 2, 2]
    assert [s.blocks[0].attn.heads for s in net.enc] == [2, 4, 8, 16, 32]
    assert [s.blocks[0].attn.heads for s in net.dec] == [4, 4, 8, 16]
    assert [s.blocks[0].attn.proj.in_features for s in net.enc] == [32, 64, 128, 256, 512]
    assert [s.blocks[0].attn.proj.in_features for s in net.dec] == [64, 64, 128, 256]
    assert len([m for m in net.modules() if isinstance(m, Block)]) == 22
    assert net.patch == 1024 and net.order == tuple(serialize.ORDERS) and net.shuffle_orders
    assert net.embedding.conv.weight.shape == (32, 125 * 9)
    assert net.dec[0].up.proj.linear.in_features == 64
    assert net.dec[3].up.proj.linear.in_features == 512
    n = sum(p.numel() for p in net.parameters())
    assert 45e6 < n < 47e6, n
    assert set(net.state_dict()) == set(seeded)
    for k, v in net.state_dict().items():
        assert torch.equal(v, seeded[k]), k
    with pytest.raises(RuntimeError):
        net.load_state_dict({k: v for k, v in seeded.items() if "norms" not in k}, strict=True)


def test_logits_match_the_reference_and_counters_its_slots(seeded):
    x, pos, mask, _ = _batch()
    model = _model(seeded).eval()
    model.net.counters = {}
    with torch.no_grad():
        got = model.net(x, pos, mask, _gen())
    want, slots = _reference(seeded, x, pos, mask)
    assert got.shape == (2, N_PAD, 7) and got.dtype == torch.float32
    assert torch.isfinite(got[mask]).all() and not got[~mask].any()
    scale = float(want[mask].abs().max())
    gap = float((got - want)[mask].abs().max()) / scale
    assert gap <= GAP, gap
    lower, _ = _reference(seeded, x, pos, mask, tf32=True)
    assert float((lower - want)[mask].abs().max()) / scale > 50 * GAP
    # the program's counters are the reference's counts
    c = model.net.counters
    assert [c[f"pt3_points.{s}"] for s in range(5)] == slots["points"]
    assert [c["pt3_conv_pairs.stem"]] + [c[f"pt3_conv_pairs.{s}"] for s in range(5)] \
        == slots["conv_pairs"]
    assert [c[f"pt3_attn_pairs.{s}"] for s in range(5)] == slots["attn_pairs"]
    assert c["pt3_dup_points"] == slots["dup_points"] > 0
    assert slots["points"][0] == sum(COUNTS) and slots["points"][4] > 0
    # another shuffle of the orders gives other logits
    with torch.no_grad():
        other = model.net(x, pos, mask, _gen(6))
    assert float((other - got)[mask].abs().max()) > 1e-3 * scale


def test_interp_step_matches_the_reference(seeded):
    x, pos, mask, _ = _batch(1)
    g = torch.Generator().manual_seed(5)
    full_pos = torch.rand(2, M_FULL, 3, generator=g) * 0.8 - 0.4
    full_mask = torch.arange(M_FULL)[None] < torch.tensor([[M_FULL], [5000]])
    model = _model(seeded).eval()
    full = model.interp_step(x, pos, mask, pos, full_pos, full_mask, _gen(7))
    assert full.dtype == torch.float16 and full.shape == (2, M_FULL, 7)
    logits, _ = _reference(seeded, x, pos, mask, seed=7)
    want = search.interpolate(logits, pos, mask, full_pos, full_mask, 10)
    np.testing.assert_allclose(full.float().numpy(), want.numpy(), rtol=2 ** -10,
                               atol=GAP * float(want.abs().max()))
    assert not full.float().numpy()[~full_mask.numpy()].any()


def test_pad_rows_change_no_valid_logit(seeded):
    x, pos, mask, _ = _batch(2)
    model = _model(seeded).eval()
    x2, pos2 = x.clone(), pos.clone()
    x2[~mask], pos2[~mask] = 999.0, -777.0
    with torch.no_grad():
        a = model.net(x, pos, mask, _gen())
        b = model.net(x2, pos2, mask, _gen())
    assert torch.equal(a[mask], b[mask])


def test_train_step_gives_the_references_loss_and_gradients(seeded):
    """One ``Model.train_step`` (two batches a group, so that the step
    leaves the gradients in ``.grad``, halved) against the reference's
    masked cross-entropy and autograd, on one generator state: the loss in
    float32, then the gradients with the net and the reference in float64.

    A max pooling's gradient jumps at a tie: in float32 a child within
    rounding of its parent's max (a relative gap of 5e-6 at stage 4 of this
    batch) can win on one side and lose on the other, which moves whole rows
    of that pooling's weight gradient (9 % of the leaf's largest here) and
    everything upstream of it (1 %). In float64 the two sides' maxima pick
    the same children, and the gradients differ by the program's float32
    BatchNorm moments alone."""
    x, pos, mask, y = _batch(3)
    model = _model(seeded, accumulate_grad_batches=2)
    loss, logits = model.train_step(x, pos, y, mask, _gen(9))
    assert model.accum == 1 and logits.shape == (2, N_PAD, 7)
    counted = y != 65

    def masked_nll(out):
        logp = torch.log_softmax(out, dim=-1)
        nll = -logp.gather(-1, torch.where(counted, y, 0)[..., None])[..., 0]
        return (nll * counted).sum() / counted.sum()

    P = {k: v.clone() for k, v in seeded.items()}
    want_loss = masked_nll(ref.Net(P, dict(HP), train=True)(x, pos, mask, _gen(9)))
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(CrossEntropyLoss()(logits, y)) == pytest.approx(float(loss), rel=1e-6)
    # the running statistics moved as the reference's did
    state = model.net.state_dict()
    for k in (k for k in P if k.endswith(("running_mean", "running_var"))):
        torch.testing.assert_close(state[k], P[k], rtol=1e-5, atol=1e-6)

    model = _model(seeded, accumulate_grad_batches=2)
    model.net.double()
    model.train_step(x.double(), pos, y, mask, _gen(9))
    P = {k: v.clone().double().requires_grad_(not k.endswith(("running_mean", "running_var")))
         for k, v in seeded.items()}
    masked_nll(ref.Net(P, dict(HP), train=True)(x.double(), pos, mask, _gen(9))).backward()
    grads = {k: 2.0 * p.grad for k, p in model.net.named_parameters()}
    assert set(grads) == {k for k, v in P.items() if v.requires_grad}
    top = max(float(P[k].grad.abs().max()) for k in grads)
    # a bias under a batch-moment BatchNorm (through a max or not) has none
    zero = {k for k in grads if float(P[k].grad.abs().max()) <= 1e-9 * top}
    assert zero and all(k.endswith(".bias") for k in zero)
    for k, g in grads.items():
        err = float((g - P[k].grad).abs().max())
        bound = 1e-6 * top if k in zero else 1e-4 * float(P[k].grad.abs().max())
        assert err <= bound, (k, err)


def test_morton_codes_by_hand():
    g = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 0, 1], [3, 5, 6], [7, 7, 7]])
    # x y z from the top of each bit triple: 3 = 011, 5 = 101, 6 = 110 give
    # triples 110 (bit 0), 101 (bit 1), 011 (bit 2): 6 + 5 * 8 + 3 * 64
    assert serialize.morton(g).tolist() == [4, 2, 1, 6 + 5 * 8 + 3 * 64, 511]
    assert torch.equal(serialize.morton(g), ref.morton(g, 3))
    cloud = torch.tensor([0, 0, 1, 1, 2])
    assert serialize.encode(g, cloud, 3, "z")[2] == (1 << 9) | 1
    assert serialize.encode(g, cloud, 3, "z-trans")[3] == (1 << 9) | serialize.morton(
        torch.tensor([[5, 3, 6]]))[0]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_hilbert_curve_visits_every_cell_once_by_face_neighbours(depth):
    side = 1 << depth
    ar = torch.arange(side)
    g = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
    code = serialize.hilbert(g, depth)
    assert sorted(code.tolist()) == list(range(side ** 3))
    path = g[torch.argsort(code)]
    steps = (path[1:] - path[:-1]).abs().sum(dim=1)
    assert (steps == 1).all()
    assert torch.equal(code, ref.hilbert(g, depth))


def test_hilbert_codes_match_the_references_bit_arrays():
    g = torch.randint(0, 200, (500, 3), generator=torch.Generator().manual_seed(1))
    assert torch.equal(serialize.hilbert(g, 8), ref.hilbert(g, 8))
    # a parent's code is its children's >> 3
    assert torch.equal(serialize.hilbert(g, 8) >> 3, serialize.hilbert(g >> 1, 7))
    # the code at a depth held on the device (at MAX_DEPTH levels, the axes
    # cycled back) is the code at that depth
    cloud = torch.arange(500) % 3
    for depth in (8, 9, 10):
        for order in serialize.ORDERS:
            want = serialize.encode(g, cloud, depth, order)
            if order == "hilbert":
                assert torch.equal(want, (cloud << 3 * depth) | serialize.hilbert(g, depth))
            assert torch.equal(serialize.encode(g, cloud, torch.tensor(depth), order), want)


def _brute_force_map(g, cloud, radius):
    r = range(-radius, radius + 1)
    offsets = [(a, b, c) for a in r for b in r for c in r]
    out = torch.full((g.shape[0], len(offsets)), -1)
    for i in range(g.shape[0]):
        for d, off in enumerate(offsets):
            if off == (0, 0, 0):
                out[i, d] = i
                continue
            hit = ((g == g[i] + torch.tensor(off)).all(dim=1) & (cloud == cloud[i])).nonzero()
            if hit.numel():
                out[i, d] = int(hit.min())
    return out


@pytest.mark.parametrize("radius", [1, 2])
def test_kernel_map_matches_a_brute_force_with_duplicate_cells(radius):
    gen = torch.Generator().manual_seed(radius)
    g = torch.randint(0, 5, (60, 3), generator=gen)
    g[7] = g[3]          # a duplicate cell: offset 0 reads itself, others point 3
    g[40] = g[3]         # the same cell in another cloud is not a neighbour
    cloud = (torch.arange(60) >= 30).long()
    c = sparse_conv.cells(g, cloud, torch.ones(60, dtype=torch.bool))
    nbr = sparse_conv.kernel_map(c, radius)
    assert torch.equal(nbr, _brute_force_map(g, cloud, radius))
    want, dups = ref.neighbours(g, [30, 30], radius)
    assert torch.equal(nbr, want)
    assert 60 - int(c.first.sum()) == dups >= 1
    # rows not valid (3 among them: row 7 now holds the cell) read -1, and
    # no row reads them
    valid = torch.ones(60, dtype=torch.bool)
    valid[[3, 20, 45]] = False
    sub = valid.nonzero().squeeze(1)
    part = _brute_force_map(g[sub], cloud[sub], radius)
    masked = torch.full_like(nbr, -1)
    masked[sub] = torch.where(part >= 0, sub[part.clamp(min=0)], -1)
    assert torch.equal(sparse_conv.kernel_map(sparse_conv.cells(g, cloud, valid), radius), masked)
    every = torch.ones(60, dtype=torch.bool)
    assert torch.equal(sparse_conv.occupancy(nbr, every), (nbr >= 0).sum(dim=0))
    pr = sparse_conv.pairs(nbr, sparse_conv.occupancy(nbr, every).tolist())
    # the listing without a synchronisation is the nonzero entries' by offset
    d, i = (nbr.T >= 0).nonzero(as_tuple=True)
    assert torch.equal(torch.cat(pr.out), i) and torch.equal(torch.cat(pr.src), nbr[i, d])
    if radius == 2:
        assert torch.equal(sparse_conv.restrict(nbr, 1), sparse_conv.kernel_map(c, 1))
    assert pr.count == int((nbr >= 0).sum()) and pr.points == 60
    # the convolution over the occupied offsets against the dense sum
    x = torch.randn(60, 4, generator=gen)
    w = torch.randn(5, nbr.shape[1] * 4, generator=gen)
    rows = torch.where((nbr >= 0)[..., None], x[nbr.clamp(min=0)], 0.0)
    dense = rows.reshape(60, -1) @ w.T
    torch.testing.assert_close(sparse_conv.submconv(x, pr, w), dense, rtol=1e-5, atol=1e-5)


def test_clouds_of_k_and_k_plus_one_points_are_patched_as_ptv3_pads_them():
    k, heads, c = 1024, 2, 8
    counts = [k, k + 1, 5]
    lay = patch_attention.layout(counts, k, "cpu")
    # cloud 0 (exactly K) and cloud 2 are one patch each; cloud 1 is two
    # patches of K, the second its last K points
    assert lay.full.shape == (2, k) and lay.short.shape == (2, k)
    assert lay.full[:, 0].tolist() == [k, k + 1]
    assert lay.short[:, 0].tolist() == [0, 2 * k + 1]
    assert lay.key_mask[1, 0, 0].sum() == 5
    assert lay.pairs == k * k + (k + 1) * k + 25
    # each point's keys are those of its patch in Pointcept's pad / unpad
    pad, unpad, cu = ref.padding(counts, k, "cpu")
    n = sum(counts)
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(n, 3 * c, generator=gen)
    order = torch.randperm(n, generator=gen)
    inverse = torch.argsort(order)
    got = patch_attention.attention(qkv, order, inverse, lay, heads)
    t = qkv[order].view(n, 3, heads, c // heads)
    want = torch.empty(n, c)
    for a, b in zip(cu[:-1], cu[1:]):
        keys = pad[a:b]
        att = torch.einsum("qhd,khd->hqk", t[keys, 0], t[keys, 1]) * (c // heads) ** -0.5
        y = torch.einsum("hqk,khd->qhd", att.softmax(dim=-1), t[keys, 2]).reshape(-1, c)
        own = (unpad >= a) & (unpad < b)
        want[own] = y[unpad[own] - a]
    torch.testing.assert_close(got, want[inverse], rtol=1e-5, atol=1e-6)


def test_grid_pooling_keeps_parents_of_the_first_order():
    net = PointTransformerV3Seg(9, 7, stride=(2,), enc_depths=(1, 1), enc_channels=(8, 16),
                                enc_num_head=(1, 1), enc_patch_size=(1024, 1024),
                                dec_depths=(1,), dec_channels=(8,), dec_num_head=(1,),
                                dec_patch_size=(1024,))
    # cloud 0: points 0 and 1 share the parent cell (0, 0, 0), 2 and 3 share
    # (1, 0, 0); cloud 1: one point, then pad rows
    cell = torch.tensor([[[0, 0, 0], [1, 1, 1], [2, 0, 0], [3, 1, 0]],
                         [[0, 0, 0], [5, 5, 5], [0, 0, 0], [0, 0, 0]]])
    pos = (cell + 0.5) * net.grid_size
    mask = torch.tensor([[True] * 4, [True, False, False, False]])
    levels, code, perms, sizes = net._levels(pos, mask, torch.Generator().manual_seed(0))
    replay = torch.Generator().manual_seed(0)
    first = torch.randperm(4, generator=replay)
    assert torch.equal(perms[1], first[torch.randperm(4, generator=replay)])
    st0, members, _ = net._stage(0, levels[0], sizes[0], code, perms[0])
    st1, parents, _ = net._stage(1, levels[1], sizes[1], code, perms[1])
    assert members.tolist() == [0, 1, 2, 3, 4] and sizes[1][:2] == [2, 1]
    parent = levels[1].index[members]
    assert parent[0] == parent[1] and parent[2] == parent[3]
    assert len(set(parent.tolist())) == 3 == st1.ser.code.shape[1]
    # each parent stands for one of its children's slots, in cloud order
    assert (cell.reshape(-1, 3)[parents] >> 1)[parent[2]].tolist() == [1, 0, 0]
    assert (parents // 4).tolist() == sorted((parents // 4).tolist())
    # a parent's four codes are its children's >> 3, taken in the new shuffle
    assert torch.equal(st1.ser.code[:, parent], (st0.ser.code >> 3)[first.argsort()][
        perms[1]])
    h = torch.arange(10.0).view(5, 2)
    assert serialize.segment_max(h, parent, 3)[parent[0]].tolist() == [2.0, 3.0]


def test_predict_writes_a_tile_with_a_point_transformer_v3_checkpoint(seeded, tmp_path):
    """``model=point_transformer_v3_model`` composes; a checkpoint of its net
    predicts a small synthetic tile through ``predict()`` on the CPU, whose
    phases hold the net's counters."""
    tile = write_synthetic_toy_las(str(tmp_path / "tile.las"), n_points=6000)
    overrides = ["task.task_name=predict", "model=point_transformer_v3_model",
                 f"predict.src_las={tile}", f"predict.ckpt_path={tmp_path / 'ckpt'}",
                 f"predict.output_dir={tmp_path / 'out'}", "datamodule.batch_size=2",
                 "trainer.accelerator=cpu"]
    cfg = run.compose_config(run.CONFIG_DIR, "config.yaml", overrides)
    mcfg = cfg["model"]
    assert mcfg["neural_net_hparams"] == HP
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
    assert phases["pt3_points.0"] > 0 and phases["pt3_attn_pairs.0"] > 0
    names = list(CONFIG["classification_dict"].values())
    probas = np.stack([np.asarray(res[c], np.float64) for c in names], axis=1)
    sums = probas.sum(1)
    covered = np.abs(sums - 1.0) < 1e-3
    assert np.isfinite(probas).all() and (covered | (sums == 0)).all() and covered.mean() > 0.9
    assert set(np.unique(res["PredictedClassification"][covered])) <= {1, 2, 5, 6, 9, 17, 64}
