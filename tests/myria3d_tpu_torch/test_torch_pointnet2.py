"""PointNet++ in the port (``models/modules/pointnet2.py``) held against the
JAX package (``myria3d_tpu/models/modules/pointnet2.py``), at narrow widths
(16/32/64/128; the full width only in the parameter count), on weights
carried over from a randomly initialised JAX model with non-trivial BN
affines and running stats.

JAX's searches run on its own kernel (``jax_search_on_its_kernel``), so
both sides rank and weigh the same squared differences, and FPS is exact on
both (``test_torch_fps.py``). Tolerances: eval logits within 1e-4 of their
scale (f32 sums in another order); one train step's loss within 1e-6
relative, every gradient at a cosine of at least 0.9999 and within 1e-4 of
its scale, the BN running stats within 1e-5. The Linear biases that feed a
BatchNorm have an exact-zero gradient, which both sides give as f32 noise:
those are held within 1e-6 of the net's largest gradient instead (their
cosine is noise). The head's dropout is off on both sides (JAX's and
torch's random draws cannot match). The interp step is held within f16
rounding (one f16 ulp, 2^-10 relative, of the JAX step's f16 output).
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myria3d_tpu.models.modules.pointnet2 as jax_pn2
from myria3d_tpu.models.criterion import CrossEntropyLoss as JaxCrossEntropy
from myria3d_tpu.models.modules import MODEL_ZOO as JAX_ZOO
from myria3d_tpu.ops.interpolate import knn_interpolate as jax_knn_interpolate
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch import run
from myria3d_tpu_torch.models.model import Model, build_model, build_net
from myria3d_tpu_torch.models.modules import MODEL_ZOO, get_neural_net_class
from myria3d_tpu_torch.models.modules.pointnet2 import PointNet2
from myria3d_tpu_torch.models.modules.randla_net import RandLANet
from myria3d_tpu_torch.pctl.dataset.toy_dataset import (
    make_toy_dataset_from_test_file,
    write_synthetic_toy_las,
)
from myria3d_tpu_torch.pctl.io.las import read_las
from myria3d_tpu_torch.utils.checkpoint import (
    convert_randlanet_state_dict,
    load_checkpoint,
    save_checkpoint,
    state_dict_from_jax,
)
from tests.myria3d_tpu_torch.test_torch_slice import _random_jax_variables

torch.set_num_threads(1)

HP = {"num_features": 9, "num_classes": 7, "widths": (16, 32, 64, 128)}
N, M_FULL = 768, 1024


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (2, N, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (2, N, 9)).astype(np.float32)
    mask = np.arange(N)[None] < np.array([[N], [500]])
    y = rng.integers(0, 7, (2, N))
    y[~mask] = 65
    return x, pos, mask, y


@pytest.fixture(scope="module")
def jax_net():
    net = jax_pn2.PointNet2(**HP)
    params, stats = _random_jax_variables(net, 256)
    return net, params, stats


def _port_net(params, stats):
    net = build_net("PointNet2", dict(HP))
    net.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return net


def test_zoo_builds_both_families():
    # the JAX package's families first, then the port's own Point Transformers
    assert [c.__name__ for c in MODEL_ZOO] == ([c.__name__ for c in JAX_ZOO]
                                               + ["PointTransformerSeg", "PointTransformerV3Seg"])
    assert get_neural_net_class("PointNet2") is PointNet2
    assert get_neural_net_class("RandLA") is RandLANet
    with pytest.raises(KeyError):
        get_neural_net_class("DGCNN")
    net = build_net("PointNet2", {"num_features": 9, "num_classes": 7, "return_logits": True,
                                  "dtype": "float32"})
    # the full width: 737,767 numbers with the BN running stats
    assert sum(v.numel() for v in net.state_dict().values()) == 737_767
    # the compute dtype and log-softmax outputs are ported
    # (test_torch_mixed_precision.py, test_torch_log_softmax.py); what the
    # JAX package refuses raises
    for good in ({"dtype": "bfloat16"}, {"return_logits": False}):
        build_net("PointNet2", {**HP, **good})
    for bad, exc in (({"dtype": "float64"}, ValueError), ({"remat": True}, TypeError)):
        with pytest.raises(exc):
            build_net("PointNet2", {**HP, **bad})


def test_eval_forward_and_interp_step_match_jax(jax_net, jax_search_on_its_kernel):
    """The eval forward, then the predict step's interpolation of its logits
    to the full clouds (``model.py:372-396``; on the CPU JAX takes its
    two-op f32 path, here on its own search kernel)."""
    jnet, params, stats = jax_net
    x, pos, mask, _ = _batch()
    rng = np.random.default_rng(3)
    full_pos = rng.uniform(-1, 1, (2, M_FULL, 3)).astype(np.float32)
    full_mask = np.arange(M_FULL)[None] < np.array([[M_FULL], [700]])
    jax_search_on_its_kernel()

    @jax.jit
    def jax_step(x, pos, mask, full_pos, full_mask):
        logits = jnet.apply({"params": params, "batch_stats": stats}, x, pos, mask, train=False)
        full = jax_knn_interpolate(logits, pos, mask, full_pos, full_mask, k=10)
        return logits, full.astype(jnp.float16)

    want, want_full = (np.asarray(a) for a in jax_step(
        *(jnp.asarray(a) for a in (x, pos, mask, full_pos, full_mask))))
    net = _port_net(params, stats)
    model = Model(net, interpolation_k=10).eval()
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in (x, pos, mask))).numpy()
    scale = np.abs(want[mask]).max()
    assert np.abs(got[mask] - want[mask]).max() <= 1e-4 * scale
    np.testing.assert_array_equal(got[mask].argmax(-1), want[mask].argmax(-1))
    assert np.isfinite(got[mask]).all()

    full = model.interp_step(*(torch.from_numpy(a) for a in
                               (x, pos, mask, pos, full_pos, full_mask)))
    assert full.dtype == torch.float16 and full.shape == (2, M_FULL, 7)
    # one f16 rounding of values whose f32 sums differ at 1e-6 of the
    # logits' scale (below f16's normal range its steps are absolute)
    want_full = want_full.astype(np.float32)
    np.testing.assert_allclose(full.float().numpy(), want_full, rtol=2**-10,
                               atol=1e-6 * np.abs(want_full).max())
    assert not full.float().numpy()[~full_mask].any()

    # pad garbage must not leak into valid outputs (test_pointnet2.py:38-57)
    x2, p2 = x.copy(), pos.copy()
    x2[~mask], p2[~mask] = 999.0, -777.0
    with torch.no_grad():
        got2 = net(*(torch.from_numpy(a) for a in (x2, p2, mask))).numpy()
    np.testing.assert_allclose(got2[mask], got[mask], rtol=1e-4, atol=1e-4)


def test_grad_step_matches_jax(jax_net, jax_search_on_its_kernel, monkeypatch):
    jnet, params, stats = jax_net
    x, pos, mask, y = _batch(1)
    orig = jax_pn2.SharedMLP

    def no_dropout(*args, dropout=None, **kwargs):
        return orig(*args, **kwargs)

    monkeypatch.setattr(jax_pn2, "SharedMLP", no_dropout)
    jax_search_on_its_kernel()

    def loss_fn(p):
        logits, upd = jnet.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                 jnp.asarray(pos), jnp.asarray(mask), train=True,
                                 mutable=["batch_stats"])
        return JaxCrossEntropy()(logits, jnp.asarray(y)), upd["batch_stats"]

    (loss_j, stats_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want_grads = flax_to_torch_state_dict(jax.device_get(grads_j), {})
    want_stats = flax_to_torch_state_dict({}, jax.device_get(flax.core.unfreeze(stats_j)))

    net = _port_net(params, stats)
    net.head.dropout = [0.0]
    model = Model(net)
    model.init_train_state()
    loss, logits = model.grad_step(*(torch.from_numpy(a) for a in (x, pos, y, mask)))
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-6)
    assert logits.shape == (2, N, 7)

    grads = {k: p.grad for k, p in net.named_parameters()}
    assert grads.keys() == want_grads.keys()
    top = max(float(np.abs(g).max()) for g in want_grads.values())
    bn_fed = {f"{k.rsplit('.', 3)[0]}.lins.{k.split('.')[-2]}.bias"
              for k in want_stats if k.endswith("running_mean")}
    for k, g in grads.items():
        want = torch.from_numpy(np.array(want_grads[k], dtype=np.float32))
        err = float((g - want).abs().max())
        if k in bn_fed:       # analytically zero
            assert err <= 1e-6 * top, k
            continue
        assert err <= 1e-4 * float(want.abs().max()), k
        a, b = g.double().flatten(), want.double().flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= 0.9999, (k, cos)
    state = net.state_dict()
    assert want_stats.keys() <= state.keys()
    for k, want in want_stats.items():
        np.testing.assert_allclose(state[k].numpy(), want, rtol=1e-5, atol=1e-5, err_msg=k)


def test_weights_carry_both_ways_and_load_checkpoint_builds_pointnet2(jax_net, tmp_path):
    _, params, stats = jax_net
    net = _port_net(params, stats)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    back_params, back_stats = convert_randlanet_state_dict(sd, params, stats)
    for got, want in ((back_params, params), (back_stats, stats)):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_got:
            np.testing.assert_array_equal(leaf, np.asarray(flat_want[path]), err_msg=str(path))

    model = build_model("PointNet2", dict(HP), interpolation_k=7)
    model.net.load_state_dict(net.state_dict(), strict=True)
    ckpt = model.save_checkpoint(str(tmp_path / "ckpt"))
    loaded = load_checkpoint(ckpt)
    assert isinstance(loaded.net, PointNet2) and not loaded.training
    assert loaded.interpolation_k == 7 and loaded.interp_window == 0
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.net.state_dict()[k], v), k
    # a bare state dict + hparams directory (save_checkpoint) loads the same
    save_checkpoint(str(tmp_path / "bare"), net.state_dict(),
                    {"neural_net_class_name": "PointNet2", "neural_net_hparams": HP})
    assert isinstance(load_checkpoint(str(tmp_path / "bare")).net, PointNet2)
    loaded.set_sorted_window(4608)      # a net without a window: the step's alone
    assert loaded.interp_window == 4608 and not hasattr(loaded.net, "knn_window")


def test_interp_window_lives_on_the_model(monkeypatch):
    """The full-cloud search's window is the ``Model``'s (``model.py:95-97``):
    a full scan until ``set_sorted_window``, whatever window a RandLA-Net's
    training hparams give its own searches (its clouds are sorted inside
    the net, the full clouds only by the predict pipeline)."""
    from myria3d_tpu_torch.models import model as model_mod
    from myria3d_tpu_torch.ops.cuda_knn import stage_window

    seen = []
    monkeypatch.setattr(model_mod, "knn_interpolate",
                        lambda *a, **kw: seen.append(kw["window"]) or torch.zeros(1))
    n = 256
    args = (torch.rand(1, n, 9), torch.rand(1, n, 3), torch.ones(1, n, dtype=torch.bool),
            torch.rand(1, n, 3), torch.rand(1, 300, 3), torch.ones(1, 300, dtype=torch.bool))
    for name, hp in (("RandLANet", {"knn_window": 4608, "sort_inputs": True}),
                     ("PointNet2", {"widths": (16, 32, 64, 128)})):
        model = build_model(name, {"num_features": 9, "num_classes": 7, **hp})
        model.interp_step(*args)
        model.set_sorted_window(4608)
        model.interp_step(*args)
        assert seen[-2:] == [0, stage_window(4608, n)], name


@pytest.fixture(scope="module")
def small_toy(tmp_path_factory):
    """A 6 000-point toy tile and its three-split HDF5 (50 m subtiles of
    ~1 500 points)."""
    d = tmp_path_factory.mktemp("pn2_toy")
    las = write_synthetic_toy_las(str(d / "toy.las"), n_points=6000)
    return las, make_toy_dataset_from_test_file(str(d / "toy.hdf5"), las)


def test_fit_then_predict_through_the_cli(small_toy, tmp_path, monkeypatch):
    """``model=pointnet2_model``: ``fit`` (one train step, then the full-cloud
    test on the checkpoint it kept) and ``predict`` with that checkpoint,
    on the CPU."""
    monkeypatch.chdir(tmp_path)     # fit and predict enter their run directories
    las, hdf5 = small_toy
    run_dir = tmp_path / "run"
    trainer = run.main(["task.task_name=fit", "experiment=RandLaNetDebug", "model=pointnet2_model",
                        "dataset_description=toy_synthetic", "logger=csv",
                        "trainer.accelerator=cpu", f"datamodule.hdf5_file_path={hdf5}",
                        "datamodule.num_workers=1", f"hydra.run.dir={run_dir}"])
    assert trainer.global_step == 1 and np.isfinite(trainer.train_losses).all()
    ckpt = run_dir / "checkpoints" / "last"
    hparams = json.loads((ckpt / "hparams.json").read_text())
    assert hparams["neural_net_class_name"] == "PointNet2"
    outs = run.main(["task.task_name=predict", f"predict.src_las={las}",
                     f"predict.ckpt_path={ckpt}", f"predict.output_dir={tmp_path / 'out'}",
                     "datamodule.batch_size=2", "trainer.accelerator=cpu"])
    src, res = read_las(las).points, read_las(outs[0]).points
    assert len(res) == len(src) and os.path.isfile(outs[0])
    names = ["unclassified", "ground", "vegetation", "building", "water", "bridge",
             "lasting_above"]
    probas = np.stack([np.asarray(res[c], np.float64) for c in names], axis=1)
    sums = probas.sum(1)
    assert np.isfinite(probas).all() and ((np.abs(sums - 1) < 1e-3) | (sums == 0)).all()
    assert (np.abs(sums - 1) < 1e-3).mean() > 0.9
