"""Data parallelism of the port (``parallel/ddp.py``) held against the JAX
mesh step (``myria3d_tpu/parallel/mesh.py``) on the CPU.

One train step of the full-width RandLA-Net (the train slice's net and
clouds: 32/128/256/512, K=16, decimation 4, BN momentum 0.2) from the same
JAX variables (the train slice's: random BN affines and running stats):
the port runs two gloo ranks under DDP, one cloud each
(``parallel.spawn``), the JAX package ``sharded_train_step`` on a 2-device
CPU mesh. Sync BN on both train routes of the port against
``sync_bn=True``; local BN against ``sync_bn=False``, and one cloud over two
ranks, where the second rank holds filler rows only and is left out of the
local-BN means, on the unfused route; on the fused route, against the mean
of the port's one-process steps of the real ranks (one cloud a rank puts the
fused route's raw-moment variance outside the bar, in one process too). The JAX step runs SGD at learning rate 1, so its gradient
is the parameters' change; the port's is ``.grad`` after DDP's reduction.
Decimation is deterministic and dropout off on both sides, as in the train
slice (``test_torch_train_slice.py``), whose tolerances hold here: loss 1e-5
relative, every gradient within 1e-3 of its tensor's largest entry plus
1e-5 of the net's largest, BN running stats rtol 1e-4 / atol 1e-5. Both
ranks must end with the same gradients and stats.

Also the data-parallel interpolation step over two CPU replicas against
the one-device step (same tolerance), predict over ``[cpu, cpu]`` against
predict on the CPU, and ``pad_rows`` against the JAX function. Every
multi-process test joins its ranks with a timeout and stops them.
"""

import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import myria3d_tpu.models.modules.randla_net as jax_rl
import myria3d_tpu_torch.models.modules.randla_net as port_rl
from myria3d_tpu.models.model import Model as JaxModel
from myria3d_tpu.parallel.mesh import _row_fill_value as jax_fill
from myria3d_tpu.parallel.mesh import make_mesh, replicate_to_mesh, shard_batch, sharded_train_step
from myria3d_tpu.parallel.mesh import pad_rows as jax_pad_rows
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch.models.model import Model, build_net
from myria3d_tpu_torch.parallel import ParallelSteps, ddp, spawn
from myria3d_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.myria3d_tpu_torch.test_torch_slice import (
    _jax_det_decimation,
    _port_det_decimation,
    _random_jax_variables,
)
from tests.myria3d_tpu_torch.test_torch_train_slice import HPARAMS, N, _batch, _NoDropout

torch.set_num_threads(1)

RANKS_TIMEOUT = 240   # seconds for two ranks to start, step and exit
CPU2 = ["cpu", "cpu"]


def _jax_model():
    return JaxModel("RandLANet", {**HPARAMS, "fused_train_lfa": False, "return_logits": True},
                    lr=1.0, optimizer=lambda lr: optax.sgd(lr))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX mesh step on 2 CPU devices: sync BN and local BN on the
    two-cloud batch, local BN on its first cloud alone (padded to 2 rows).
    Loss, gradients (SGD at lr 1: params minus new params) and BN stats,
    as torch state-dict entries."""
    x, pos, mask, y = _batch()
    full = {"x": x, "pos": pos, "y": y.astype(np.int32), "mask": mask}
    one = {k: v[:1] for k, v in full.items()}
    model = _jax_model()
    mesh = make_mesh(2)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rl, "random_decimation", _jax_det_decimation)
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        # the train slice's variables (random BN affines and running stats)
        params, stats = _random_jax_variables(model.net, N)
        state0 = model.init_state(jax.random.PRNGKey(0), full).replace(
            params=params, batch_stats=stats, opt_state=model.tx.init(params))
        local = sharded_train_step(model, mesh, sync_bn=False)
        for name, step, batch in (("sync", sharded_train_step(model, mesh, sync_bn=True), full),
                                  ("local", local, full), ("filler", local, one)):
            state = replicate_to_mesh(jax.tree_util.tree_map(jnp.copy, state0), mesh)
            arrays = shard_batch(batch, mesh)
            assert arrays["x"].shape[0] == 2
            new, loss, _ = step(state, arrays["x"], arrays["pos"], arrays["y"], arrays["mask"],
                                jax.random.PRNGKey(1))
            new_params = jax.device_get(new.params)
            grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                           params, new_params)
            out[name] = dict(loss=float(loss), grads=flax_to_torch_state_dict(grads, {}),
                             stats=flax_to_torch_state_dict({}, jax.device_get(new.batch_stats)))
    jax.clear_caches()
    out["state_dict"] = state_dict_from_jax(params, stats)
    out["batch"] = (x, pos, mask, y)
    return out


def _rank_step(out_dir, state_dict, batch, fused, sync_bn):
    """One rank's DDP grad step on its row of ``batch``: writes its loss,
    gradients and BN buffers to ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    port_rl.random_decimation = _port_det_decimation
    r = ddp.rank()
    x, pos, mask, y = (torch.from_numpy(np.ascontiguousarray(a[r:r + 1])) for a in batch)
    net = build_net("RandLANet", {**HPARAMS, "fused_train_lfa": fused})
    net.load_state_dict(state_dict, strict=True)
    net.mlp_classif.dropout = [0.0, 0.0]
    model = Model(net, lr=1.0)
    model.init_train_state()
    loss, _ = ParallelSteps(model, sync_bn=sync_bn).grad_step(x, pos, y, mask)
    torch.save({"loss": float(loss), "bytes": ddp.all_reduce.bytes,
                "grads": {k: p.grad for k, p in net.named_parameters()},
                "stats": {k: b for k, b in net.named_buffers()}},
               os.path.join(out_dir, f"rank{r}.pt"))


def _check(ranks, want):
    got = ranks[0]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    for k in got["grads"]:       # DDP left the same gradients on both ranks
        torch.testing.assert_close(ranks[1]["grads"][k], got["grads"][k], rtol=0, atol=0)
    for k in got["stats"]:
        torch.testing.assert_close(ranks[1]["stats"][k], got["stats"][k], rtol=0, atol=0)
    want_grads = want["grads"]
    assert got["grads"].keys() == want_grads.keys()
    top = max(float(np.abs(g).max()) for g in want_grads.values())
    for k, g in got["grads"].items():
        tol = 1e-3 * float(np.abs(want_grads[k]).max()) + 1e-5 * top
        assert float((g - torch.from_numpy(np.array(want_grads[k]))).abs().max()) <= tol, k
    assert got["stats"].keys() == want["stats"].keys()
    for k, s in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k].numpy(), s, rtol=1e-4, atol=1e-5, err_msg=k)


def _run_ranks(tmp_path, jax_steps, batch, fused, sync_bn):
    os.environ.setdefault("OMP_NUM_THREADS", "1")   # one core a rank
    spawn(_rank_step, CPU2, args=(str(tmp_path), jax_steps["state_dict"], batch, fused, sync_bn),
          timeout=RANKS_TIMEOUT)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2)]


@pytest.mark.parametrize("fused", [False, True])
def test_sync_bn_step_matches_the_jax_mesh_step(jax_steps, tmp_path, fused):
    ranks = _run_ranks(tmp_path, jax_steps, jax_steps["batch"], fused, sync_bn=True)
    _check(ranks, jax_steps["sync"])
    # the BN moments' sums went over the ranks (gradients go through DDP)
    assert ranks[0]["bytes"] > 0


def test_local_bn_step_matches_the_jax_mesh_step(jax_steps, tmp_path):
    _check(_run_ranks(tmp_path, jax_steps, jax_steps["batch"], False, sync_bn=False),
           jax_steps["local"])


def _filler_batch(jax_steps):
    """The first cloud and the filler row ``pad_rows`` adds for rank 1."""
    return tuple(ddp.pad_rows(a[:1], 2, ddp._row_fill_value(k, a.dtype))
                 for k, a in zip(("x", "pos", "mask", "y"), jax_steps["batch"]))


def test_filler_only_rank_is_left_out_of_the_local_bn_means(jax_steps, tmp_path):
    """One cloud over two ranks: rank 1 holds a filler row, and the step
    equals the JAX step on the padded batch, whose shard of filler rows
    weighs 0 (``test_parallel_padding.py:132``)."""
    batch = _filler_batch(jax_steps)
    assert not batch[2][1].any() and (batch[3][1] == 65).all()
    _check(_run_ranks(tmp_path, jax_steps, batch, False, sync_bn=False), jax_steps["filler"])


def _one_rank_step(state_dict, batch, rows):
    """The port's one-process fused grad step on ``rows``: loss, gradients
    and BN buffers."""
    x, pos, mask, y = (torch.from_numpy(np.ascontiguousarray(a[rows])) for a in batch)
    net = build_net("RandLANet", {**HPARAMS, "fused_train_lfa": True})
    net.load_state_dict(state_dict, strict=True)
    net.mlp_classif.dropout = [0.0, 0.0]
    model = Model(net)
    model.init_train_state()
    loss, _ = model.grad_step(x, pos, y, mask)
    return (float(loss), {k: p.grad.numpy() for k, p in net.named_parameters()},
            {k: b.numpy() for k, b in net.named_buffers()})


@pytest.mark.parametrize("filler", [False, True])
def test_local_bn_fused_route_is_the_mean_of_the_real_ranks_steps(jax_steps, tmp_path,
                                                                 monkeypatch, filler):
    """The fused route under local BN against the mean of the port's
    one-process steps on each real rank's cloud. (Against JAX it misses the
    train slice's bar on one cloud, in one process as well: block 4's
    LocSE encoder BN, ~20 points a cloud, takes the fused route's raw
    second-moment variance; ``ROADMAP.md`` Queue 3.)"""
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    batch = _filler_batch(jax_steps) if filler else jax_steps["batch"]
    steps = [_one_rank_step(jax_steps["state_dict"], batch, slice(r, r + 1))
             for r in range(1 if filler else 2)]
    want = {"loss": np.mean([s[0] for s in steps]),
            "grads": {k: np.mean([s[1][k] for s in steps], axis=0) for k in steps[0][1]},
            "stats": {k: np.mean([s[2][k] for s in steps], axis=0) for k in steps[0][2]}}
    _check(_run_ranks(tmp_path, jax_steps, batch, True, sync_bn=False), want)


def _rank_accumulate(out_dir, state_dict, batch):
    """Local BN, unfused: (A) ``accumulate_grad_batches=2``, the rank's cloud
    twice, the gradients after each batch; (B) ``grad_microbatch=1`` on the
    rank's two clouds (its own first), the gradients after the step."""
    torch.set_num_threads(1)
    port_rl.random_decimation = _port_det_decimation
    r = ddp.rank()
    out = {}
    for part, rows, kw in (("A", [r], {"accumulate_grad_batches": 2}),
                           ("B", [r, 1 - r], {"grad_microbatch": 1})):
        x, pos, mask, y = (torch.from_numpy(np.ascontiguousarray(a[rows])) for a in batch)
        net = build_net("RandLANet", {**HPARAMS, "fused_train_lfa": False})
        net.load_state_dict(state_dict, strict=True)
        net.mlp_classif.dropout = [0.0, 0.0]
        model = Model(net, **kw)
        model.init_train_state()
        par = ParallelSteps(model, sync_bn=False)
        grads = []
        for _ in range(2 if part == "A" else 1):
            par.grad_step(x, pos, y, mask)
            model.accum += 1
            grads.append({k: p.grad.clone() for k, p in net.named_parameters()})
        out[part] = grads
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))


def test_ddp_reduces_once_per_accumulation_group_and_microbatched_step(jax_steps, tmp_path,
                                                                       monkeypatch):
    """The backward that completes an accumulation group (its last chunk)
    all-reduces the gradients, the others run under ``no_sync``: after the
    first of two accumulated batches each rank holds its own gradient, after
    the second both hold the mean over the ranks of their sums; a step
    microbatched over each rank's two clouds gives the mean of the ranks'
    one-process microbatched steps."""
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sd, batch = jax_steps["state_dict"], jax_steps["batch"]
    spawn(_rank_accumulate, CPU2, args=(str(tmp_path), sd, batch), timeout=RANKS_TIMEOUT)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2)]

    def one_process(rows, **kw):
        x, pos, mask, y = (torch.from_numpy(np.ascontiguousarray(a[rows])) for a in batch)
        net = build_net("RandLANet", {**HPARAMS, "fused_train_lfa": False})
        net.load_state_dict(sd, strict=True)
        net.mlp_classif.dropout = [0.0, 0.0]
        model = Model(net, **kw)
        model.init_train_state()
        model.grad_step(x, pos, y, mask)
        return {k: p.grad.numpy() for k, p in net.named_parameters()}

    def close(got, want):
        top = max(float(np.abs(g).max()) for g in want.values())
        for k, g in got.items():
            tol = 1e-3 * float(np.abs(want[k]).max()) + 1e-5 * top
            assert float((g - torch.from_numpy(want[k])).abs().max()) <= tol, k

    halves = [one_process([r], accumulate_grad_batches=2) for r in range(2)]
    for r in range(2):       # not reduced yet: the rank's own half gradient
        close(ranks[r]["A"][0], halves[r])
    assert not torch.equal(ranks[0]["A"][0]["fc_classif.weight"], ranks[1]["A"][0]["fc_classif.weight"])
    for r in range(2):       # reduced once: the mean of the ranks' sums
        close(ranks[r]["A"][1], {k: halves[0][k] + halves[1][k] for k in halves[0]})
    micro = [one_process([r, 1 - r], grad_microbatch=1) for r in range(2)]
    for r in range(2):
        close(ranks[r]["B"][0], {k: (micro[0][k] + micro[1][k]) / 2 for k in micro[0]})


def test_interp_step_over_two_replicas_matches_one_device(monkeypatch):
    """Three clouds padded to four rows, split over two CPU replicas, against
    the one-device step on the three clouds."""
    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    rng = np.random.default_rng(5)
    b, m = 3, 1600
    x, pos, mask, _ = _batch()
    x, pos, mask = (np.concatenate([a, a[:1]])[:b] for a in (x, pos, mask))
    full_pos = rng.uniform(-10.0, 10.0, (b, m, 3)).astype(np.float32)
    full_mask = np.arange(m)[None] < np.array([[m], [1500], [900]])
    torch.manual_seed(0)
    model = Model(build_net("RandLANet", HPARAMS)).eval()
    arrays = {"x": x, "pos": pos, "mask": mask, "sampled_pos": pos, "full_pos": full_pos,
              "full_mask": full_mask}
    want = model.interp_step(*(torch.from_numpy(arrays[k]) for k in arrays),
                             torch.Generator().manual_seed(3))
    par = ddp.auto_parallel(model, b, CPU2)
    assert par is not None and par.batch_multiple == 2 and par.replicas[1] is not model
    placed = par.place_batch(arrays)
    assert placed["x"].shape[0] == 4 and not placed["mask"][3].any()
    got = par.interp_step(*placed.values(), torch.Generator().manual_seed(3))
    assert got.shape == (4, m, 7) and got.dtype == torch.float16
    np.testing.assert_allclose(got[:b].float().numpy(), want.float().numpy(),
                               rtol=1e-4, atol=1e-5)
    # one replica per row at most, and none for one device
    assert len(ddp.auto_parallel(model, 3, CPU2 * 2).replicas) == 3
    assert ddp.auto_parallel(model, 1, CPU2) is None
    assert ddp.auto_parallel(model, 4, "auto") is None


def test_predict_over_two_replicas_matches_one_device(tmp_path, monkeypatch):
    """``predict(config, devices=["cpu", "cpu"])`` on a 4-subtile tile at
    batch 3 (rows padded to 4, then 2 a replica): the same classes and
    probabilities as ``predict(config, device="cpu")``."""
    from myria3d_tpu.pctl.dataset.toy_dataset import write_synthetic_toy_las
    from myria3d_tpu_torch import predict as predict_mod
    from myria3d_tpu_torch import run
    from myria3d_tpu_torch.pctl.io.las import read_las

    monkeypatch.setattr(port_rl, "random_decimation", _port_det_decimation)
    tile = write_synthetic_toy_las(str(tmp_path / "tile.las"), n_points=6000)
    ckpt = os.path.join(os.path.dirname(__file__), "..", "..", "trained_model_assets",
                        "randlanet_toy_V0.5.0_torch")
    outs = {}
    for name, kw in (("one", {"device": "cpu"}), ("two", {"devices": CPU2})):
        cfg = run.compose_config(run.CONFIG_DIR, "config.yaml", [
            "task.task_name=predict", f"predict.src_las={tile}", f"predict.ckpt_path={ckpt}",
            f"predict.output_dir={tmp_path / name}", "datamodule.batch_size=3"])
        outs[name] = read_las(predict_mod.predict(cfg, **kw)).points
    classes = list(cfg["predict"]["interpolator"]["classification_dict"].values())
    one, two = outs["one"], outs["two"]
    assert len(one) == len(two) == 6000
    agree = float((np.asarray(one["PredictedClassification"])
                   == np.asarray(two["PredictedClassification"])).mean())
    assert agree >= 0.999
    for c in classes:
        np.testing.assert_allclose(np.asarray(two[c], np.float64), np.asarray(one[c], np.float64),
                                   atol=2e-3)


@pytest.mark.parametrize("key, dtype", [("y", np.int32), ("full_y", np.int32), ("mask", bool),
                                        ("full_mask", bool), ("pos", np.float32),
                                        ("x", np.float32), ("idx", np.int64)])
def test_pad_rows_matches_the_jax_function(key, dtype):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 7, (3, 5)).astype(dtype)
    fill = ddp._row_fill_value(key, np.dtype(dtype))
    assert fill == jax_fill(key, np.dtype(dtype)) and type(fill) is type(jax_fill(key, np.dtype(dtype)))
    for multiple in (1, 2, 3, 4, 8):
        got, want = ddp.pad_rows(a, multiple, fill), jax_pad_rows(a, multiple, fill)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert ddp.pad_rows(a, 3) is a


def test_backend_rule_and_rank_devices():
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    assert ddp.backend_for([c0, c1]) == "nccl"
    assert ddp.backend_for([c0]) == "nccl"
    assert ddp.backend_for([c0, c0]) == "gloo"        # two ranks share one card
    assert ddp.backend_for([cpu, cpu]) == "gloo"
    assert ddp.rank_devices(2, "cpu") == [cpu, cpu]
    assert ddp.rank_devices("auto", "cpu") == [cpu]
    assert ddp.rank_devices([0, 1], "gpu") == [c0, c1]


def _raises():
    raise ValueError("rank failed")


def _sleeps():
    import time

    time.sleep(600)


def test_spawn_raises_a_rank_failure_and_stops_hung_ranks():
    with pytest.raises(Exception, match="rank failed"):
        spawn(_raises, CPU2, timeout=RANKS_TIMEOUT)
    with pytest.raises(TimeoutError):
        spawn(_sleeps, CPU2, timeout=5)
