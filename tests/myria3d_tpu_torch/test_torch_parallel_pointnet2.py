"""PointNet++ under data parallelism (``parallel/ddp.py``) held against the
JAX mesh step (``myria3d_tpu/parallel/mesh.py``) on the CPU, as
``test_torch_parallel.py`` holds RandLA-Net.

One train step of PointNet++ at narrow widths (16/32/64/128, 8 neighbours,
N=768, the second cloud 500 valid points) from the same randomly
initialised JAX variables (random BN affines and running stats): the port
runs two gloo ranks under DDP, one cloud each (``parallel.spawn``), the JAX
package ``sharded_train_step`` on a 2-device CPU mesh, with sync BN
(``sync_bn=True``: moments over both ranks' clouds) and local BN
(``sync_bn=False``). The JAX step runs SGD at learning rate 1, so its
gradient is the parameters' change; the port's is ``.grad`` after DDP's
reduction. The head's dropout is off on both sides. JAX's searches rank
by the squared differences summed in the port's order (an exact jnp scan
in place of its kernel: the kernel's interpret mode cannot run inside the
local-BN step's ``shard_map``), so both sides select the same neighbours
and weigh them alike. FPS and the ball query work per cloud and
need no collective; DDP runs with ``find_unused_parameters=False`` (every
parameter of the tree gets a gradient). Tolerances: loss 1e-5 relative and
BN running stats rtol 1e-4 / atol 1e-5 (``test_torch_parallel.py``'s);
each gradient's cosine against JAX's at least 0.999 where it is not
analytically zero (the Linear biases that feed a BatchNorm), the bar of
``chip_smoke.py`` phase 15. Not ``test_torch_parallel.py``'s bar on each
entry (1e-3 of its tensor's largest): under sync BN the moments are summed
rank by rank, which moves a BN output near 0 across the LeakyReLU's kink
at one point of the head (its slope 1 against 0.2), and that one point's
row of every gradient upstream moves by up to 1 % of the tensor's largest
entry (the port's own one-process step differs from its DDP step the same
way). Both ranks must end with the same gradients and stats.

Then ``python -m myria3d_tpu_torch.run task.task_name=fit
model=pointnet2_model trainer.devices=2 trainer.accelerator=cpu``: two
ranks fit and test through the CLI. Every multi-process run has a timeout.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import myria3d_tpu.models.modules.pointnet2 as jax_pn2
from myria3d_tpu.models.model import Model as JaxModel
from myria3d_tpu.ops import pallas_knn
from myria3d_tpu.parallel.mesh import make_mesh, replicate_to_mesh, shard_batch, sharded_train_step
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch.models.model import Model, build_net
from myria3d_tpu_torch.parallel import ParallelSteps, ddp, spawn
from myria3d_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.myria3d_tpu_torch.test_torch_parallel_trainer import _cli, _common, _last, _metrics
from tests.myria3d_tpu_torch.test_torch_slice import _random_jax_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RANKS_TIMEOUT = 240
HP = {"num_features": 9, "num_classes": 7, "num_neighbors": 8, "widths": (16, 32, 64, 128)}
N = 768


def _batch():
    rng = np.random.default_rng(11)
    pos = rng.uniform(-1, 1, (2, N, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (2, N, 9)).astype(np.float32)
    mask = np.arange(N)[None] < np.array([[N], [500]])
    y = rng.integers(0, 7, (2, N))
    y[~mask] = 65
    return x, pos, mask, y


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX mesh step on 2 CPU devices with sync and local BN: loss,
    gradients (SGD at lr 1) and BN stats as torch state-dict entries."""
    x, pos, mask, y = _batch()
    batch = {"x": x, "pos": pos, "y": y.astype(np.int32), "mask": mask}
    model = JaxModel("PointNet2", {**HP, "return_logits": True}, lr=1.0,
                     optimizer=lambda lr: optax.sgd(lr))
    mesh = make_mesh(2)
    out = {}
    orig_mlp = jax_pn2.SharedMLP

    def no_dropout(*args, dropout=None, **kwargs):
        return orig_mlp(*args, **kwargs)

    def exact_scan(q4, k4, k, window=0, **_):
        # the port's K1 plain association: w^2, then dx^2, dy^2, dz^2
        assert window == 0
        s = (k4[:, None, :, 3] * k4[:, None, :, 3])
        for c in range(3):
            d = q4[:, :, None, c] - k4[:, None, :, c]
            s = s + d * d
        neg, idx = jax.lax.top_k(-s, k)
        return idx.astype(jnp.int32), -neg

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pn2, "SharedMLP", no_dropout)
        mp.setattr(pallas_knn, "knn_pallas_available", lambda k, nk: True)
        mp.setattr(pallas_knn, "knn_topk_pallas", exact_scan)
        jax.clear_caches()
        params, stats = _random_jax_variables(model.net, 256)
        state0 = model.init_state(jax.random.PRNGKey(0), batch).replace(
            params=params, batch_stats=stats, opt_state=model.tx.init(params))
        for name, sync in (("sync", True), ("local", False)):
            state = replicate_to_mesh(jax.tree_util.tree_map(jnp.copy, state0), mesh)
            arrays = shard_batch(batch, mesh)
            new, loss, _ = sharded_train_step(model, mesh, sync_bn=sync)(
                state, arrays["x"], arrays["pos"], arrays["y"], arrays["mask"],
                jax.random.PRNGKey(1))
            grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                           params, jax.device_get(new.params))
            out[name] = dict(loss=float(loss), grads=flax_to_torch_state_dict(grads, {}),
                             stats=flax_to_torch_state_dict({}, jax.device_get(new.batch_stats)))
    jax.clear_caches()
    out["state_dict"] = state_dict_from_jax(params, stats)
    out["batch"] = (x, pos, mask, y)
    return out


def _rank_step(out_dir, state_dict, batch, sync_bn):
    """One rank's DDP grad step on its cloud: writes its loss, gradients and
    BN buffers to ``out_dir/rank<r>.pt``."""
    torch.set_num_threads(1)
    r = ddp.rank()
    x, pos, mask, y = (torch.from_numpy(np.ascontiguousarray(a[r:r + 1])) for a in batch)
    net = build_net("PointNet2", dict(HP))
    net.load_state_dict(state_dict, strict=True)
    net.head.dropout = [0.0]
    model = Model(net, lr=1.0)
    model.init_train_state()
    loss, _ = ParallelSteps(model, sync_bn=sync_bn).grad_step(x, pos, y, mask)
    torch.save({"loss": float(loss), "bytes": ddp.all_reduce.bytes,
                "grads": {k: p.grad for k, p in net.named_parameters()},
                "stats": {k: b for k, b in net.named_buffers()}},
               os.path.join(out_dir, f"rank{r}.pt"))


@pytest.mark.parametrize("sync_bn", [True, False])
def test_pointnet2_ddp_step_matches_the_jax_mesh_step(jax_steps, tmp_path, monkeypatch, sync_bn):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # one core a rank
    spawn(_rank_step, ["cpu", "cpu"],
          args=(str(tmp_path), jax_steps["state_dict"], jax_steps["batch"], sync_bn),
          timeout=RANKS_TIMEOUT)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2)]
    want = jax_steps["sync" if sync_bn else "local"]
    got = ranks[0]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    for k in got["grads"]:       # DDP left the same gradients on both ranks
        torch.testing.assert_close(ranks[1]["grads"][k], got["grads"][k], rtol=0, atol=0)
    for k in got["stats"]:
        torch.testing.assert_close(ranks[1]["stats"][k], got["stats"][k], rtol=0, atol=0)
    assert got["grads"].keys() == want["grads"].keys()
    bn_fed = {k.replace("norms", "lins").replace("running_mean", "bias")
              for k in want["stats"] if k.endswith("running_mean")}
    for k, g in got["grads"].items():
        if k in bn_fed:
            continue
        a, b = g.double().flatten(), torch.from_numpy(np.asarray(want["grads"][k], np.float64)).flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= 0.999, (k, cos)
    assert got["stats"].keys() == want["stats"].keys()
    for k, st in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k].numpy(), st, rtol=1e-4, atol=1e-5, err_msg=k)
    # every parameter had a gradient to reduce (find_unused_parameters=False)
    assert all(g is not None for g in ranks[0]["grads"].values())
    if sync_bn:   # the BN moments' sums went over the ranks
        assert ranks[0]["bytes"] > 0


def test_two_rank_pointnet2_fit_and_test_through_the_cli(tmp_path, toy_dataset_hdf5_path):
    fit = tmp_path / "fit"
    _cli(["task.task_name=fit", "model=pointnet2_model", "trainer.devices=2",
          *_common(toy_dataset_hdf5_path, fit)], REPO)
    ckpt = fit / "checkpoints" / "last"
    assert {"state_dict.npz", "hparams.json", "train_state.pt"} <= set(os.listdir(ckpt))
    rows = _metrics(fit)
    assert np.isfinite(_last(rows, "train/loss_step")) and 0.0 <= _last(rows, "test/iou") <= 1.0
    code = ("import json, sys; from myria3d_tpu_torch.utils.checkpoint import load_checkpoint; "
            "print(type(load_checkpoint(sys.argv[1]).net).__name__)")
    out = subprocess.run([sys.executable, "-c", code, str(ckpt)], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert out.stdout.strip() == "PointNet2", out.stderr[-2000:]
