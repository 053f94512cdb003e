"""``grad_microbatch`` under sync-BN DDP held against the JAX mesh step.

The JAX sync-BN step is GSPMD over the global batch, and its grad step
reshapes that batch into k = B / mb chunks of mb clouds
(``myria3d_tpu/models/model.py:277-321``): each chunk's BN moments and
masked-CE mean span mb clouds. The port's ranks hold B / world rows each;
under sync BN, chunk i is rows ``[i mb / world, (i + 1) mb / world)`` of
every rank, and the all-reduces inside the BN layers then cover exactly
the chunk's mb clouds (``ParallelSteps.chunks``).

Here B = 4 clouds over two gloo ranks (rank r holds rows 2r and 2r + 1 of
the grad-microbatch slice's batch: four different clouds, other valid
counts) at mb = 2: the port's chunk i is rows i of both ranks, global rows
i and 2 + i. JAX's chunk i is global rows ``[2i, 2i + 2)``, so JAX gets the
global batch in the order 0, 2, 1, 3, and both chunk the same clouds. The
order of a batch's rows carries no meaning (the loader shuffles): the step
is the same function of the same chunks.

The train slice's net and tolerances (``test_torch_parallel.py``):
deterministic decimation and no dropout on both sides, loss 1e-5 relative,
every gradient within 1e-3 of its tensor's largest entry plus 1e-5 of the
net's largest, BN running stats rtol 1e-4 / atol 1e-5; both ranks end with
the same gradients and stats. The port runs its unfused route, as the JAX
step. A shape that cannot map (mb not a multiple of the world size, or
mb / world not dividing a rank's rows) raises ``ValueError`` before the
step runs.
"""

import os

import flax.linen
import jax
import numpy as np
import optax
import pytest
import torch

import myria3d_tpu.models.modules.randla_net as jax_rl
import myria3d_tpu_torch.models.modules.randla_net as port_rl
from myria3d_tpu.models.model import Model as JaxModel
from myria3d_tpu.parallel.mesh import make_mesh, replicate_to_mesh, shard_batch, sharded_train_step
from myria3d_tpu.utils.torch_ckpt import flax_to_torch_state_dict
from myria3d_tpu_torch.models.model import Model, build_net
from myria3d_tpu_torch.parallel import ParallelSteps, ddp, spawn
from myria3d_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.myria3d_tpu_torch.test_torch_grad_microbatch import _batch as _micro_batch
from tests.myria3d_tpu_torch.test_torch_parallel import CPU2, RANKS_TIMEOUT, _check
from tests.myria3d_tpu_torch.test_torch_slice import (
    _jax_det_decimation,
    _port_det_decimation,
    _random_jax_variables,
)
from tests.myria3d_tpu_torch.test_torch_train_slice import HPARAMS, N, _NoDropout

torch.set_num_threads(1)
MB = 2
JAX_ORDER = [0, 2, 1, 3]    # JAX's chunk i = the port's chunk i (rows i of both ranks)


@pytest.fixture(scope="module")
def jax_sync_microbatched():
    """The JAX sync-BN mesh step with ``grad_microbatch=2`` on 2 CPU devices
    over the 4-cloud batch in ``JAX_ORDER``: loss, gradients (SGD at lr 1)
    and BN stats as torch state-dict entries."""
    x, pos, y, mask = _micro_batch()
    batch = {"x": x[JAX_ORDER], "pos": pos[JAX_ORDER], "y": y[JAX_ORDER].astype(np.int32),
             "mask": mask[JAX_ORDER]}
    model = JaxModel("RandLANet", {**HPARAMS, "fused_train_lfa": False, "return_logits": True},
                     lr=1.0, optimizer=lambda lr: optax.sgd(lr), grad_microbatch=MB)
    mesh = make_mesh(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rl, "random_decimation", _jax_det_decimation)
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        params, stats = _random_jax_variables(model.net, N)
        state = model.init_state(jax.random.PRNGKey(0), batch).replace(
            params=params, batch_stats=stats, opt_state=model.tx.init(params))
        state = replicate_to_mesh(state, mesh)
        arrays = shard_batch(batch, mesh)
        new, loss, _ = sharded_train_step(model, mesh, sync_bn=True)(
            state, arrays["x"], arrays["pos"], arrays["y"], arrays["mask"],
            jax.random.PRNGKey(1))
        new_params = jax.device_get(new.params)
        grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                       params, new_params)
        out = dict(loss=float(loss), grads=flax_to_torch_state_dict(grads, {}),
                   stats=flax_to_torch_state_dict({}, jax.device_get(new.batch_stats)))
    jax.clear_caches()
    out["state_dict"] = state_dict_from_jax(params, stats)
    out["batch"] = (x, pos, mask, y)
    return out


def _rank_microbatched_step(out_dir, state_dict, batch):
    """Rank r's sync-BN DDP grad step at ``grad_microbatch=2`` on rows 2r and
    2r + 1; then the same at ``grad_microbatch=3``, which must raise."""
    torch.set_num_threads(1)
    port_rl.random_decimation = _port_det_decimation
    r = ddp.rank()
    x, pos, mask, y = (torch.from_numpy(np.ascontiguousarray(a[2 * r:2 * r + 2])) for a in batch)
    out = {}
    for mb in (MB, 3):
        net = build_net("RandLANet", {**HPARAMS, "fused_train_lfa": False})
        net.load_state_dict(state_dict, strict=True)
        net.mlp_classif.dropout = [0.0, 0.0]
        model = Model(net, lr=1.0, grad_microbatch=mb)
        model.init_train_state()
        try:
            loss, _ = ParallelSteps(model, sync_bn=True).grad_step(x, pos, y, mask)
        except ValueError as e:
            out["error"] = str(e)
            continue
        out.update(loss=float(loss), grads={k: p.grad for k, p in net.named_parameters()},
                   stats={k: b for k, b in net.named_buffers()})
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))


def test_sync_bn_microbatched_step_matches_the_jax_mesh_step(jax_sync_microbatched, tmp_path):
    os.environ.setdefault("OMP_NUM_THREADS", "1")   # one core a rank
    spawn(_rank_microbatched_step, CPU2,
          args=(str(tmp_path), jax_sync_microbatched["state_dict"],
                jax_sync_microbatched["batch"]), timeout=RANKS_TIMEOUT)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2)]
    _check(ranks, jax_sync_microbatched)
    for rank in ranks:      # mb=3 cannot map onto two ranks
        assert "grad_microbatch=3" in rank["error"] and "world size 2" in rank["error"]
        assert "batch of 2 rows a rank" in rank["error"]


@pytest.mark.parametrize("rows, mb, want", [
    (2, 2, (1, 2)),      # the test above: chunk i = row i of each rank
    (16, 16, (8, 2)),    # B=32 on two ranks at mb=16: two chunks, as JAX
    (16, 8, (4, 4)),
    (2, 4, (2, 1)),      # mb = the global batch: one step
    (2, 8, (2, 1)),      # mb past the global batch: one step, as JAX
    (0, 4, (0, 1)),
    (8, 0, (8, 1)),      # no microbatching
    (2, 3, ValueError),  # mb not a multiple of the world size
    (3, 2, (1, 3)),
    (6, 4, (2, 3)),
    (3, 4, ValueError),  # mb / world does not divide the rank's rows
    (5, 4, ValueError),
])
def test_sync_bn_chunks_of_the_global_batch(monkeypatch, rows, mb, want):
    monkeypatch.setattr(ddp, "world_size", lambda: 2)
    par = ParallelSteps.__new__(ParallelSteps)
    par.sync_bn = True
    if want is ValueError:
        with pytest.raises(ValueError, match=rf"grad_microbatch={mb} .*world size 2.*batch of "
                                             rf"{rows} rows a rank"):
            par.chunks(rows, mb)
    else:
        assert par.chunks(rows, mb) == want
    par.sync_bn = False     # local BN: the rank's own chunks, never an error
    k = rows // mb if 0 < mb < rows and rows % mb == 0 else 1
    assert par.chunks(rows, mb) == (rows // k, k)
