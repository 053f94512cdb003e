"""Data parallelism of the port: DDP training, data-parallel predict.

Port of ``myria3d_tpu/parallel/mesh.py`` in PyTorch's idiom. The JAX package
shards one process's batch over a device mesh; here training runs one
process per device under ``torch.nn.parallel.DistributedDataParallel``, and
predict splits one process's batch over replicas of the model on its local
devices.

- The process group: :func:`spawn` starts one rank per device on this node
  (``trainer.devices=N``), :func:`init_from_env` joins the group torchrun
  describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``). The backend is a rule, not a knob: NCCL when every rank
  has a CUDA device of its own, gloo otherwise (the CPU, or ranks that share
  one card, which only the tests and ``chip_smoke.py`` ask for).
- The step (:class:`ParallelSteps`, ``mesh.py:264-312``) has the semantics of
  the JAX mesh step. Sync BN (``sync_bn=True``, ``mesh.py:114-140``): BN
  moments over the global batch (``MaskedBatchNorm`` and the fused route's
  rel statistics all-reduce their sums) and the gradient of the global
  masked-CE mean: each rank differentiates its loss sum over the global
  count times the world size, and DDP's gradient mean divides that by the
  world size. Local BN (``mesh.py:152-180``): per-rank moments, and the
  mean over the ranks that hold real points of the gradients, the loss and
  the BN running stats; a rank whose rows are all filler weighs 0.
- The step's collectives are ``all_reduce`` and ``broadcast`` only, the
  two that gloo runs on CUDA tensors; :func:`all_reduce` counts the bytes
  it reduces in ``all_reduce.bytes``.
- ``pad_rows`` and ``_row_fill_value`` (``mesh.py:44-64``): filler rows
  carry ignore-coded targets and False masks, so masked losses, moments and
  metrics skip them.
"""

from __future__ import annotations

import copy
import datetime
import logging
import os
import socket
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

IGNORE_INDEX = 65   # pctl.batching.IGNORE_INDEX
# how long a collective (or the group's rendezvous) may wait for a rank
TIMEOUT = datetime.timedelta(minutes=10)

_rank_device: Optional[torch.device] = None   # the device of this process's rank


# ---------------------------------------------------------------------------
# filler rows
# ---------------------------------------------------------------------------

def _row_fill_value(key: str, dtype: np.dtype):
    """Fill of padded batch rows: targets the ignore code, masks False,
    everything else 0."""
    if key == "y" or key.endswith("_y"):
        return IGNORE_INDEX
    return False if np.issubdtype(dtype, np.bool_) else 0


def pad_rows(arr: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    """Pad the leading (batch) axis up to the next multiple with constant
    filler rows; no copy when already aligned."""
    arr = np.asarray(arr)
    b = arr.shape[0]
    target = -(-b // multiple) * multiple
    if target == b:
        return arr
    pad = np.full((target - b,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_rank_zero() -> bool:
    return rank() == 0


def device() -> torch.device:
    """This rank's device (set when the group was initialised)."""
    if _rank_device is None:
        raise RuntimeError("no process group: device() is the device of a rank")
    return _rank_device


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo."""
    devices = [torch.device(d) for d in devices]
    own = len({(d.type, d.index) for d in devices}) == len(devices)
    return "nccl" if own and all(d.type == "cuda" for d in devices) else "gloo"


def init_process_group(rank_: int, world: int, dev, init_method: str,
                       backend: Optional[str] = None) -> None:
    """Join the group as rank ``rank_`` of ``world`` on device ``dev``."""
    global _rank_device
    dev = torch.device(dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = backend or backend_for([dev])
    dist.init_process_group(backend, init_method=init_method, rank=rank_, world_size=world,
                            timeout=TIMEOUT)
    _rank_device = dev
    if rank_ == 0:
        log.info(f"Process group: {world} ranks over {backend} (NCCL when every rank has a "
                 "CUDA device of its own, gloo otherwise)")


def destroy_process_group() -> None:
    global _rank_device
    if is_initialized():
        dist.destroy_process_group()
    _rank_device = None


def launched_by_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(accelerator: str = "auto") -> None:
    """Join the group torchrun describes: rank ``RANK`` of ``WORLD_SIZE`` on
    ``cuda:LOCAL_RANK`` (the CPU for ``accelerator`` "cpu"), rendezvous at
    ``MASTER_ADDR:MASTER_PORT``."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    cpu = str(accelerator).lower() == "cpu"
    dev = torch.device("cpu") if cpu else torch.device("cuda", local)
    init_process_group(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), dev, "env://")


def rank_devices(devices: Any = "auto", accelerator: str = "auto") -> List[torch.device]:
    """One device per rank for ``trainer.devices`` on this node: "auto" is
    every CUDA device (one CPU rank for ``accelerator`` "cpu"), an int N the
    first N, a list the listed CUDA indices; on the CPU, N ranks share it."""
    cpu = str(accelerator).lower() == "cpu"
    if isinstance(devices, (list, tuple)):
        return [torch.device("cpu") if cpu else torch.device("cuda", int(i)) for i in devices]
    if devices in ("auto", None):
        n = 1 if cpu else max(1, torch.cuda.device_count())
    else:
        n = int(devices)
    if cpu:
        return [torch.device("cpu")] * n
    if n > 1 and n > torch.cuda.device_count():
        raise ValueError(f"trainer.devices={devices}: {torch.cuda.device_count()} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank_: int, fn: Callable, devices: list, init_method: str, args: tuple):
    if devices[rank_].type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # CPU ranks share the host's cores (torchrun sets OMP_NUM_THREADS)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    init_process_group(rank_, len(devices), devices[rank_], init_method, backend_for(devices))
    try:
        fn(*args)
    finally:
        destroy_process_group()


def spawn(fn: Callable, devices: Sequence, args: tuple = (), timeout: Optional[float] = None):
    """Run ``fn(*args)`` in one new process per entry of ``devices``, rank r
    on ``devices[r]`` in a group on this node (:func:`backend_for`'s
    backend; devices may repeat, then the ranks share it over gloo). ``fn``
    must be importable (it is pickled by name). Returns once every rank
    exited cleanly; raises when one raised, or after ``timeout`` seconds,
    and stops every rank still running."""
    import torch.multiprocessing as mp

    devices = [torch.device(d) for d in devices]
    ctx = mp.start_processes(_rank_entry, nprocs=len(devices), join=False, start_method="spawn",
                             args=(fn, devices, f"tcp://127.0.0.1:{free_port()}", tuple(args)))
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{len(devices)} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(10)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it (no-op without a
    group)."""
    if is_initialized():
        dist.all_reduce(t)
        all_reduce.bytes += t.numel() * t.element_size()
    return t


all_reduce.bytes = 0


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks that gradients flow through (the backward sums the
    cotangents, as ``torch.distributed.nn.functional.all_reduce``)."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone())


def all_reduce_with_grad(t: torch.Tensor) -> torch.Tensor:
    return _AllReduceSum.apply(t) if is_initialized() else t


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place (no-op without a group)."""
    if is_initialized():
        dist.broadcast(t, src)
    return t


def from_rank_zero(value: float) -> float:
    """Rank 0's ``value`` on every rank (a decision all ranks must share)."""
    if not is_initialized():
        return float(value)
    return float(broadcast(torch.tensor([float(value)], dtype=torch.float64, device=device()))[0])


def barrier() -> None:
    if is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[device().index])
        else:
            dist.barrier()


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

class ParallelSteps:
    """The data-parallel steps of one process (``mesh.py:264-312``).

    In a process group it trains under DDP, one device per rank: ``train_step``
    and ``grad_step`` are the model's, through the DDP wrapper (built at the
    first call: its construction broadcasts rank 0's parameters and buffers)
    with the reductions of the sync or local BN step. Each rank evaluates its
    own batches (the model's eval step, ``interp_step``); the callers reduce
    losses and confusion matrices over the ranks.

    Without a group it holds one replica of the model per entry of
    ``devices`` (the model itself on the first): ``interp_step`` splits the
    batch rows over the replicas, runs each replica's step on its slice and
    concatenates the rows on the first device. ``place_batch`` and
    ``pad_rows`` pad the rows to ``batch_multiple`` with filler rows.
    """

    def __init__(self, model, devices: Optional[Sequence] = None, sync_bn: bool = True):
        self.model = model
        self.sync_bn = bool(sync_bn)
        self.ddp = None
        home = next(model.net.parameters()).device
        if is_initialized():
            if devices is not None and len(devices) > 1:
                raise ValueError("one device per rank in a process group")
            self.devices = [home]
            self.replicas = [model]
        else:
            self.devices = [torch.device(d) for d in (devices or [home])]
            model.to(self.devices[0])
            self.replicas = [model] + [copy.deepcopy(model).to(d) for d in self.devices[1:]]
        self._weight = None

    @property
    def batch_multiple(self) -> int:
        """The rows ``place_batch`` pads a batch to a multiple of."""
        return len(self.replicas)

    def pad_rows(self, arr: np.ndarray, fill=0) -> np.ndarray:
        return pad_rows(arr, self.batch_multiple, fill)

    def place_batch(self, arrays: dict) -> dict:
        """Host arrays -> tensors on the first device, rows padded with
        filler rows to ``batch_multiple``."""
        return {k: torch.from_numpy(np.ascontiguousarray(
                    self.pad_rows(v, _row_fill_value(k, np.asarray(v).dtype))))
                .to(self.devices[0], non_blocking=True) for k, v in arrays.items()}

    # -- training -----------------------------------------------------------

    @property
    def grad_bytes(self) -> int:
        """Bytes DDP all-reduces a step: every parameter's gradient once."""
        return sum(p.numel() * p.element_size() for p in self.model.net.parameters()
                   if p.requires_grad)

    def _wrap(self) -> None:
        if self.ddp is not None:
            return
        if not is_initialized():
            raise RuntimeError("training is one process per device: launch the ranks with "
                               "myria3d_tpu_torch.run trainer.devices=N, or torchrun")
        from torch.nn.parallel import DistributedDataParallel

        from myria3d_tpu_torch.models.modules.nn import set_sync_batchnorm

        # broadcast_buffers=False: DDP would copy rank 0's BN buffers at every
        # forward, which is neither JAX mode; find_unused_parameters=False as
        # in the reference (ddp_find_unused_parameters_false): every
        # parameter gets a gradient on both LFA routes
        self.ddp = DistributedDataParallel(self.model.net, device_ids=None,
                                           broadcast_buffers=False,
                                           find_unused_parameters=False)
        set_sync_batchnorm(self.model.net, self.sync_bn)
        self.model.data_parallel = self

    def grad_step(self, x, pos, y, mask, generator=None):
        self._wrap()
        return self.model.grad_step(x, pos, y, mask, generator)

    def train_step(self, x, pos, y, mask, generator=None):
        self._wrap()
        return self.model.train_step(x, pos, y, mask, generator)

    # the model's grad step calls these four under DDP

    def chunks(self, rows: int, mb: int):
        """(rows a chunk, chunks) of a rank's ``rows`` under
        ``grad_microbatch`` ``mb``. Sync BN chunks the global batch of
        ``rows * world`` clouds as the JAX step does (``model.py:277-321``
        under GSPMD): k = rows * world / mb chunks, chunk i made of rows
        ``[i mb / world, (i + 1) mb / world)`` of every rank, one step when
        mb >= the global batch; a shape that cannot map so raises
        ``ValueError`` before the step runs. Local BN chunks each rank's own
        rows (the JAX local-BN step microbatches each shard)."""
        world = world_size()
        if not self.sync_bn:
            k = rows // mb if 0 < mb < rows and rows % mb == 0 else 1
            return rows // k, k
        if mb <= 0 or rows * world <= mb:
            return rows, 1
        if mb % world or rows % (mb // world):
            raise ValueError(
                f"grad_microbatch={mb} under sync BN needs chunks of mb / world rows a rank "
                f"that divide its rows: world size {world}, batch of {rows} rows a rank "
                f"({rows * world} in all)")
        return mb // world, rows * world // mb

    def begin(self, mask: torch.Tensor) -> None:
        """Local BN: this rank's weight ``w`` (1 when it holds a real point)
        and ``n_valid``, the ranks that do (at least 1)."""
        if self.sync_bn:
            self._weight = None
            return
        w = mask.any().to(torch.float32).reshape(1)
        n_valid = all_reduce(w.clone()).clamp(min=1.0)
        self._weight = (w, n_valid)

    def chunk_loss(self, criterion, logits, y):
        """(loss to differentiate, loss to report) of one chunk. Sync BN:
        the loss sum over the global count times the world size, and the
        global mean. Local BN: this rank's mean weighted ``w world /
        n_valid``, and the rank's mean."""
        world = world_size()
        if self.sync_bn:
            s, w = criterion.sum_and_weight(logits, y)
            tot = all_reduce(torch.stack([s.detach(), w]))
            n = tot[1].clamp(min=1e-12)
            return s * (world / n), tot[0] / n
        loss = criterion(logits, y)
        w, n_valid = self._weight
        return loss * (w[0] * world / n_valid[0]), loss

    def finish(self, stats: List[torch.Tensor], loss: torch.Tensor) -> torch.Tensor:
        """After the backward: local BN takes the BN running stats and the
        loss to their mean over the real ranks (``mesh.py:171-175``) and
        returns that loss; sync BN's are global already."""
        if self.sync_bn:
            return loss
        w, n_valid = self._weight
        flat = torch.cat([t.reshape(-1) for t in stats] + [loss.reshape(1)]) * w
        all_reduce(flat)
        flat /= n_valid
        parts = flat[:-1].split([t.numel() for t in stats])
        torch._foreach_copy_(stats, [p.view_as(t) for p, t in zip(parts, stats)])
        return flat[-1]

    # -- evaluation -----------------------------------------------------------

    def interp_step(self, x, pos, mask, sampled_pos, full_pos, full_mask,
                    generator: Optional[torch.Generator] = None, fused: bool = True):
        """``Model.interp_step`` with the rows split over the replicas (rows
        padded to ``batch_multiple``); each replica draws from a generator
        seeded as ``generator``, on its device."""
        if len(self.replicas) == 1:
            return self.model.interp_step(x, pos, mask, sampled_pos, full_pos, full_mask,
                                          generator, fused=fused)
        n = x.shape[0] // len(self.replicas)
        if n * len(self.replicas) != x.shape[0]:
            raise ValueError(f"{x.shape[0]} rows over {len(self.replicas)} replicas: pad_rows first")
        seed = None if generator is None else generator.initial_seed()
        outs = []
        for i, (replica, dev) in enumerate(zip(self.replicas, self.devices)):
            rows = slice(i * n, (i + 1) * n)
            gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
            args = (t[rows].to(dev, non_blocking=True)
                    for t in (x, pos, mask, sampled_pos, full_pos, full_mask))
            outs.append(replica.interp_step(*args, gen, fused=fused))
        return torch.cat([o.to(self.devices[0], non_blocking=True) for o in outs])


def local_devices(devices: Any, home: torch.device) -> List[torch.device]:
    """The replicas' devices of one process: a list as given (repeats
    allowed); "auto" every CUDA device (the CPU once, when the model is on
    it); an int N the first N CUDA devices (N times the CPU)."""
    if isinstance(devices, (list, tuple)):
        return [torch.device(d) for d in devices]
    if home.type == "cpu":
        n = 1 if devices in (None, "auto") else int(devices)
        return [home] * n
    count = torch.cuda.device_count()
    n = count if devices in (None, "auto") else min(int(devices), count)
    return [torch.device("cuda", i) for i in range(max(1, n))]


def auto_parallel(model, batch_size: int, devices: Any = "auto",
                  sync_bn: bool = True) -> Optional[ParallelSteps]:
    """``ParallelSteps`` for ``model`` (``mesh.py:314-334``): in a process
    group, DDP on this rank's device; else replicas over the local devices,
    as many as the batch has rows at most. None for one device."""
    if is_initialized():
        return model.data_parallel or ParallelSteps(model, sync_bn=sync_bn)
    home = next(model.net.parameters()).device
    devs = local_devices(devices, home)[: max(1, int(batch_size))]
    if len(devs) <= 1:
        return None
    return ParallelSteps(model, devs, sync_bn=sync_bn)
