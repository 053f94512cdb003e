"""Tile inference pipeline — port of ``myria3d_tpu/predict.py:25``.

``predict(config) -> str``: reads one LAS tile once, cooks its 50 m
subtiles on the host (the port's ``pctl``: the predict transforms, with
``SortPointsByX`` appended when ``predict.sorted_window > 0``), runs
``Model.interp_step`` on the device for each padded batch, merges the f16
full-cloud logits into the ``Interpolator`` by original point index, and
writes the output LAS (PredictedClassification, per-class probabilities,
entropy).

The device is CUDA: ``cuda:0``, or ``cuda:i`` for ``predict.gpus=[i]``; a
missing CUDA device is an error, never a CPU fallback. The CPU is taken
only when the caller asks, with ``predict(config, device="cpu")`` or
``trainer.accelerator=cpu`` in the config (the JAX package, too, ignores
``predict.gpus: 0``).

Data parallel (``myria3d_tpu/predict.py:83-107,157``): with more than one
local GPU (and no single device named), each batch's rows are padded with
filler rows to the GPU count and split over replicas of the model, one per
GPU (``parallel.auto_parallel``); the rows come back concatenated on the
first. ``predict(config, devices=[...])`` names the replicas' devices
(repeats allowed: two replicas may share a device).

``predict.compute_dtype`` (``bfloat16``, ``float16``; ``myria3d_tpu/predict.py:95-100``)
runs the forward in that dtype (``Model.set_compute_dtype``); the weights,
the logits and the interpolation stay f32.

``predict.exact_knn`` (``myria3d_tpu/predict.py:80-94``) is set after the
sorted window (``Model.set_exact_knn``): the net's searches scan every key,
and so does the interpolation's with ``predict.exact_interpolation``;
without it K3 keeps the sorted window (``models/model.py:383-389``).
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from myria3d_tpu_torch.models.interpolation import Interpolator
from myria3d_tpu_torch.parallel import auto_parallel
from myria3d_tpu_torch.pctl.batching import (
    DEFAULT_BUCKETS,
    bucket_ladder,
    pad_full_cloud,
    pad_sampled_pos,
)
from myria3d_tpu_torch.pctl.dataset.tile_stream import TileSampleStream
from myria3d_tpu_torch.pctl.dataset.utils import read_las_array
from myria3d_tpu_torch.pctl.loader import BackgroundIterator, PaddedBatchLoader
from myria3d_tpu_torch.pctl.transforms.compose import CustomCompose
from myria3d_tpu_torch.pctl.transforms.transforms import SortPointsByX
from myria3d_tpu_torch.train import port_targets
from myria3d_tpu_torch.utils.checkpoint import load_checkpoint
from myria3d_tpu_torch.utils.config import instantiate
from myria3d_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)


def predict_device(config: dict, device: Any = None) -> torch.device:
    """The device predict runs on: ``device`` when the caller names one;
    else the CPU for ``trainer.accelerator=cpu``; else the CUDA device of
    ``predict.gpus`` (``[i]`` -> ``cuda:i``, anything else ``cuda:0``),
    which must exist."""
    if device is not None:
        return torch.device(device)
    if str((config.get("trainer") or {}).get("accelerator", "auto")).lower() == "cpu":
        return torch.device("cpu")
    gpus = (config.get("predict") or {}).get("gpus", 0)
    if isinstance(gpus, (list, tuple)):
        if len(gpus) != 1:
            raise ValueError(f"predict.gpus={gpus}: one device per process")
        dev = torch.device(f"cuda:{int(gpus[0])}")
    else:
        dev = torch.device("cuda:0")
    if not torch.cuda.is_available():
        raise RuntimeError("predict runs on CUDA, but none is available (trainer.accelerator=cpu "
                           "or predict(config, device='cpu') runs on the CPU)")
    return dev


def _buckets(dm: dict, stages: list) -> tuple:
    """Padded point-count ladder under ``padded_num_points``, else the
    predict stages' MaximumNumNodes/FixedPoints cap."""
    cap = dm.get("padded_num_points")
    if not cap:
        cap = next((int(t.num) for t in stages
                    if type(t).__name__ in ("MaximumNumNodes", "FixedPoints")),
                   DEFAULT_BUCKETS[-1])
    return bucket_ladder(cap, dm.get("bucketing", True))


def tile_loader(config: dict, tile_points: np.ndarray,
                timings: Optional[dict] = None) -> PaddedBatchLoader:
    """The padded batches of ``predict.src_las``'s subtiles, cooked from
    the tile's points (``tile_points``, as :func:`read_las_array` gives
    them) by the predict transforms. ``timings`` receives the loader
    threads' cook seconds (the span ``pctl.cook``: each subtile's cook and
    each batch's collate), the tile's binning (``pctl.bin``) and the
    subtile points cooked (``cook_points``, ``cook_points_native``)."""
    pcfg, dm = config["predict"], config["datamodule"]
    # the sort and the kernels' window are switched on together, so an
    # unsorted cloud never meets a window
    transforms = port_targets(dm["transforms"])
    stages = [instantiate(t) for t in transforms["preparations_predict_list"]]
    if int(pcfg.get("sorted_window", 0) or 0) > 0:
        stages.append(SortPointsByX())
    stages += [instantiate(t) for t in transforms["normalizations_list"]]
    dataset = TileSampleStream(
        pcfg["src_las"], dm.get("epsg"),
        tile_width=dm.get("tile_width", 1000),
        subtile_width=dm.get("subtile_width", 50),
        subtile_overlap=dm.get("subtile_overlap_predict", 0),
        points_pre_transform=instantiate(port_targets(dm["points_pre_transform"])),
        pre_filter=instantiate(port_targets(dm.get("pre_filter"))),
        transform=CustomCompose(stages),
        # this pool cooks the subtiles, and paces the tile (PERF.md §5)
        workers=3,
        points=tile_points, timings=timings,
    )
    return PaddedBatchLoader(
        dataset, batch_size=dm["batch_size"], buckets=_buckets(dm, stages),
        process_index=0, process_count=1, timings=timings,
    )


def predict(config: dict, phases: Optional[dict] = None, preread=None,
            device: Any = None, devices: Optional[list] = None) -> str:
    """Predict one LAS file (``config["predict"]["src_las"]``) and return
    the output path. ``phases``, when given, receives wall-clock phase
    timings in seconds, rounded to 2 decimals, and ``n_batches``: the JAX
    package's keys, then the streaming loop's wait on the cooked-batch
    queue (``loader_wait_s``) and its host enqueue (``enqueue_s``), the
    loader threads' busy seconds (``cook_busy_s``), the tile's binning
    before the first subtile (``bin_s``), the subtile points cooked, in all
    and by the native rows-and-features call (``cook_points``,
    ``cook_points_native``), and the points merged (``merge_points``, and
    ``merge_points_native``, its equal: every merge is the native row
    scatter), and the finalize pass's seconds in its writes, averaged over
    its threads, and their count (``write_io_s``, ``write_threads``).
    Each phase is a span
    (``utils.profiling.span``): under a recording ``torch.profiler`` the
    trace shows ``predict.setup``, ``predict.read``, ``predict.stream`` and
    in it ``predict.loader_wait``, ``predict.enqueue``,
    ``predict.fetch_wait`` and ``predict.merge``, then
    ``predict.finalize.*``.
    ``preread`` optionally hands over the tile's ``(points, header)``, or a
    Future of it, read ahead by the caller.
    ``device`` overrides the device rule of :func:`predict_device`;
    ``devices`` splits the batches over replicas on those devices."""
    pcfg, dm = config["predict"], config["datamodule"]
    if devices is None and device is None and not isinstance(pcfg.get("gpus"), (list, tuple)):
        # no device named: every local GPU (the CPU stays one device)
        devices = "auto"
    device = predict_device(config, devices[0] if isinstance(devices, (list, tuple)) else device)
    src_las = pcfg["src_las"]

    sums: dict = {}
    with span("predict.setup"):
        with span("predict.read", sums):
            if preread is not None:
                tile_points, tile_header = (
                    preread.result() if hasattr(preread, "result") else preread
                )
            else:
                tile_points, tile_header = read_las_array(src_las, dm.get("epsg"))

        loader = tile_loader(config, tile_points, timings=sums)
        # the window goes with the loader's SortPointsByX
        sorted_window = int(pcfg.get("sorted_window", 0) or 0)

        model = load_checkpoint(pcfg["ckpt_path"], device)
        model.set_sorted_window(sorted_window)
        # predict.exact_knn, after the window as in myria3d_tpu/predict.py:80-94:
        # the net's searches scan every key, and so does the interpolation's on
        # the two-op path (exact_interpolation); K3 keeps the sorted window
        if pcfg.get("exact_knn"):
            model.set_exact_knn(True)
        # predict.compute_dtype: the forward's compute dtype (params and logits
        # stay f32); set before the replicas are made, so they carry it
        if pcfg.get("compute_dtype"):
            model.set_compute_dtype(pcfg["compute_dtype"])
        generator = torch.Generator(device=device).manual_seed(int(config.get("seed", 12345)))
        par = auto_parallel(model, dm["batch_size"], devices) if devices is not None else None
        if par is not None:
            log.info(f"Predicting data-parallel over {len(par.devices)} replicas")

        itp = instantiate(port_targets(pcfg["interpolator"]))
        if not isinstance(itp, Interpolator):
            raise TypeError(f"predict.interpolator built {type(itp).__name__}")
        itp.prepare(len(tile_points), points=tile_points, header=tile_header)

    # depth-2 pending queue: batch i's logits are fetched only after batch
    # i+1's step is queued, so the device computes while the host prepares
    # the next batch and merges the previous one; the D2H copy lands in a
    # pinned buffer without blocking the queue
    pending: deque = deque()
    n_batches = 0

    def drain() -> None:
        host, done, idx = pending.popleft()
        if done is not None:
            with span("predict.fetch_wait", sums):
                done.synchronize()
        with span("predict.merge", sums):
            itp.store_predictions(host.numpy(), idx)

    def to_dev(a: np.ndarray, fill=0) -> torch.Tensor:
        if par is not None:
            a = par.pad_rows(a, fill)
        return torch.from_numpy(a).to(device, non_blocking=True)

    with span("predict.stream", sums):
        batches = BackgroundIterator(loader, max_prefetch=2)
        while True:
            with span("predict.loader_wait", sums):
                batch = next(batches, None)
            if batch is None:
                break
            with span("predict.enqueue", sums):
                full = pad_full_cloud(batch.copies)
                sampled_pos = pad_sampled_pos(batch.copies, batch.num_points)
                if full is None or sampled_pos is None:
                    log.warning("Batch without full-cloud copies; skipping.")
                    continue
                logits = (par or model).interp_step(
                    to_dev(batch.x), to_dev(batch.pos), to_dev(batch.mask, False),
                    to_dev(sampled_pos), to_dev(full["full_pos"]),
                    to_dev(full["full_mask"], False), generator,
                    # predict.exact_interpolation: the f32 two-op path instead of K3
                    fused=not pcfg.get("exact_interpolation"),
                )[: batch.x.shape[0]]   # the real rows
                if device.type == "cuda":
                    host = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
                    host.copy_(logits, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                else:
                    host, done = logits, None
            pending.append((host, done, batch.idx_in_original_cloud))
            n_batches += 1
            if len(pending) > 1:
                drain()
        while pending:
            drain()

    out_path = itp.reduce_predictions_and_save(src_las, pcfg["output_dir"], dm.get("epsg"))
    read, stream, wait, enqueue, fetch, merge, cook, binning = (
        round(sums.get(name, 0.0), 2) for name in (
            "predict.read", "predict.stream", "predict.loader_wait", "predict.enqueue",
            "predict.fetch_wait", "predict.merge", "pctl.cook", "pctl.bin"))
    log.info(
        "predict phases: tile read %.1fs; streaming %.1fs over %d batches "
        "(%.1fs waiting for the loader, %.1fs enqueueing, %.1fs blocked on the logits "
        "fetch, %.1fs merging); finalize+write %.1fs",
        read, stream, n_batches, wait, enqueue, fetch, merge, sum(itp.finalize_phases.values()),
    )
    if phases is not None:
        merged = itp.merge_counts.get("merge_points", 0)
        # myria3d_tpu/predict.py:183-195: the JAX package's keys (the
        # Interpolator's finalize_* phases among them), then the port's spans
        # and merge counters
        phases.update(tile_read_s=read, streaming_s=stream, fetch_blocked_s=fetch,
                      merge_s=merge, n_batches=n_batches)
        phases.update({"finalize_" + k: v for k, v in itp.finalize_phases.items()})
        phases.update(itp.write_stats)
        phases.update(loader_wait_s=wait, enqueue_s=enqueue, cook_busy_s=cook, bin_s=binning,
                      cook_points=sums.get("cook_points", 0),
                      cook_points_native=sums.get("cook_points_native", 0),
                      merge_points=merged, merge_points_native=merged)
    return out_path
