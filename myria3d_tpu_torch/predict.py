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
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from myria3d_tpu_torch.models.interpolation import Interpolator
from myria3d_tpu_torch.parallel import auto_parallel
from myria3d_tpu_torch.pctl.batching import DEFAULT_BUCKETS, pad_full_cloud, pad_sampled_pos
from myria3d_tpu_torch.pctl.dataset.iterable import InferenceDataset
from myria3d_tpu_torch.pctl.dataset.utils import read_las_array
from myria3d_tpu_torch.pctl.loader import BackgroundIterator, PaddedBatchLoader
from myria3d_tpu_torch.pctl.transforms.compose import CustomCompose
from myria3d_tpu_torch.pctl.transforms.transforms import SortPointsByX
from myria3d_tpu_torch.train import port_targets
from myria3d_tpu_torch.utils.checkpoint import load_checkpoint
from myria3d_tpu_torch.utils.config import instantiate

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
    """Padded point-count ladder (``HDF5LidarDataModule._build_buckets``):
    the MaximumNumNodes cap rounded up to 128 tops the default ladder."""
    cap = dm.get("padded_num_points")
    if not cap:
        cap = next((int(t.num) for t in stages
                    if type(t).__name__ in ("MaximumNumNodes", "FixedPoints")),
                   DEFAULT_BUCKETS[-1])
    top = -(-int(cap) // 128) * 128
    if not dm.get("bucketing", True):
        return (top,)
    return tuple(b for b in DEFAULT_BUCKETS if b < top) + (top,)


def tile_loader(config: dict, tile_points: np.ndarray) -> PaddedBatchLoader:
    """The padded batches of ``predict.src_las``'s subtiles, cooked from
    the tile's points (``tile_points``, as :func:`read_las_array` gives
    them) by the predict transforms."""
    pcfg, dm = config["predict"], config["datamodule"]
    # the sort and the kernels' window are switched on together, so an
    # unsorted cloud never meets a window
    transforms = port_targets(dm["transforms"])
    stages = [instantiate(t) for t in transforms["preparations_predict_list"]]
    if int(pcfg.get("sorted_window", 0) or 0) > 0:
        stages.append(SortPointsByX())
    stages += [instantiate(t) for t in transforms["normalizations_list"]]
    dataset = InferenceDataset(
        pcfg["src_las"], dm.get("epsg"),
        points_pre_transform=instantiate(port_targets(dm["points_pre_transform"])),
        pre_filter=instantiate(port_targets(dm.get("pre_filter"))),
        transform=CustomCompose(stages),
        tile_width=dm.get("tile_width", 1000),
        subtile_width=dm.get("subtile_width", 50),
        subtile_overlap=dm.get("subtile_overlap_predict", 0),
        points=tile_points,
    )
    return PaddedBatchLoader(
        dataset, batch_size=dm["batch_size"], num_workers=1,
        prefetch_factor=dm.get("prefetch_factor", 2), buckets=_buckets(dm, stages),
        process_index=0, process_count=1,
    )


def predict(config: dict, phases: Optional[dict] = None, preread=None,
            device: Any = None, devices: Optional[list] = None) -> str:
    """Predict one LAS file (``config["predict"]["src_las"]``) and return
    the output path. ``phases``, when given, receives wall-clock phase
    timings in seconds, rounded to 2 decimals, and ``n_batches``.
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

    t0 = time.perf_counter()
    if preread is not None:
        tile_points, tile_header = (
            preread.result() if hasattr(preread, "result") else preread
        )
    else:
        tile_points, tile_header = read_las_array(src_las, dm.get("epsg"))
    t_read = time.perf_counter() - t0

    loader = tile_loader(config, tile_points)
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
    t_fetch = t_merge = 0.0
    n_batches = 0

    def drain() -> None:
        nonlocal t_fetch, t_merge
        host, done, idx = pending.popleft()
        ta = time.perf_counter()
        if done is not None:
            done.synchronize()
        tb = time.perf_counter()
        itp.store_predictions(host.numpy(), idx)
        t_fetch += tb - ta
        t_merge += time.perf_counter() - tb

    def to_dev(a: np.ndarray, fill=0) -> torch.Tensor:
        if par is not None:
            a = par.pad_rows(a, fill)
        return torch.from_numpy(a).to(device, non_blocking=True)

    t_stream0 = time.perf_counter()
    for batch in BackgroundIterator(loader, max_prefetch=2):
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
    t_stream = time.perf_counter() - t_stream0

    t0 = time.perf_counter()
    out_path = itp.reduce_predictions_and_save(src_las, pcfg["output_dir"], dm.get("epsg"))
    t_reduce = time.perf_counter() - t0
    log.info(
        "predict phases: tile read %.1fs; streaming %.1fs over %d batches "
        "(%.1fs blocked on the logits fetch, %.1fs merging); finalize+write %.1fs",
        t_read, t_stream, n_batches, t_fetch, t_merge, t_reduce,
    )
    if phases is not None:
        # myria3d_tpu/predict.py:183-195, its second update included: the
        # Interpolator's write_s replaces the total finalize_write_s
        phases.update(tile_read_s=round(t_read, 2), streaming_s=round(t_stream, 2),
                      fetch_blocked_s=round(t_fetch, 2), merge_s=round(t_merge, 2),
                      n_batches=n_batches, finalize_write_s=round(t_reduce, 2))
        phases.update({"finalize_" + k: v for k, v in itp.finalize_phases.items()})
    return out_path
