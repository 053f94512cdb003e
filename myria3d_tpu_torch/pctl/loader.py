"""Prefetching padded-batch loader.

Replaces the reference's torch DataLoader + GeometricNoneProofCollater
(reference ``myria3d/pctl/dataloader/dataloader.py:5-32``): a thread-pool
prefetching loader that yields fixed-shape ``PointCloudBatch`` objects.
Threads (not processes) suffice because h5py reads and numpy transforms
release the GIL for the heavy parts, and the padded collate is a memcpy.

Prefetching overlaps host-side sample preparation with device compute — the
"overlapped host I/O" requirement of the BASELINE (see BASELINE.md).

Copied from ``myria3d_tpu/pctl/loader.py``; imports point at the port, and
a sharded loader reads its rank and the world size from the
``torch.distributed`` process group (``parallel/ddp.py``) and buckets each
rank's batches on their own.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from myria3d_tpu_torch.pctl.batching import (
    DEFAULT_BUCKETS,
    PointCloudBatch,
    collate_padded,
)
from myria3d_tpu_torch.utils.profiling import span

_log = logging.getLogger(__name__)


class PaddedBatchLoader:
    """Map-style or iterable dataset → iterator of ``PointCloudBatch``.

    None samples are dropped; a batch that ends up empty is skipped
    (None-proof semantics). The batch dim is always ``batch_size``.

    Multi-process runs (``process_count > 1``) shard map-style datasets
    across processes like torch's DistributedSampler (the reference gets
    this from Lightning DDP, ``configs/experiment/
    RandLaNet_base_run_FR-2x3GPUs.yaml:13-18``): every process shuffles the
    SAME permutation (shared seed + epoch), wrap-pads it to a multiple of
    the process count, and consumes the ``rank::count`` stride — disjoint
    samples, identical batch counts. Batches are then formed from *fixed
    index groups* (a None sample shrinks its batch instead of shifting
    batch boundaries), so the collective step count stays aligned. Each
    rank pads its batch to its own bucket: DDP reduces parameter-shaped
    gradients and needs no common batch shape (the JAX package pads every
    rank to the top bucket for ``make_array_from_process_local_data``). Set
    ``shard_by_process=False`` to opt out (or pass explicit
    ``process_index``/``process_count`` for testing).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 2,
        prefetch_factor: int = 2,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        drop_last: bool = False,
        seed: Optional[int] = None,
        shard_by_process: bool = True,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        num_features: Optional[int] = None,
        timings: Optional[dict] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch_factor = max(1, prefetch_factor)
        self.buckets = buckets
        self.drop_last = drop_last
        self.seed = seed
        self.shard_by_process = shard_by_process
        self.process_index = process_index
        self.process_count = process_count
        self._num_features = num_features  # cached for filler batches
        self.timings = timings  # receives each batch's collate seconds ("pctl.cook")
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _resolve_process(self):
        """(rank, count) for input sharding; (0, 1) when not sharding."""
        if not self.shard_by_process:
            return 0, 1
        if self.process_count is not None:
            return int(self.process_index or 0), int(self.process_count)
        from myria3d_tpu_torch.parallel import ddp

        return ddp.rank(), ddp.world_size()

    @property
    def _map_style(self) -> bool:
        return hasattr(self.dataset, "__getitem__") and hasattr(
            self.dataset, "__len__"
        )

    def _local_indices(self, rank: int, count: int) -> np.ndarray:
        """This process's sample indices: shared permutation, wrap-padded to
        a multiple of ``count`` (torch DistributedSampler semantics), then
        the ``rank::count`` stride — len identical on every rank."""
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            # seed must be common across processes; None would desync ranks
            rng = np.random.default_rng((self.seed or 0) + self._epoch)
            rng.shuffle(indices)
        total = -(-n // count) * count
        if total > n:
            indices = np.concatenate([indices, indices[: total - n]])
        return indices[rank::count]

    def _iter_process_sharded(self, rank: int, count: int) -> Iterator[PointCloudBatch]:
        from myria3d_tpu_torch.pctl.batching import filler_batch

        local = self._local_indices(rank, count)
        if len(local) == 0:
            return
        groups = [
            local[i: i + self.batch_size]
            for i in range(0, len(local), self.batch_size)
        ]
        if self.drop_last and len(groups[-1]) < self.batch_size:
            groups.pop()
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: "queue.Queue" = queue.Queue()
            it = iter(groups)
            for g in itertools.islice(it, self.prefetch_factor):
                pending.put([pool.submit(self.dataset.__getitem__, int(i)) for i in g])
            while not pending.empty():
                futs = pending.get()
                nxt = next(it, None)
                if nxt is not None:
                    pending.put(
                        [pool.submit(self.dataset.__getitem__, int(i)) for i in nxt]
                    )
                samples = [f.result() for f in futs]
                batch = self._collate(samples, num_features=self._num_features)
                if batch is not None:
                    self._num_features = int(batch.x.shape[2])
                else:
                    # every sample in the group filtered out: this rank must
                    # still join the collective step the other ranks run
                    if self._num_features is None:
                        raise RuntimeError(
                            "Process-sharded loader hit an all-None batch "
                            "before any sample revealed the feature width; "
                            "pass num_features= to PaddedBatchLoader."
                        )
                    batch = filler_batch(
                        self.batch_size, self.buckets[0], self._num_features
                    )
                yield batch

    def _collate(self, samples: list, **kwargs) -> Optional[PointCloudBatch]:
        with span("pctl.cook", self.timings):
            return collate_padded(samples, self.batch_size, self.buckets, **kwargs)

    def _sample_iter(self) -> Iterator[Optional[dict]]:
        if hasattr(self.dataset, "__getitem__") and hasattr(self.dataset, "__len__"):
            indices = np.arange(len(self.dataset))
            if self.shuffle:
                rng = np.random.default_rng(
                    None if self.seed is None else self.seed + self._epoch
                )
                rng.shuffle(indices)
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                depth = self.num_workers * self.prefetch_factor * self.batch_size
                it = iter(indices)
                futures: "queue.Queue" = queue.Queue()
                for idx in itertools.islice(it, depth):
                    futures.put(pool.submit(self.dataset.__getitem__, int(idx)))
                while not futures.empty():
                    f = futures.get()
                    nxt = next(it, None)
                    if nxt is not None:
                        futures.put(pool.submit(self.dataset.__getitem__, int(nxt)))
                    yield f.result()
        else:
            yield from iter(self.dataset)

    def __iter__(self) -> Iterator[PointCloudBatch]:
        rank, count = self._resolve_process()
        if count > 1 and self._map_style:
            yield from self._iter_process_sharded(rank, count)
            return
        if count > 1:
            # an iterable-only dataset cannot be index-sharded: every rank
            # would silently iterate ALL samples (duplicated work + wrong
            # global batch semantics) while __len__ reports the per-rank
            # share. Fail loudly instead.
            raise RuntimeError(
                "Process sharding requires a map-style dataset "
                "(__getitem__ + __len__); got an iterable-only dataset "
                f"with process_count={count}. Pass shard_by_process=False "
                "and shard inside the dataset instead."
            )
        batch: List[Optional[dict]] = []
        for sample in self._sample_iter():
            if sample is None:
                continue
            batch.append(sample)
            if len(batch) == self.batch_size:
                collated = self._collate(batch)
                if collated is not None:
                    yield collated
                batch = []
        if batch and not self.drop_last:
            collated = self._collate(batch)
            if collated is not None:
                yield collated

    def __len__(self) -> int:
        if hasattr(self.dataset, "__len__"):
            n = len(self.dataset)
            _, count = self._resolve_process()
            # mirror __iter__: only map-style datasets are process-sharded
            if count > 1 and self._map_style:
                n = -(-n // count)  # per-rank share (wrap-padded)
            if self.drop_last:
                return n // self.batch_size
            return (n + self.batch_size - 1) // self.batch_size
        raise TypeError("Length undefined for iterable datasets")


class BackgroundIterator:
    """Wrap any iterator to produce items from a background thread, keeping a
    small buffer ahead — double-buffers host collate against device steps."""

    _DONE = object()

    def __init__(self, iterable: Iterable, max_prefetch: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_prefetch)
        self._err: Optional[BaseException] = None
        self._err_delivered = False
        self._closed = threading.Event()

        def run() -> None:
            try:
                for item in iterable:
                    # bounded put so a consumer that stopped reading (e.g.
                    # a preemption break) can unblock us via close()
                    while not self._closed.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._closed.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                self._err = e
            finally:
                while not self._closed.is_set():
                    try:
                        self._q.put(self._DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 5.0) -> bool:
        """Stop the producer thread without draining the source iterator.

        Safe to call after breaking out of the consuming loop early (the
        preemption path in ``Trainer._fit_one_epoch``); idempotent. Returns
        True when the producer thread has actually exited; False when it is
        still finishing an in-flight sample (it cannot be interrupted inside
        the source iterator itself — e.g. a blocking h5py read — and is a
        daemon thread, so a True-less return is harmless but means the
        sample pipeline is still briefly open)."""
        self._closed.set()
        # drain so a producer blocked on put() can observe the event
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=timeout)
        alive = self._thread.is_alive()
        if alive:
            _log.warning(
                "BackgroundIterator.close(): producer thread still finishing "
                "an in-flight sample after %.1fs (daemon; will exit with the "
                "process)", timeout,
            )
        # a producer error that raced the close would otherwise vanish with
        # the suppressed DONE sentinel — surface it in the log at least
        # (unless __next__ already re-raised it to the consumer)
        if self._err is not None and not self._err_delivered:
            _log.warning(
                "BackgroundIterator.close(): pending producer error "
                "discarded by early consumer exit: %r", self._err,
            )
        return not alive

    def __iter__(self):
        return self

    def __next__(self):
        # timeout-poll instead of a bare blocking get(): if close() runs on
        # another thread after the closed-flag check, the producer may have
        # exited without ever enqueuing DONE — re-check the flag each tick
        while True:
            if self._closed.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                continue
        if item is self._DONE:
            if self._err is not None:
                self._err_delivered = True
                raise self._err
            raise StopIteration
        return item
