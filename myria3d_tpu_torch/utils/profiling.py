"""Profiling: ``torch.profiler`` traces, named regions and stage timers.

Port of ``myria3d_tpu/utils/profiling.py:20-67``. ``trace(logdir)`` records
the host's operators and, where there is a CUDA device, its kernels and
copies, and writes a Chrome trace (``chrome://tracing``, Perfetto) under
``logdir``. ``annotate(name)`` names a region of that timeline.
``StageTimer`` accumulates named wall-clock stages on the host (copied
unchanged): device work is asynchronous, so synchronise at a stage's end
for the device's time.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block into
    ``logdir/trace_<pid>_<ns>.json`` (no-op when ``logdir`` is falsy)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the profiler timeline (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


class StageTimer:
    """Accumulate wall-clock per named stage; ``metrics()`` returns
    ``profile/{stage}_s`` rows suitable for the CSV logger."""

    def __init__(self) -> None:
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    def metrics(self, reset: bool = True) -> Dict[str, float]:
        out = {f"profile/{k}_s": v for k, v in self._acc.items()}
        out.update(
            {f"profile/{k}_mean_s": self._acc[k] / max(1, self._count[k])
             for k in self._acc}
        )
        if reset:
            self._acc.clear()
            self._count.clear()
        return out
