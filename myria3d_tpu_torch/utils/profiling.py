"""Profiling: ``torch.profiler`` traces, named spans, counters and stage timers.

Port of ``myria3d_tpu/utils/profiling.py:20-67``. ``trace(logdir)`` records
the host's operators and, where there is a CUDA device, its kernels and
copies, and writes a Chrome trace (``chrome://tracing``, Perfetto) under
``logdir``.

``span(name, into)`` is the one mechanism that names the program's work:
it adds its wall time to ``into[name]`` and, while a ``torch.profiler``
records on the calling thread, also opens ``record_function(name)``, which
puts the span on the profiler's clock beside the device's kernels and
copies. With no profiler recording it costs one flag check, and two clock
reads where it sums. The flag is the calling thread's: a profiler records
the thread that started it, so a span on a worker thread (the cook pool, a
``BackgroundIterator``) only sums. ``count(into, name, n)`` adds to the
same kind of dict. Both are safe to call from several threads on one dict.

``annotate(name)`` names a region of the timeline; ``StageTimer``
accumulates named wall-clock stages on the host (the JAX package's
metrics), each stage a span. Device work is asynchronous, so a span around
an enqueue measures the enqueue; synchronise at its end for the device's
time.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

_SUMS = threading.Lock()
# whether a profiler records the calling thread
_recording = torch._C._autograd._profiler_enabled


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


class span:
    """Named span: ``with span("predict.merge", sums): ...`` adds the
    block's wall seconds to ``sums["predict.merge"]`` (when ``into`` is
    given) and, while a profiler records this thread, shows the block as
    the region ``name`` in its trace."""

    __slots__ = ("name", "into", "_t0", "_region")

    def __init__(self, name: str, into: Optional[dict] = None):
        self.name, self.into = name, into

    def __enter__(self) -> "span":
        self._region = None
        if _recording():
            self._region = torch.autograd.profiler.record_function(self.name)
            self._region.__enter__()
        if self.into is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.into is not None:
            dt = time.perf_counter() - self._t0
            with _SUMS:
                self.into[self.name] = self.into.get(self.name, 0.0) + dt
        if self._region is not None:
            self._region.__exit__(*exc)


def count(into: dict, name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``into[name]``."""
    with _SUMS:
        into[name] = into.get(name, 0) + n


def annotate(name: str) -> span:
    """Named region in the profiler timeline (a span that sums nowhere)."""
    return span(name)


class StageTimer:
    """Accumulate wall-clock per named stage; ``metrics()`` returns
    ``profile/{stage}_s`` rows suitable for the CSV logger."""

    def __init__(self) -> None:
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        try:
            with span(name, self._acc):
                yield
        finally:
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
