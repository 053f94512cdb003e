"""Reduction of a ``torch.profiler`` trace to what the per-layer readers and
the result's ``device`` and ``breakdown`` keys take.

:func:`profiled` runs a callable under the profiler (CPU and CUDA
activity) between two synchronisations and returns a :class:`Trace`: the
device intervals (kernels, copies, sets) and the host's torch operations
and annotations, on one clock. Busy time is the union of the device
intervals inside the traced window; an idle gap is named by the innermost
host event that spans its start, or ``host outside torch`` where none does
(numpy, Python, the disk).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float
    device: list = field(default_factory=list)    # (start_us, end_us, name)
    host: list = field(default_factory=list)      # (start_us, end_us, name)

    def busy_s(self) -> float:
        busy, end = 0.0, None
        for t0, t1, _ in self.device:
            if end is None or t0 > end:
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy / 1e6

    def kernel_s(self, *patterns: str) -> float:
        """Seconds of the device intervals whose name holds any pattern."""
        return sum(t1 - t0 for t0, t1, name in self.device
                   if any(p in name for p in patterns)) / 1e6

    def device_ops(self, top: int = 10) -> list:
        by_name: dict = {}
        for t0, t1, name in self.device:
            short = name.split("(")[0].replace("void ", "")
            by_name[short] = by_name.get(short, 0.0) + (t1 - t0) / 1e6
        return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps between device intervals, each named by the host
        event that spans its start."""
        gaps, end = [], None
        for t0, t1, _ in self.device:
            if end is not None and t0 > end:
                gaps.append((end, t0))
            end = t1 if end is None else max(end, t1)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for g0, g1 in gaps[:top]:
            spans = [(h1 - h0, name) for h0, h1, name in self.host if h0 <= g0 < h1]
            name = min(spans)[1] if spans else "host outside torch"
            out.append([name, (g1 - g0) / 1e6])
        return out


def profiled(fn, sync, on_cpu: bool = False) -> Trace:
    """Run ``fn()`` under ``torch.profiler``; ``sync()`` synchronizes the
    device before and after. Raises if the trace holds no device activity.
    ``on_cpu`` (a rehearsal on the CPU) reads the top-level torch operations
    as the device's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    device, host = [], []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end, ev.name)
        if ev.device_type == DeviceType.CUDA and getattr(ev, "is_user_annotation", "#" in ev.name):
            continue   # an annotation's span on the device's row (Adam's step), not work
        on_device = ev.device_type == DeviceType.CUDA or (
            on_cpu and ev.cpu_parent is None and ev.name.startswith("aten::"))
        (device if on_device else host).append(span)
    if not device:
        raise RuntimeError("the profiler traced no device activity")
    device.sort()
    return Trace(window_s=window, device=device, host=host)
