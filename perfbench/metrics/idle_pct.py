"""Share of the traced window in which no kernel, copy or set ran on the
device, in percent (``torch.profiler``). Serves ``idle_pct.<cells>``."""


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
