"""Host milliseconds a traced predict step spends in the spans
``pt.attention`` (the vector attention's unfused passes, each layer's
enqueue): the spans' total time in the trace's host events over the
traced steps. None where the program has no such spans."""

SPAN = "pt.attention"


def read(record):
    trace = record.get("trace")
    if trace is None or not record.get("trace_batches"):
        return None
    spans = [t1 - t0 for t0, t1, name in trace.host if name == SPAN]
    if not spans:
        return None
    return sum(spans) / 1e3 / len(record["trace_batches"])
