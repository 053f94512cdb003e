"""Host milliseconds a traced predict step spends in Point Transformer V3's
``pt3.cpe`` spans (each stage's neighbour map, the stem's convolution and
each xCPE): the spans' total in the trace's host events over the traced
steps. None where the program has no such spans."""

SPANS = ("pt3.cpe",)


def read(record):
    trace = record.get("trace")
    if trace is None or not record.get("trace_batches"):
        return None
    spans = [t1 - t0 for t0, t1, name in trace.host if name in SPANS]
    if not spans:
        return None
    return sum(spans) / 1e3 / len(record["trace_batches"])
