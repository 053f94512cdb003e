"""Host milliseconds a traced train step spends in the span ``model.forward``
(the net and the criterion, every chunk of a step): the span's total time in
the trace's host events over the number of ``model.train_step`` spans. None
where the program has no such spans."""

SPAN = "model.forward"


def read(record):
    trace = record.get("trace")
    if trace is None:
        return None
    steps = sum(1 for _, _, name in trace.host if name == "model.train_step")
    if not steps:
        return None
    return sum(t1 - t0 for t0, t1, name in trace.host if name == SPAN) / 1e3 / steps
