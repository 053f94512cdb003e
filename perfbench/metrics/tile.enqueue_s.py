"""Seconds a tile's streaming loop spends enqueueing its batches on the host
(the span ``predict.enqueue``: padding, host-to-device copies,
``interp_step``, the pinned copy back; ``predict(phases=)["enqueue_s"]``),
averaged over the window's tiles. None where the program has no such span."""


def read(record):
    phases = record.get("phases") or []
    if not phases or any("enqueue_s" not in p for p in phases):
        return None
    return sum(p["enqueue_s"] for p in phases) / len(phases)
