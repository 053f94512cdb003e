"""Seconds a tile's streaming loop blocks on the device's logits (the span
``predict.fetch_wait``, ``done.synchronize()`` before each merge;
``predict(phases=)["fetch_blocked_s"]``), averaged over the window's tiles.
Read only with the loop's other spans (``enqueue_s`` beside it), as one
split of ``streaming_s``: None where the program has no such spans."""


def read(record):
    phases = record.get("phases") or []
    if not phases or any("enqueue_s" not in p for p in phases):
        return None
    return sum(p["fetch_blocked_s"] for p in phases) / len(phases)
