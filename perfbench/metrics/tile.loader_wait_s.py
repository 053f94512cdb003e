"""Seconds a tile's streaming loop waits on the cooked-batch queue (the span
``predict.loader_wait``; ``predict(phases=)["loader_wait_s"]``), averaged
over the window's tiles. None where the program has no such span."""


def read(record):
    phases = record.get("phases") or []
    if not phases or any("loader_wait_s" not in p for p in phases):
        return None
    return sum(p["loader_wait_s"] for p in phases) / len(phases)
