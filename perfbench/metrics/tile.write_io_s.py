"""Seconds a tile's finalize pass spends writing its output records (the
threads' seconds in ``pwrite``, or on the in-memory sink of a LAZ output,
averaged over the pass's threads; ``predict(phases=)["write_io_s"]``),
averaged over the window's tiles. None where the program has no such
counter."""


def read(record):
    phases = record.get("phases") or []
    if not phases or any("write_io_s" not in p for p in phases):
        return None
    return sum(p["write_io_s"] for p in phases) / len(phases)
