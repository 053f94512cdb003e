"""Seconds the loader threads spend cooking a tile while it streams (the
span ``pctl.cook``, summed over the threads: each subtile's cook and each
batch's collate; ``predict(phases=)["cook_busy_s"]``), averaged over the
window's tiles. None where the program has no such span."""


def read(record):
    phases = record.get("phases") or []
    if not phases or any("cook_busy_s" not in p for p in phases):
        return None
    return sum(p["cook_busy_s"] for p in phases) / len(phases)
