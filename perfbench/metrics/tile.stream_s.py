"""Seconds a tile spends in the streaming loop of ``predict()`` (the cook,
the steps and the merge, overlapped; ``predict(phases=)["streaming_s"]``),
averaged over the window's tiles."""


def read(record):
    phases = record.get("phases") or []
    return sum(p["streaming_s"] for p in phases) / len(phases) if phases else None
