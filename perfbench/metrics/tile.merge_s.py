"""Seconds a tile spends merging logits into the tile's plane
(``Interpolator.store_predictions`` inside the streaming loop;
``predict(phases=)["merge_s"]``), averaged over the window's tiles."""


def read(record):
    phases = record.get("phases") or []
    return sum(p["merge_s"] for p in phases) / len(phases) if phases else None
