"""Seconds a tile spends after the streaming loop: coverage, softmax and
entropy, and the LAS write (``predict(phases=)``'s ``finalize_coverage_s``,
``finalize_softmax_s`` and ``finalize_write_s``), averaged over the
window's tiles."""

KEYS = ("finalize_coverage_s", "finalize_softmax_s", "finalize_write_s")


def read(record):
    phases = record.get("phases") or []
    return sum(p[k] for p in phases for k in KEYS) / len(phases) if phases else None
