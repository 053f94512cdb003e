"""Share of the points a tile merges that the native row scatter takes
(``Interpolator._scatter_add``'s counters; ``predict(phases=)``'s
``merge_points_native`` over ``merge_points``), over the window's tiles, in
percent. None where the program has no such counters or merged nothing."""


def read(record):
    phases = record.get("phases") or []
    if not phases or any("merge_points" not in p for p in phases):
        return None
    merged = sum(p["merge_points"] for p in phases)
    if merged <= 0:
        return None
    return 100.0 * sum(p["merge_points_native"] for p in phases) / merged
