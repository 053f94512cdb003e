"""Share of the subtile points a tile cooks whose rows and Lidar HD
features the native call built (``TileSampleStream._cook``'s counters;
``predict(phases=)``'s ``cook_points_native`` over ``cook_points``), over
the window's tiles, in percent. None where the program has no such counters
or cooked nothing."""


def read(record):
    phases = record.get("phases") or []
    if not phases or any("cook_points" not in p for p in phases):
        return None
    cooked = sum(p["cook_points"] for p in phases)
    if cooked <= 0:
        return None
    return 100.0 * sum(p["cook_points_native"] for p in phases) / cooked
