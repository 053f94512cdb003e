"""The readers of the program's spans and counters, on synthetic records:
each tile reader averages its ``predict(phases=)`` key over the window's
tiles, each train reader a span's host time over the traced steps, and
every one reads nothing (None) from a record of a program without them."""

import pytest

from perfbench import run
from perfbench.devtrace import Trace

# two tiles as the program reports them, then as a program without the spans
PHASES = [
    {"streaming_s": 16.0, "fetch_blocked_s": 0.5, "merge_s": 12.0, "loader_wait_s": 2.0,
     "enqueue_s": 1.5, "cook_busy_s": 9.0, "merge_points": 1000, "merge_points_native": 0},
    {"streaming_s": 18.0, "fetch_blocked_s": 0.7, "merge_s": 13.0, "loader_wait_s": 3.0,
     "enqueue_s": 1.7, "cook_busy_s": 10.0, "merge_points": 3000, "merge_points_native": 1000},
]
PARENT_PHASES = [{"streaming_s": 16.0, "fetch_blocked_s": 0.5, "merge_s": 12.0}]

TILE = {"tile.loader_wait_s": 2.5, "tile.enqueue_s": 1.6, "tile.fetch_wait_s": 0.6,
        "tile.cook_busy_s": 9.5, "tile.merge_native_pct": 25.0}


@pytest.mark.parametrize("name", sorted(TILE))
def test_tile_readers_average_the_window_tiles(name):
    read = run.load_reader(name)
    assert read({"phases": PHASES, "trace": None}) == pytest.approx(TILE[name])
    assert read({"phases": PARENT_PHASES, "trace": None}) is None
    assert read({"phases": [], "trace": None}) is None


def test_the_native_share_of_a_tile_that_merged_nothing_is_none():
    phases = [dict(PHASES[0], merge_points=0, merge_points_native=0)]
    assert run.load_reader("tile.merge_native_pct")({"phases": phases}) is None


def _train_trace(spans: bool) -> Trace:
    """Two traced steps of 100 ms: forward 30 + 32 ms (the second step in two
    chunks, 20 + 12), backward 50 + 51, optimizer 15 + 14, among the
    torch operations' host events."""
    host = [(0, 5, "aten::mm"), (200, 260, "aten::add_")]
    if spans:
        host += [(0, 100_000, "model.train_step"), (0, 30_000, "model.forward"),
                 (30_000, 80_000, "model.backward"), (80_000, 95_000, "model.optimizer"),
                 (100_000, 200_000, "model.train_step"), (100_000, 120_000, "model.forward"),
                 (120_000, 132_000, "model.forward"), (132_000, 183_000, "model.backward"),
                 (183_000, 197_000, "model.optimizer")]
    return Trace(window_s=0.2, device=[(0, 1, "k")], host=host)


@pytest.mark.parametrize("name,ms", [("train.forward_ms", 31.0), ("train.backward_ms", 50.5),
                                     ("train.optimizer_ms", 14.5)])
def test_train_readers_give_a_span_a_step(name, ms):
    read = run.load_reader(name)
    assert read({"kind": "train", "trace": _train_trace(True)}) == pytest.approx(ms)
    assert read({"kind": "train", "trace": _train_trace(False)}) is None
    assert read({"kind": "train", "trace": None}) is None
