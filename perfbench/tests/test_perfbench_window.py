"""The whole-tile window: it closes at the end of the first tile that ends
after ``--seconds``, and never before ``min_tiles`` tiles."""

import pytest

from perfbench.drivers.tile_predict import window_closes


@pytest.mark.parametrize("ends,seconds,min_tiles,tiles", [
    ([19.0, 38.5, 57.0], 20, 2, 2),     # the second tile ends past 20 s
    ([19.0, 38.5, 57.0], 40, 2, 3),     # 38.5 s is short of 40 s
    ([45.0, 90.0], 20, 2, 2),           # one slow tile is not a rate over tiles
    ([5.0, 10.0, 15.0, 20.0, 25.0], 20, 2, 4),
])
def test_window_closes_after_whole_tiles(ends, seconds, min_tiles, tiles):
    done = next(i + 1 for i, t in enumerate(ends) if window_closes(t, i + 1, seconds, min_tiles))
    assert done == tiles
