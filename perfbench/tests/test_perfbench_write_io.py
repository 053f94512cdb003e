"""The reader of the finalize pass's write counter: ``write_io_s``
averaged over the window's tiles, and nothing (None) from a program
without the counter."""

import pytest

from perfbench import run


def test_the_write_io_reader_averages_the_window_tiles():
    read = run.load_reader("tile.write_io_s")
    phases = [{"finalize_write_s": 1.1, "write_io_s": 0.4, "write_threads": 8},
              {"finalize_write_s": 1.3, "write_io_s": 0.7, "write_threads": 8}]
    assert read({"phases": phases, "trace": None}) == pytest.approx(0.55)
    assert read({"phases": [{"finalize_write_s": 2.9}], "trace": None}) is None
    assert read({"phases": [phases[0], {"finalize_write_s": 2.9}], "trace": None}) is None
    assert read({"phases": [], "trace": None}) is None
