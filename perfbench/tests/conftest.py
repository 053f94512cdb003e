"""Small traffic for the benchmark's CPU tests: the cells' mixes cut to a few
subtiles of a few thousand points, so that a whole run fits on the CPU."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {
    "predict_step": dict(rows=2, n_pad=4096, m_pad=8192, distinct_batches=2, warmup_steps=1,
                         trace_steps=2, tile_points=400 * 4 * 1800, sorted_window=1024),
    "train_step": dict(rows=2, n_pad=4096, m_pad=8192, distinct_batches=3, warmup_steps=3,
                       checked_within=2, trace_steps=2, tile_points=400 * 4 * 1800),
    "tile_predict": dict(rows=4, tile_points=40000, tile_width=100.0, min_tiles=2,
                         overrides=["datamodule.epsg=2154", "datamodule.batch_size=4",
                                    "datamodule.tile_width=100", "predict.subtile_overlap=0",
                                    "trainer.accelerator=cpu"]),
}


def small_cell(workload: str):
    """(bench, cell, config, traffic) of ``workload`` with its mix cut to
    the CPU's size."""
    from perfbench import run

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, config, traffic = run.cell_of(bench, workload)
    traffic.update(SMALL[traffic["driver"]])
    return bench, cell, config, traffic


@pytest.fixture(autouse=True)
def _threads_and_tmp(tmp_path, monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
