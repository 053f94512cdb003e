"""The port's spans and counters (``utils/profiling.py``): a span sums its
wall time and, only under a profiler recording its thread, shows on the
profiler's timeline; sums and counts from many threads add up exactly; the
merge counts its points; and a profiled ``train_step`` is the
root span ``model.train_step`` with ``model.forward``, ``model.backward``
and ``model.optimizer`` in it."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from myria3d_tpu_torch.models.interpolation import Interpolator
from myria3d_tpu_torch.utils import profiling
from myria3d_tpu_torch.utils.profiling import count, span
from tests.myria3d_tpu_torch.test_torch_trainer import _batch, _model, _tensors

torch.set_num_threads(1)


def _regions(prof, *names):
    return [ev for ev in prof.events() if ev.name in names]


def test_span_without_a_profiler_opens_no_region_and_keeps_the_sum(monkeypatch):
    clock = iter([1.0, 1.25, 2.0, 2.5])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))

    def no_region(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_region)
    sums = {}
    for _ in range(2):
        with span("a", sums):
            pass
    assert sums == {"a": 0.75}


def test_span_under_a_cpu_profiler_shows_nested_named_regions():
    sums = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", sums):
            with span("inner"):
                torch.ones(64).sum()
    (outer,), (inner,) = _regions(prof, "outer"), _regions(prof, "inner")
    assert inner.cpu_parent is outer
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert any(ev.name == "aten::sum" for ev in inner.cpu_children)
    assert list(sums) == ["outer"] and sums["outer"] > 0


def test_a_span_on_a_worker_thread_only_sums():
    """The profiler records the thread that started it: a span on another
    thread adds to its sums and leaves no region."""
    sums = {}

    def work():
        with span("worker", sums):
            torch.ones(64).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert _regions(prof, "worker") == [] and sums["worker"] > 0


def test_sums_and_counts_from_many_threads_add_up_exactly(monkeypatch):
    """32 threads x 400 spans and counts on one dict, switching every
    microsecond: every span adds exactly 1 s (each thread's clock reads 0,
    1, 0, 1, ...) and every count 1, so a lost update shows."""
    local = threading.local()

    def clock():
        local.n = getattr(local, "n", 0) + 1
        return float(local.n % 2 == 0)

    monkeypatch.setattr(time, "perf_counter", clock)
    sums, n_threads, n_spans = {}, 32, 400

    def work():
        for _ in range(n_spans):
            with span("pctl.cook", sums):
                pass
            count(sums, "merge_points", 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sums == {"pctl.cook": float(n_threads * n_spans), "merge_points": n_threads * n_spans}


@pytest.mark.parametrize("order,native", [("ascending", True), ("unsorted", True),
                                          ("duplicated", True)])
def test_the_merge_counts_its_points_by_route(order, native):
    """Every index order takes the native scatter, a batch a call (the one
    route, which ``native`` names). ``merge_points`` counts every point
    merged, and the plane is the sum."""
    rng = np.random.default_rng(0)
    n_points, rows = 500, [120, 80, 60]
    idx = [np.sort(rng.choice(n_points, n, replace=order == "duplicated")) for n in rows]
    if order != "ascending":
        idx = [rng.permutation(i) for i in idx]
    logits = rng.normal(size=(len(rows), max(rows), 3)).astype(np.float16)
    itp = Interpolator(classification_dict={1: "a", 2: "b", 3: "c"})
    itp.prepare(n_points)
    itp.store_predictions(logits, idx)
    itp.store_predictions(logits, idx)
    assert itp.merge_counts == {"merge_points": 2 * sum(rows)}
    want = np.zeros((n_points, 3), np.float32)
    for b, i in enumerate(idx):
        np.add.at(want, i, 2 * logits[b, :len(i)].astype(np.float32))
    np.testing.assert_allclose(itp.reduce_predicted_logits(n_points), want, rtol=1e-6, atol=1e-6)
    itp.prepare(n_points)
    assert itp.merge_counts == {}


def test_a_profiled_train_step_is_the_root_span_and_its_three_children():
    model = _model()
    x, pos, y, mask = _tensors(_batch(0))
    model.train_step(x, pos, y, mask, torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            model.train_step(x, pos, y, mask, torch.Generator().manual_seed(i))
    roots = _regions(prof, "model.train_step")
    assert len(roots) == 2
    for root in roots:
        kids = [ev.name for ev in root.cpu_children if ev.name.startswith("model.")]
        assert kids == ["model.forward", "model.backward", "model.optimizer"]


def test_stage_timer_and_annotate_are_spans():
    timer = profiling.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("train_step"), profiling.annotate("region"):
            torch.ones(8).sum()
    (stage,), (region,) = _regions(prof, "train_step"), _regions(prof, "region")
    assert region.cpu_parent is stage
    rows = timer.metrics()
    assert rows["profile/train_step_s"] == rows["profile/train_step_mean_s"] > 0
