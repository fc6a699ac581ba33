"""The readers of the program's spans (``port_bench/spans.py`` and the
seven ``program_span`` metrics) on hand-made spans and traces: host time
by stage, self time, and the device's idle time inside the roots,
including an idle interval half inside a root; None from a program that
records no spans."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from audio_sheet_retrieval_tpu_torch.utils import profiling
from port_bench import spans as spans_mod
from test_port_bench_arith import make_trace, read

QUERY = ("upload_ms.query", "enqueue_ms.query", "vote_ms.query",
         "idle_in_query.query")
INDEX = ("upload_ms.index", "enqueue_ms.index", "idle_in_build.index")


def span(i, name, ts, dur, parent=None, root=None):
    return {"id": i, "name": name, "ts_us": float(ts), "dur_us": float(dur),
            "parent": parent, "root": i if root is None else root}


def query_run():
    """Two queries (100-1100 and 2000-2500 µs) and a stray upload; the
    device idles 600-900 (inside the first), 1500-2100 (half inside the
    second) and 2200-2500."""
    s = [span(1, "query", 100, 1000),
         span(2, "upload", 110, 20, 1, 1),
         span(3, "decode", 140, 50, 1, 1),
         span(4, "windows", 200, 100, 1, 1),
         span(5, "upload", 210, 10, 4, 1),
         span(6, "encoder", 320, 300, 1, 1),
         span(7, "topk", 630, 100, 1, 1),
         span(8, "vote", 740, 300, 1, 1),
         span(9, "query", 2000, 500),
         span(10, "upload", 2010, 40, 9, 9),
         span(11, "encoder", 2100, 200, 9, 9),
         span(12, "vote", 2350, 100, 9, 9),
         span(13, "upload", 3000, 400)]
    tr = make_trace([(0, 600), (900, 1500), (2100, 2200)])
    return SimpleNamespace(spans=s, trace=tr, seconds=0.01,
                           work={"queries": 2, "calls": 2})


def index_run():
    """One pass (0-5000 µs) of two pieces; the device runs 0-1000 and
    4500-6000."""
    s = [span(1, "build", 0, 5000),
         span(2, "upload", 10, 100, 1, 1),
         span(3, "windows", 200, 300, 1, 1),
         span(4, "upload", 210, 50, 3, 1),
         span(5, "encoder", 600, 1000, 1, 1),
         span(6, "upload", 4000, 20, 1, 1)]
    tr = make_trace([(0, 1000), (4500, 6000)])
    return SimpleNamespace(spans=s, trace=tr, seconds=0.01,
                           work={"pieces": 2, "windows": 40})


@pytest.mark.parametrize("metric,want", [
    ("upload_ms.query", (20 + 10 + 40) / 2 * 1e-3),
    ("enqueue_ms.query", (50 + (100 - 10) + 300 + 100 + 200) / 2 * 1e-3),
    ("vote_ms.query", (300 + 100) / 2 * 1e-3),
    # idle inside the roots: 300 µs in the first, 100 + 300 in the second
    ("idle_in_query.query", 100.0 * 700e-6 / 0.01),
])
def test_query_readers(metric, want):
    assert read(metric, query_run()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric,want", [
    ("upload_ms.index", (100 + 50 + 20) / 2 * 1e-3),
    ("enqueue_ms.index", ((300 - 50) + 1000) / 2 * 1e-3),
    ("idle_in_build.index", 100.0 * 3500e-6 / 0.01),
])
def test_index_readers(metric, want):
    assert read(metric, index_run()) == pytest.approx(want, rel=1e-12)


def test_each_kind_reads_nothing_in_the_others_cells():
    for metric in QUERY:
        assert read(metric, index_run()) is None
    for metric in INDEX:
        assert read(metric, query_run()) is None


def test_idle_inside_a_root_with_no_device_activity_is_all_of_it():
    run = query_run()
    run.trace = make_trace([])
    assert read("idle_in_query.query", run) == pytest.approx(
        100.0 * 1500e-6 / 0.01)


def test_busy_before_counts_a_running_interval_in_part():
    ds, de = np.array([0.0, 900.0]), np.array([600.0, 1500.0])
    got = spans_mod._busy_before(ds, de, np.array([-5.0, 300.0, 700.0,
                                                   1000.0, 2000.0]))
    np.testing.assert_allclose(got, [0.0, 300.0, 600.0, 700.0, 1200.0])


@pytest.mark.parametrize("metric", QUERY + INDEX)
def test_a_program_without_spans_gives_none(monkeypatch, metric):
    monkeypatch.delattr(profiling, "take_spans")
    run = query_run() if metric in QUERY else index_run()
    del run.spans
    assert read(metric, run) is None


def test_the_first_reader_takes_the_spans_for_all():
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("query"):
            with profiling.span("upload"):
                pass
            with profiling.span("vote"):
                pass
    run = query_run()
    del run.spans
    assert read("upload_ms.query", run) > 0
    assert [s["name"] for s in run.spans] == ["query", "upload", "vote"]
    assert read("vote_ms.query", run) > 0
    assert profiling.take_spans() == []
    run = query_run()
    del run.spans                   # nothing recorded: nothing to read
    assert read("vote_ms.query", run) is None
