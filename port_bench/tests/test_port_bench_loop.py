"""The measured window with a toy driver whose calls take a known time:
the closed loop as before (latency = service, calls until the window's
seconds have passed), and the open loop (due times fixed run after run at
the mix's rate; latency from the due time grows by the time spent queueing
while service does not; the generator's lateness recorded where the
client was free)."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import add_toy_cells, make_tiny_root
from port_bench import harness

SERVICE_S = 0.005


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = make_tiny_root(str(tmp_path_factory.mktemp("toy_bench")))
    add_toy_cells(root, service_s=SERVICE_S, rate_per_s=400.0)
    return root


def run_and_keep(monkeypatch, root, cell, seconds):
    """A whole run of ``cell`` -> (its result, the run its readers read)."""
    seen = {}
    orig = harness.Bench.reader

    def spy(self, metric):
        read = orig(self, metric)

        def keep_run(run):
            seen["run"] = run
            return read(run)
        return keep_run

    monkeypatch.setattr(harness.Bench, "reader", spy)
    r = harness.run_cell(harness.Bench(root), cell, 11, seconds, False,
                         device="cpu")
    return r, seen["run"]


def test_closed_loop_latency_is_the_calls_own_time(monkeypatch, toy_root):
    r, run = run_and_keep(monkeypatch, toy_root, "toy-closed", 0.1)
    assert r["correct"], r
    assert run.service is run.latencies and run.lateness is None
    n = run.latencies.size
    assert r["attempted"] == n
    # one call after another until the window's seconds have passed
    assert n * SERVICE_S >= 0.1 and run.seconds >= 0.1
    assert run.seconds - run.latencies[-1] < 0.1
    assert np.all(run.latencies >= SERVICE_S)
    assert harness.Bench(toy_root).reader("lateness_ms.open")(run) is None


def test_the_closed_loop_measure_keeps_its_return():
    class Drv:
        @staticmethod
        def call(state):
            return 1

        @staticmethod
        def keep(answer):
            return answer

    answers, lat, failed, window, tr = harness.measure(Drv, None, 0.02,
                                                       "cpu", False)
    assert answers and len(answers) == lat.size and failed == 0
    assert window >= 0.02 and tr is None


def test_due_times_are_fixed_and_at_the_rate():
    arrivals = {"process": "poisson", "rate_per_s": 100}
    due = harness.due_times(arrivals, 20.0)
    assert np.array_equal(due, harness.due_times(arrivals, 20.0))
    assert due.size == 2000
    assert due[0] >= 0 and due[-1] < 20.0 and np.all(np.diff(due) >= 0)
    gaps = np.diff(np.concatenate([[0.0], due]))
    assert gaps.mean() == pytest.approx(1 / 100, rel=0.05)
    # exponential gaps: their spread is about their mean
    assert gaps.std() == pytest.approx(gaps.mean(), rel=0.1)


@pytest.mark.parametrize("arrivals", [
    {"process": "uniform", "rate_per_s": 10},
    {"process": "poisson", "rate_per_s": 0},
    {"rate_per_s": 10},
])
def test_unknown_arrivals_are_refused(arrivals):
    with pytest.raises(ValueError):
        harness.due_times(arrivals, 1.0)


def test_open_loop_counts_the_queue_from_the_due_time(monkeypatch,
                                                      toy_root):
    # 400 arrivals a second against 5 ms calls: the queue grows
    r, run = run_and_keep(monkeypatch, toy_root, "toy-open", 0.25)
    assert r["correct"], r
    due = harness.due_times({"process": "poisson", "rate_per_s": 400.0},
                            0.25)
    n = due.size
    assert r["attempted"] == n == run.latencies.size == run.service.size
    assert np.all(run.service >= SERVICE_S)
    assert np.median(run.service) < 4 * SERVICE_S
    queued = run.latencies - run.service
    assert np.all(queued >= -1e-9)
    # the last query waits for nearly every call before it
    assert queued[-1] > 0.5 * (n * SERVICE_S - due[-1])
    assert run.latencies[-1] > 10 * np.median(run.service)
    assert run.seconds >= n * SERVICE_S      # the window ends at the last
    assert run.lateness is not None          # answer


def test_open_loop_records_its_lateness(monkeypatch, toy_root):
    import json
    import os

    path = os.path.join(toy_root, "port_bench", "traffic", "toy-open.json")
    with open(path) as fp:
        mix = json.load(fp)
    slow = dict(mix, arrivals={"process": "poisson", "rate_per_s": 40.0},
                service_s=0.0005)
    monkeypatch.setattr(harness.Bench, "mix", lambda self, name: slow)
    r, run = run_and_keep(monkeypatch, toy_root, "toy-open", 0.5)
    assert r["correct"] and r["attempted"] == 20, r
    # 40 a second against 0.5 ms calls: the client is nearly always free
    assert run.lateness.size >= 15
    assert np.all(run.lateness >= 0)
    assert np.median(run.lateness) < 1e-3
    p99 = harness.Bench(toy_root).reader("lateness_ms.open")(run)
    assert p99 == pytest.approx(np.percentile(run.lateness, 99) * 1e3)
    assert np.all(run.latencies >= run.service)
