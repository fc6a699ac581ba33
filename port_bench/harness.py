"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
files are found by those names:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the model
  configuration as it is run, its weights, and its model family
  (``families/<family>.py``);
* ``traffic/<mix>.json``: the mix's parameters, the driver that sends it
  (``drivers/<driver>.py``) and, optionally, its arrivals
  (``{"process": "poisson", "rate_per_s": R}``: an open loop; without the
  key, a closed loop);
* ``limits/<cell>.json``: the limit of each number the check compares;
* ``metrics/<metric>.py``: ``read(run)`` -> the metric's value, or None
  where the run has nothing to read it from.

A family module has ``corpus(seed, mix)`` (the inputs made from the seed),
``program_config(config)`` (the port's configuration object),
``raw_weights(config, seed, corpus, device, root)`` (the weights as the
reference reads them) and ``program_params(config, cfg, raw, device,
root)`` (the port's model, by its own loader).

A driver module has ``setup(ctx) -> state``, ``call(state) -> answer`` (one
timed request, ended on the host: its answer downloaded or the device
synchronised), ``keep(answer)`` (what of an answer the client keeps for the
check, taken after the call's clock stops), ``work(state, answers) -> dict``
(counts the metrics read),
``produced(state, answers)`` (what the check judges), ``release(state)``
(frees the program's state), ``reference(state, precision)`` (the same,
worked out by the plain reference) and ``compare(produced, reference) ->
{number: reading}``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "audio_sheet_retrieval_tpu")


def load_module(path: str, name: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.dir = os.path.join(root, "port_bench")
        self.spec = _read_json(os.path.join(root, "BENCHMARK.json"))

    @staticmethod
    def _named(entries: List[dict], name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._named(self.spec["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.spec["configs"], name, "config")
        return _read_json(os.path.join(self.root, entry["file"]))

    def mix(self, name: str) -> dict:
        return _read_json(os.path.join(self.dir, "traffic", name + ".json"))

    def limits(self, workload: str) -> dict:
        return _read_json(os.path.join(self.dir, "limits",
                                       workload + ".json"))

    def driver(self, name: str):
        return load_module(os.path.join(self.dir, "drivers", name + ".py"),
                           f"port_bench_driver_{name}")

    def family(self, name: str):
        return load_module(os.path.join(self.dir, "families", name + ".py"),
                           "port_bench_family_" + _ident(name))

    def metrics(self, workload: str, section: str) -> List[dict]:
        """The ``section`` ("end_to_end" or "per_layer") metrics this cell
        reports: those that list it, and those that list no cells."""
        return [m for m in self.spec[section]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.dir, "metrics", metric + ".py")
        return load_module(path, "port_bench_metric_" + _ident(metric)).read


def _ident(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def banned_modules() -> List[str]:
    """JAX, Flax or the JAX package among the loaded modules, compared by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}


def setup_cell(bench: Bench, workload: str, seed: int, device):
    """Everything before the window -> (driver, state, ctx)."""
    marks = [time.perf_counter()]
    w = bench.workload(workload)
    config = bench.config(w["config"])
    mix = bench.mix(w["traffic"])
    drv = bench.driver(mix["driver"])
    family = bench.family(config["family"])
    corpus = family.corpus(seed, mix)
    marks.append(time.perf_counter())
    cfg = family.program_config(config)
    raw = family.raw_weights(config, seed, corpus, device, bench.root)
    params = family.program_params(config, cfg, raw, device, bench.root)
    marks.append(time.perf_counter())
    ctx = SimpleNamespace(seed=seed, device=device, config=config, mix=mix,
                          cfg=cfg, corpus=corpus, raw=raw, params=params,
                          root=bench.root)
    state = drv.setup(ctx)
    _sync(device)
    marks.append(time.perf_counter())
    spent = np.diff(marks)
    print(f"set-up s: corpus {spent[0]:.3f}, weights {spent[1]:.3f}, "
          f"driver {spent[2]:.3f}", file=sys.stderr)
    return drv, state, ctx


ARRIVALS_STREAM = 0xA7713


def due_times(arrivals: dict, seconds: float) -> np.ndarray:
    """An open loop's due times in [0, ``seconds``), seconds from the
    window's start: a Poisson process at ``rate_per_s`` given its expected
    count, round(rate x seconds) arrivals at sorted uniform times. One
    schedule for every seed (drawn from a stream of its own, not from the
    seed): the seed still orders the queries, but cannot make one run's
    arrivals burstier than another's."""
    if arrivals.get("process") != "poisson":
        raise ValueError(f"unknown arrival process in {arrivals!r}")
    rate = float(arrivals["rate_per_s"])
    if not rate > 0:
        raise ValueError(f"rate_per_s must be positive: {arrivals!r}")
    rng = np.random.default_rng(np.random.SeedSequence(ARRIVALS_STREAM))
    return np.sort(rng.uniform(0.0, seconds, int(round(rate * seconds))))


def _wait_until(t: float) -> None:
    """Spin until ``t``. A sleep, even one that leaves its last 0.2 ms to a
    spin, woke up to 2.4 ms late (99th percentile) and made the calls after
    it 6 % slower on the card's host; a spin is late by microseconds."""
    while time.perf_counter() < t:
        pass


def _call(drv, state):
    """One timed call -> (its answer, 1 where it failed else 0)."""
    try:
        return drv.call(state), 0
    except RuntimeError as exc:
        print(f"call failed: {exc}", file=sys.stderr)
        return None, 1


def measure(drv, state, seconds: float, device, traced: bool):
    """The closed loop: one call after another until ``seconds`` have
    passed -> (answers, latencies [s], failed, window seconds, trace)."""
    from port_bench import trace as trace_mod

    answers, lat, failed = [], [], 0
    with trace_mod.device_trace(traced) as holder:
        _sync(device)
        t_start = time.perf_counter()
        t1 = t_start
        while t1 - t_start < seconds:
            t0 = time.perf_counter()
            ans, bad = _call(drv, state)
            t1 = time.perf_counter()
            failed += bad
            lat.append(t1 - t0)
            answers.append(None if ans is None else drv.keep(ans))
        window = t1 - t_start
    return answers, np.asarray(lat), failed, window, holder.get("trace")


def measure_open(drv, state, due: np.ndarray, device, traced: bool):
    """The open loop: one client serves each due time (seconds from the
    window's start) in order, a call starting at its due time or when the
    call before it has answered, whichever is later; the window ends at
    the last answer -> (answers, latencies [s] from each due time to its
    answer, service [s] (each call's own time), lateness [s] (start less
    due time, where the client was free before the due time), failed,
    window seconds, trace)."""
    from port_bench import trace as trace_mod

    answers, lat, svc, late, failed = [], [], [], [], 0
    with trace_mod.device_trace(traced) as holder:
        _sync(device)
        t_start = time.perf_counter()
        t1 = t_start
        for t_due in t_start + due:
            if time.perf_counter() < t_due:   # the client is free
                _wait_until(t_due)
                late.append(time.perf_counter() - t_due)
            t0 = time.perf_counter()
            ans, bad = _call(drv, state)
            t1 = time.perf_counter()
            failed += bad
            lat.append(t1 - t_due)
            svc.append(t1 - t0)
            answers.append(None if ans is None else drv.keep(ans))
        window = t1 - t_start
    return (answers, np.asarray(lat), np.asarray(svc), np.asarray(late),
            failed, window, holder.get("trace"))


def _ms_quantiles(x: np.ndarray) -> str:
    if x.size == 0:
        return "none"
    q = np.percentile(x, [50, 99, 100]) * 1e3
    return f"p50 {q[0]:.4f} ms, p99 {q[1]:.4f} ms, max {q[2]:.4f} ms"


def judge(checks: Dict[str, float], limits: Dict[str, float]):
    """-> (all within their limits, {name: {"value", "limit"}})."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits[name]
        ok &= bool(np.isfinite(value)) and value <= limit
        out[name] = {"value": float(value), "limit": float(limit)}
    return ok, out


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             traced: bool, device="cuda", t0: Optional[float] = None
             ) -> dict:
    """One run of ``workload`` -> the result object (the contract's keys,
    ``checks`` last)."""
    import torch

    from port_bench import roofline
    from port_bench import trace as trace_mod

    t0 = time.perf_counter() if t0 is None else t0
    drv, state, ctx = setup_cell(bench, workload, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t0

    arrivals = ctx.mix.get("arrivals")
    if arrivals is None:
        answers, lat, failed, window, tr = measure(drv, state, seconds,
                                                   device, traced)
        service, lateness = lat, None
    else:
        answers, lat, service, lateness, failed, window, tr = measure_open(
            drv, state, due_times(arrivals, seconds), device, traced)
        print(f"open loop: {len(answers)} due in {window:.3f} s; lateness "
              f"where the client was free ({lateness.size}): "
              + _ms_quantiles(lateness), file=sys.stderr)
    dev = device_info(device)
    work = drv.work(state, answers)
    produced = drv.produced(state, answers)
    drv.release(state)
    ctx.params = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    reference = drv.reference(state, "f32")
    ok, checks = judge(drv.compare(produced, reference),
                       bench.limits(workload))

    run = SimpleNamespace(seconds=window, setup_s=setup_s, latencies=lat,
                          service=service, lateness=lateness, work=work,
                          config=ctx.config, mix=ctx.mix,
                          peaks=roofline.peaks(dev["kind"]), trace=tr)
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in bench.metrics(workload, section):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if tr is not None:
        dev["busy_s"] = trace_mod.busy_s(tr)
        dev["window_s"] = window
    result = {"correct": bool(ok and failed == 0 and len(answers) > 0),
              "attempted": len(answers), "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = trace_mod.breakdown(tr)
    result["checks"] = checks
    return result
