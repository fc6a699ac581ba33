"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
files are found by those names:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the model
  configuration as it is run, and its weights;
* ``traffic/<mix>.json``: the mix's parameters, and the driver that sends
  it (``drivers/<driver>.py``);
* ``limits/<cell>.json``: the limit of each number the check compares;
* ``metrics/<metric>.py``: ``read(run)`` -> the metric's value, or None
  where the run has nothing to read it from.

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
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
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

    def metrics(self, workload: str, section: str) -> List[dict]:
        """The ``section`` ("end_to_end" or "per_layer") metrics this cell
        reports: those that list it, and those that list no cells."""
        return [m for m in self.spec[section]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.dir, "metrics", metric + ".py")
        return load_module(path, "port_bench_metric_"
                           + metric.replace(".", "_").replace("-", "_")).read


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
    from port_bench import corpus as corpus_mod
    from port_bench import weights

    marks = [time.perf_counter()]
    w = bench.workload(workload)
    config = bench.config(w["config"])
    mix = bench.mix(w["traffic"])
    drv = bench.driver(mix["driver"])
    corpus = corpus_mod.make_corpus(seed, mix)
    marks.append(time.perf_counter())
    cfg = weights.program_config(config)
    raw = weights.raw_weights(config, seed, corpus, device, bench.root)
    params = weights.program_params(config, cfg, raw, device, bench.root)
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
            try:
                ans = drv.call(state)
            except RuntimeError as exc:
                failed += 1
                print(f"call failed: {exc}", file=sys.stderr)
                ans = None
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            answers.append(None if ans is None else drv.keep(ans))
        window = t1 - t_start
    return answers, np.asarray(lat), failed, window, holder.get("trace")


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

    answers, lat, failed, window, tr = measure(drv, state, seconds, device,
                                               traced)
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
                          work=work, config=ctx.config, mix=ctx.mix,
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
