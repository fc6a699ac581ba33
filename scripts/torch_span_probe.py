#!/usr/bin/env python
"""What the port's spans cost when on, and whether they cover the card's
work, in the benchmark's cells, on one CUDA card.

    python scripts/torch_span_probe.py [--seconds S] [--seed N] [--smoke]
        CELL [CELL ...]

For each cell of ``BENCHMARK.json`` named: one set-up as the benchmark
makes it (``port_bench.harness.setup_cell``), then six traced windows of
``--seconds`` each through ``harness.measure`` (the benchmark's closed
loop under its CUDA-only device trace), spans on, off, off, on, on, off.
"Off" replaces ``utils.profiling.span`` by a function that returns the
shared no-op context, as with no profiler running, so the windows differ
only by the spans. Each window prints one JSON line: the rate (queries or
windows over the window's seconds); and, with spans on, the benchmark's
``program_span`` metrics, the kernel launches of the trace (the runtime
calls ``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaLaunchKernelExC``)
and how many lie inside a root span (``query`` or ``build``) and before
the first, the root's mean host ms (a query or a piece) and its residue,
the root's time outside every stage. ``--smoke`` first runs
``chip_smoke.py``'s phase 16a (one query under ``utils.profiling.trace``,
its launches inside its ``query`` root). The lines are also written to
``chiprun_out/span_probe/<cell>.json``.
"""

import argparse
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from audio_sheet_retrieval_tpu_torch.utils import profiling  # noqa: E402
from port_bench import harness  # noqa: E402
from port_bench import spans as spans_mod  # noqa: E402
from port_bench import trace as trace_mod  # noqa: E402

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
STAGES = ("upload", "vote")              # summed whole
SELF_STAGES = ("decode", "windows", "encoder", "topk")   # self time


def smoke_16a():
    """``chip_smoke.py`` phase 16a on the serving checkpoint and a
    26-piece synthetic gallery."""
    import chip_smoke
    from audio_sheet_retrieval_tpu_torch import assets
    from audio_sheet_retrieval_tpu_torch.data import synthetic
    from audio_sheet_retrieval_tpu_torch.models.configs import (
        get_model_config,
    )
    from audio_sheet_retrieval_tpu_torch.retrieval import accuracy
    from audio_sheet_retrieval_tpu_torch.retrieval.wrapper import (
        load_any_checkpoint,
    )

    dev = torch.device("cuda")
    cfg = get_model_config("mutopia_ccal_cont_rsz")
    params = load_any_checkpoint(
        assets.asset_path("synth_serving_ckpt.pkl"), cfg, device=dev)
    images, specs, _ = synthetic.make_piece_list(
        26, 12, n_performances=1, n_onsets=200)
    gallery = accuracy.build_piece_gallery(params, cfg, images, device=dev)
    ctx = dict(dev=dev, cfg=cfg, params=params, gallery=gallery,
               images=images, specs=[sp[0] for sp in specs])
    print(json.dumps({"16a": chip_smoke.traced_query(ctx)}), flush=True)


def launch_share(tr, spans):
    """-> (launch calls in the trace, those inside a root span, those
    before the first root)."""
    roots = [s for s in spans
             if s["parent"] is None and s["name"] in ("query", "build")]
    a = np.array([s["ts_us"] for s in roots], np.float64)
    b = a + np.array([s["dur_us"] for s in roots], np.float64)
    t = np.array([ts for ts, name in zip(tr.host_start, tr.host_name)
                  if name in LAUNCHES], np.float64)
    i = np.searchsorted(a, t, side="right") - 1
    inside = (i >= 0) & (t <= b[np.maximum(i, 0)])
    return int(t.size), int(inside.sum()), int(np.sum(t < a.min()))


def probe_cell(bench, name, seed, seconds, out_dir):
    drv, state, ctx = harness.setup_cell(bench, name, seed, "cuda:0")
    span = profiling.span
    rows = []
    for mode in ("on", "off", "off", "on", "on", "off"):
        if mode == "off":
            profiling.span = lambda name: profiling._OFF
        try:
            answers, lat, failed, window, tr = harness.measure(
                drv, state, seconds, "cuda:0", True)
        finally:
            profiling.span = span
        work = drv.work(state, answers)
        spans = profiling.take_spans()
        root = "query" if "queries" in work else "build"
        row = dict(cell=name, mode=mode, window_s=window, failed=failed,
                   rate=work["queries" if root == "query" else "windows"]
                   / window, busy_s=trace_mod.busy_s(tr),
                   n_spans=len(spans))
        if mode == "on":
            run = SimpleNamespace(seconds=window, latencies=lat, work=work,
                                  trace=tr, spans=spans, config=ctx.config)
            for m in bench.metrics(name, "per_layer"):
                if m["source"] == "program_span":
                    row[m["name"]] = bench.reader(m["name"])(run)
            row["launches"], row["launches_in_roots"], \
                row["launches_before_first_root"] = launch_share(tr, spans)
            within, n_roots = spans_mod.under(run, root)
            per = work["pieces"] if root == "build" else n_roots
            row["root_ms"] = spans_mod.host_ms(within, [root]) / per
            row["residue_ms"] = row["root_ms"] - (
                spans_mod.host_ms(within, STAGES)
                + spans_mod.self_ms(within, SELF_STAGES)) / per
            row["mean_call_ms"] = float(lat.mean()) * 1e3
        print(json.dumps(row), flush=True)
        rows.append(row)
    drv.release(state)
    torch.cuda.empty_cache()
    with open(os.path.join(out_dir, name + ".json"), "w") as fp:
        json.dump(rows, fp, indent=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=2**31 + 90210)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    out_dir = os.path.join(ROOT, "chiprun_out", "span_probe")
    os.makedirs(out_dir, exist_ok=True)
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    if args.smoke:
        smoke_16a()
    bench = harness.Bench(ROOT)
    for i, name in enumerate(args.cells):
        probe_cell(bench, name, args.seed + i, args.seconds, out_dir)


if __name__ == "__main__":
    main()
