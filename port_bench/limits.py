"""Readings that a cell's limits are set from, in one process.

    python3 port_bench/limits.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 --seconds 3 [--out <file.json>]

For each of ``--seeds``: one run of the program (a short window at the
cell's own load, then the check), its compared numbers. For each of
``--control-seeds``: the cell set up from that seed, and the plain
reference computed in TF32 (the step below the configs' float32) judged
against the float32 reference in the program's place: the control's
numbers. A limit lies above the largest program reading and below the
smallest control reading. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_readings(bench, workload: str, seed: int, device) -> dict:
    import torch

    from port_bench import harness

    drv, state, _ = harness.setup_cell(bench, workload, seed, device)
    drv.release(state)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    f32 = drv.reference(state, "f32")
    tf32 = drv.reference(state, "tf32")
    return drv.compare(tf32, f32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from port_bench import harness

    bench = harness.Bench(ROOT)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for s in filter(None, args.seeds.split(",")):
        t = time.perf_counter()
        r = harness.run_cell(bench, args.workload, int(s), args.seconds,
                             False, device=args.device)
        emit({"side": "program", "seed": int(s), "correct": r["correct"],
              "attempted": r["attempted"],
              "checks": {k: v["value"] for k, v in r["checks"].items()},
              "metrics": {k: v["value"] for k, v in r["metrics"].items()},
              "seconds": time.perf_counter() - t})
        gc.collect()
    for s in filter(None, args.control_seeds.split(",")):
        t = time.perf_counter()
        emit({"side": "control", "seed": int(s),
              "checks": control_readings(bench, args.workload, int(s),
                                         args.device),
              "seconds": time.perf_counter() - t})
        gc.collect()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fp:
            json.dump({"workload": args.workload, "rows": rows}, fp,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
