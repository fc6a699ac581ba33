"""Run one cell of ``BENCHMARK.json`` once, on the card it is started on.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Loads and warms up the cell (set-up, reported as ``setup_s``), measures for
``--seconds`` (an open loop: every query due in them, to its answer),
checks what the timed path produced against the plain
reference, and prints one JSON object as its last line of standard output:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a device trace of the window. The numbers the
check compared, each beside its limit, are the last lines of standard error
and the ``checks`` key of that object. Exits non-zero without a result when
there is no CUDA card, too few cards for the cell, or when JAX or the JAX
package was loaded. Build and kernel caches stay inside the checkout
(``build/``).
"""

from __future__ import annotations

import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as fp:
            start_ticks = float(fp.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fp:
            uptime = float(fp.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age_s()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pin_caches() -> None:
    build = os.path.join(ROOT, "build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(build, sub)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _pin_caches()
    sys.path.insert(0, ROOT)
    from port_bench import harness

    bench = harness.Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not os.path.isdir(os.path.join(ROOT,
                                      "audio_sheet_retrieval_tpu_torch")):
        print("the port's package is not in this checkout", file=sys.stderr)
        return 4
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    torch.zeros(1, device="cuda:0")
    print(f"set-up s: to the card {time.perf_counter() - T0:.3f}",
          file=sys.stderr)
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda:0", t0=T0)
    found = harness.banned_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
