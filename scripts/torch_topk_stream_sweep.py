#!/usr/bin/env python
"""Kernel 1's two pass-1 designs side by side on one CUDA card: the chunked
pass 1 (``chunk_plan``) and the streaming pass 1 (``stream_plan``), each
launched through ``topk_gallery._launch`` on the same inputs.

    python scripts/torch_topk_stream_sweep.py [--out PATH] [--iters N]
        [--q 100 ...] [--n 100000 ...] [--k 25]

For each (Q, N) at d = 32 on unit rows: both designs' outputs must be
bit-identical (scores and indices); then each design's device microseconds
a search (``torch.profiler``, pass 1 and the merge) and its CUDA-event
milliseconds over ``--iters`` calls queued back to back, beside the
search's bound (2 Q N d flops at the float32 peak, or its bytes). The
threshold ``topk_gallery.STREAM_MIN_N`` is read from these rows. Prints
one JSON line a shape and writes all rows, the card's name and power limit
and the kernels' ``ptxas`` report to ``--out`` (default
``chiprun_out/topk_stream_sweep.json``). Without a CUDA card the script
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

F32_FLOPS, HBM_BPS = 67e12, 3.35e12   # H100 SXM data sheet


def bound_us(q: int, n: int, d: int, k: int) -> float:
    return 1e6 * max(2 * q * n * d / F32_FLOPS,
                     (4 * (q + n) * d + 12 * q * k) / HBM_BPS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "topk_stream_sweep.json"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--q", type=int, nargs="+", default=[100])
    ap.add_argument("--n", type=int, nargs="+",
                    default=[20_821, 100_000, 300_000, 1_000_000, 4_194_304])
    ap.add_argument("--k", type=int, default=25)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this sweep "
                         "runs only on a CUDA card")
    from audio_sheet_retrieval_tpu_torch.ops import _native
    from audio_sheet_retrieval_tpu_torch.ops import topk_gallery as tk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    d, k = 32, args.k

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    def queued_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / args.iters

    def device_us(fn) -> dict:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                name = "merge" if "merge" in ev.name else "pass1"
                out[name] = out.get(name, 0.0) + \
                    ev.time_range.elapsed_us() / args.iters
        return out

    rows = []
    for qn in args.q:
        for n in args.n:
            g = unit(torch.randn(n, d, generator=gen, device=dev))
            q = unit(torch.randn(qn, d, generator=gen, device=dev))
            plans = {"chunk": tk.chunk_plan(qn, n, k, d),
                     "stream": tk.stream_plan(qn, n, k, d)}
            outs = {name: tk._launch(q, g, k, p)
                    for name, p in plans.items()}
            same = all(torch.equal(a, b) for a, b in
                       zip(outs["chunk"], outs["stream"]))
            row = {"Q": qn, "N": n, "d": d, "k": k, "bit_identical": same,
                   "bound_us": bound_us(qn, n, d, k),
                   "planned": "stream" if tk.plan(qn, n, k, d).stream
                   else "chunk"}
            for name, p in plans.items():
                fn = (lambda p=p: tk._launch(q, g, k, p))
                dus = device_us(fn)
                row[name] = {"device_us": dus,
                             "device_us_total": sum(dus.values()),
                             "queued_ms": queued_ms(fn),
                             "plan": p._asdict()}
                row[name]["roofline_pct"] = \
                    100 * row["bound_us"] / row[name]["device_us_total"]
            rows.append(row)
            print(json.dumps(row), flush=True)
            assert same, f"Q={qn} N={n}: the two pass-1 designs differ"
    print(smi)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump({"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                   "ptxas": _native.BUILD_LOG.get("topk_gallery", {}).get(
                       "ptxas", ""),
                   "rows": rows}, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
