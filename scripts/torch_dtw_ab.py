#!/usr/bin/env python
"""The DTW kernels (``csrc/dtw.cu``) of two checkouts of the port, timed in
alternation on one CUDA card.

    python scripts/torch_dtw_ab.py --other DIR [--out PATH] [--iters N]
                                   [--no-sweep]

``DIR`` is another checkout of the repo (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists,
such as ``build/ab_parent``). One worker process per turn, in the order
other, this, this, other, so that a drift of the card's clocks falls on
both sides alike. Each worker imports its own checkout's
``audio_sheet_retrieval_tpu_torch``, builds that checkout's
``csrc/dtw.cu``, makes the matrices of ``SHAPES`` from one seed (random
float32 costs, tall: a corpus piece at the CLI's steps after the
transpose, and the 6,000 x 4,000 alignment the JAX package's docstring
names) and at each shape:

- checks its kernels bit for bit against its own plain versions on the
  card (the accumulated costs; the codes and the final cost where the
  checkout writes them; the path);
- takes the median CUDA-event time of the accumulation (a checkout whose
  kernel reads the scan's diagonal layout pays its shear here, and the
  shear and the bare kernel are timed apart), of the traceback with its
  path download, and of the whole ``dtw_by_dist(return_acc=False)`` on
  the card from a host matrix (host clock, median); and each kernel's time
  queued back to back between two events (the device's own).

Both APIs are handled: the diagonal-layout one (``dtw_accumulate(skew)``,
``dtw_traceback(diagonals)``) and the row-major one
(``dtw_accumulate(dist, return_acc)``, ``dtw_traceback(codes, cost)``).
In the turns of this checkout (unless ``--no-sweep``) the accumulation is
also run, checked and timed (queued) at every (columns a lane, warps a
CTA, chunk) that ``acc_plan`` accepts for the k, warps and chunk lists
below. The main process adds the bound from this checkout's
``chip_smoke.dtw_bound`` (the bytes against the dependency chain, its two
latencies from the one-thread probes ``dtw_cell_probe`` and
``dtw_walk_probe``) and the floor of a design with one CTA-wide barrier
a diagonal (the diagonals times one ``dtw_barrier_rounds`` round at that
design's CTA width). Rows,
the card's name and its power limit go to ``--out`` (default
``build/profile/dtw_ab.json``). Without a CUDA card the script exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [("piece", 860, 604, 3), ("large", 6000, 4000, 9)]
SWEEP_K = (1, 2, 4)
SWEEP_WARPS = (1, 2, 4, 8)
SWEEP_CHUNK = (4, 8, 16)


def queued_ms(torch, fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_ms(fn, n: int) -> float:
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def same_bits(torch, a, b) -> bool:
    na, nb = a.isnan(), b.isnan()
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0, a).view(torch.int32),
        torch.where(nb, 0, b).view(torch.int32)))


def worker(root: str, iters: int, sweep: bool) -> None:
    """Check and time ``root``'s kernels at every shape; one JSON line."""
    sys.path.insert(0, root)
    import torch
    from audio_sheet_retrieval_tpu_torch.ops import _native, dtw
    from torch_topk_ab import median_ms

    assert os.path.dirname(os.path.abspath(dtw.__file__)).startswith(
        os.path.abspath(root)), dtw.__file__
    lib = _native.load("dtw")
    ptxas = [ln.strip() for ln in _native.BUILD_LOG["dtw"]["ptxas"]
             .splitlines() if "Used" in ln or "spill" in ln]
    row_major = hasattr(dtw, "walk_codes_plain")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, r, c, seed in SHAPES:
        dist = np.random.default_rng(seed).random((r, c)).astype(np.float32)
        x = torch.from_numpy(dist).cuda()
        out = torch.empty(2 + 2 * (r + c - 1), dtype=torch.int32,
                          device="cuda")
        row = {"shape": label, "R": r, "C": c, "row_major": row_major}
        if row_major:
            got = dtw.dtw_accumulate(x, return_acc=True)
            ref = dtw.dtw_accumulate_plain(x)
            assert torch.equal(got.codes, ref.codes), label
            assert same_bits(torch, got.acc, ref.acc), label
            assert same_bits(torch, got.cost, ref.cost), label
            path = dtw.dtw_traceback(got.codes, got.cost)
            want = dtw.walk_codes_plain(ref.codes, ref.cost)
            codes, cost = got.codes, got.cost

            def accumulate():
                return dtw.dtw_accumulate(x)

            def traceback():
                return dtw.dtw_traceback(codes, cost)

            def bare_traceback():
                _native.check(lib.dtw_traceback(
                    codes.data_ptr(), r, c, codes.stride(0),
                    cost.data_ptr(), out.data_ptr(), stream), "traceback")
            row["plan"] = list(dtw.acc_plan(c))
        else:
            skew = dtw.skew_to_diagonals(x)
            acc = dtw.dtw_accumulate(skew)
            assert torch.equal(acc, dtw.dtw_accumulate_plain(skew)), label
            path = dtw.dtw_traceback(acc)
            want = dtw.dtw_traceback_plain(acc)

            def accumulate():   # the shear is part of this design's cost
                return dtw.dtw_accumulate(dtw.skew_to_diagonals(x))

            def traceback():
                return dtw.dtw_traceback(acc)

            def bare_traceback():
                _native.check(lib.dtw_traceback(
                    acc.data_ptr(), r, c, out.data_ptr(), stream),
                    "traceback")
            row["shear_event_ms"] = median_ms(
                torch, lambda: dtw.skew_to_diagonals(x), iters)
            row["shear_queued_ms"] = queued_ms(
                torch, lambda: dtw.skew_to_diagonals(x), iters)
            row["kernel_queued_ms"] = queued_ms(
                torch, lambda: dtw.dtw_accumulate(skew), iters)
            row["plan"] = list(dtw.acc_plan(c))
        assert all(np.array_equal(a, b) for a, b in zip(path[:2], want[:2]))
        row.update(
            bit_identical=True, path_len=len(path[0]),
            accumulate_event_ms=median_ms(torch, accumulate, iters),
            accumulate_queued_ms=queued_ms(torch, accumulate, iters),
            traceback_event_ms=median_ms(torch, traceback, iters),
            traceback_queued_ms=queued_ms(torch, bare_traceback, iters),
            dtw_by_dist_ms=host_ms(lambda: dtw.dtw_by_dist(
                dist, return_acc=False, device="cuda"), max(5, iters // 3)))
        if sweep and row_major:
            row["sweep"] = []
            for k in SWEEP_K:
                for warps in SWEEP_WARPS:
                    for chunk in SWEEP_CHUNK:
                        try:
                            p = dtw.acc_plan(c, k, warps, chunk)
                        except ValueError:
                            continue
                        res = dtw.dtw_accumulate(x, _plan=p)
                        assert torch.equal(res.codes, ref.codes), p
                        assert same_bits(torch, res.cost, ref.cost), p
                        row["sweep"].append({
                            "k": k, "warps": p.warps, "ctas": p.ctas,
                            "chunk": chunk, "ring_rows": p.ring_rows,
                            "queued_ms": queued_ms(
                                torch, lambda: dtw.dtw_accumulate(
                                    x, _plan=p), iters)})
        rows.append(row)
    print(json.dumps({"root": root, "ptxas": ptxas, "rows": rows}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout of the repo")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile",
                                                  "dtw_ab.json"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.iters, not args.no_sweep)
        return 0
    if not args.other:
        ap.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this A/B "
                         "runs only on a CUDA card")
    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms, dtw_bound, dtw_latency_ns
    from audio_sheet_retrieval_tpu_torch.ops import _native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    other = os.path.abspath(args.other)
    turns = []
    for label, root in (("other", other), ("this", REPO), ("this", REPO),
                        ("other", other)):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root,
               "--iters", str(args.iters)]
        if label == "other" or args.no_sweep:
            cmd.append("--no-sweep")
        out = subprocess.run(cmd, cwd=root, check=True, capture_output=True,
                             text=True).stdout
        turn = json.loads(out.strip().splitlines()[-1])
        turn["label"] = label
        turns.append(turn)
        print(json.dumps({k: v for k, v in turn.items() if k != "rows"}
                         | {"rows": [{k: v for k, v in row.items()
                                      if k != "sweep"}
                                     for row in turn["rows"]]}), flush=True)
    # the yardstick, from this checkout: the probes and the barrier floor
    cell_ns = dtw_latency_ns(torch, "dtw_cell_probe")
    walk_ns = dtw_latency_ns(torch, "dtw_walk_probe")
    lib = _native.load("dtw")
    bounds = []
    for label, r, c, _ in SHAPES:
        n_path = next(row["path_len"] for row in turns[1]["rows"]
                      if row["shape"] == label)
        b_ms, b_by, bytes_ms, chain_ms = dtw_bound(r, c, n_path, cell_ns,
                                                   walk_ns)
        threads = min(1024, -(-c // 32) * 32)
        scratch = torch.empty(threads, dtype=torch.int32, device="cuda")
        n_diag = r + c - 1
        floor_ms = cuda_ms(lambda: _native.check(lib.dtw_barrier_rounds(
            n_diag, threads, scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "barrier"), iters=10)
        bounds.append({"shape": label, "bound_ms": b_ms, "bound_by": b_by,
                       "bytes_ms": bytes_ms, "chain_ms": chain_ms,
                       "cell_ns": cell_ns, "walk_step_ns": walk_ns,
                       "path_len": n_path,
                       "barrier_floor_ms": floor_ms,
                       "barrier_threads": threads})
    summary = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
               "shapes": SHAPES, "bounds": bounds, "turns": turns}
    print(json.dumps({"bounds": bounds}))
    print(smi)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(summary, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
