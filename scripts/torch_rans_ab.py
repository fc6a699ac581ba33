#!/usr/bin/env python
"""The rANS decode and encode kernels (``csrc/rans.cu``) of two checkouts
of the port, timed in alternation on one CUDA card.

    python scripts/torch_rans_ab.py --other DIR [--out PATH] [--iters N]
                                    [--no-sweep]

``DIR`` is another checkout of the repo (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists,
such as ``build/ab_parent``). One worker process per turn, in the order
other, this, this, other, so that a drift of the card's clocks falls on
both sides alike. Each worker imports its own checkout's
``audio_sheet_retrieval_tpu_torch``, builds that checkout's
``csrc/rans.cu``, makes the payloads of ``SHAPES`` from one seed (the
sizes of ``chip_smoke.py`` phase 18a, synthetic bytes of about the real
payloads' entropy) and at each shape:

- checks the kernel bit for bit against the plain version on the card;
- takes the median CUDA-event time of a call and the time a call takes
  queued back to back between two events (the device's own, as the card
  never waits for the host);
- for the encode, the same two times with ``w_budget`` = 0, which skips
  placing the stream into ``words``: the step loop alone, and the tail
  (the copy of the stream, or its placement) as the difference.

In the turns of this checkout (unless ``--no-sweep``) each decode shape is
also decoded at every lane count a thread that covers its lanes
(``decode_plan(S, g)``), each checked bit for bit, for the sweep of
(G, threads). The main process adds each row's bound with this
checkout's ``chip_smoke.rans_bound`` (the bytes at 3.35 TB/s against K
barrier rounds of ``rans_bound_threads(S)``, the narrowest CTA that holds
S lanes at 16 a thread, the larger; the same for both checkouts) and the
microseconds a step (queued ms / K). Rows, the barrier rounds, the card's name and its
power limit go to ``--out`` (default ``build/profile/rans_ab.json``).
Without a CUDA card the script exits non-zero.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, op, P, n, S, w_budget, data kind, parameter)
SHAPES = [("bitmaps", "decode", 60, 25_600, 128, 0, "skewed", 0.8),
          ("spectrograms", "decode", 60, 158_240, 256, 0, "skewed", 0.12),
          ("page_segments", "decode", 4, 246_534, 2048, 0, "skewed", 0.5),
          ("map_plane", "encode", 1, 986_135, 2048, 389_030, "zeros", 0.6)]


def payloads(shape) -> list:
    """The shape's P byte arrays, from one seed a shape: geometric bytes
    (``skewed``, parameter p) or zeros with probability p, else uniform."""
    label, _, P, n, _, _, kind, q = shape
    rng = np.random.default_rng(len(label) * 1009 + n)
    if kind == "skewed":
        return [np.minimum(rng.geometric(q, n) - 1, 255).astype(np.uint8)
                for _ in range(P)]
    return [np.where(rng.random(n) < q, 0, rng.integers(0, 256, n))
            .astype(np.uint8) for _ in range(P)]


def lane_counts(rans, S) -> list:
    """Every (G, threads) that covers S lanes, but a G whose CTA is as
    wide as half that G's (one warp of mostly idle lanes)."""
    out = []
    for g in (1, 2, 4, 8, 16):
        try:
            plan = rans.decode_plan(S, g)[:2]
        except ValueError:
            continue
        if not out or out[-1][1] != plan[1]:
            out.append(plan)
    return out


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


def worker(root: str, iters: int, sweep: bool) -> None:
    """Check and time ``root``'s kernels at every shape; one JSON line."""
    sys.path.insert(0, root)
    import torch
    from audio_sheet_retrieval_tpu_torch.ops import _native
    from audio_sheet_retrieval_tpu_torch.ops import rans
    from torch_topk_ab import median_ms

    assert os.path.dirname(os.path.abspath(rans.__file__)).startswith(
        os.path.abspath(root)), rans.__file__
    _native.load("rans")
    ptxas = [ln.strip() for ln in _native.BUILD_LOG["rans"]["ptxas"]
             .splitlines() if "Used" in ln or "spill" in ln]
    has_lanes = "_lanes" in inspect.signature(
        rans.rans_decode_kernel).parameters
    dev = torch.device("cuda")
    rows = []
    for shape in SHAPES:
        label, op, P, n, S, w_budget, _, _ = shape
        arrays = payloads(shape)
        if op == "decode":
            freqs, states, words, _ = rans.rans_encode_batch(arrays, S)
            f = rans._bits(freqs, torch.int16, dev)
            s = rans._bits(states, torch.int32, dev)
            w = rans._bits(words, torch.int16, dev)
            plain = rans.rans_decode_batch_plain(
                rans._wide(f), rans._wide(s), rans._wide(w), n)
            assert torch.equal(plain.cpu(), torch.from_numpy(
                np.stack(arrays))), label

            def call(g=None, budget=None):
                kw = {"_lanes": g} if g is not None else {}
                return rans.rans_decode_kernel(f, s, w, n, **kw)

            def same(out):
                return bool(torch.equal(out, plain))
        else:
            data = arrays[0]
            freqs = rans.quantize_freqs(np.bincount(data, minlength=256) + 1)
            d = torch.from_numpy(data).to(dev)
            f = rans._bits(freqs, torch.int16, dev)
            pad = int(np.argmax(freqs))
            plain = rans.rans_encode_plain(d.to(torch.int64), rans._wide(f),
                                           S, w_budget, pad)

            def call(budget=w_budget):
                return rans.rans_encode_kernel(d, f, S, budget, pad)

            def same(out):
                st, wd, nw = out
                return (bool(torch.equal(rans._wide(st), plain[0]))
                        and bool(torch.equal(rans._wide(wd), plain[1]))
                        and int(nw) == int(plain[2]))
        assert same(call()), f"{label}: kernel != plain"
        row = {"shape": label, "op": op, "P": P, "n": n, "S": S,
               "K": -(-n // S), "bit_identical": True,
               "event_ms": median_ms(torch, call, iters),
               "queued_ms": queued_ms(torch, call, iters)}
        if op == "decode":
            row["w_max"] = int(words.shape[1])
        else:
            row.update(w_budget=w_budget, n_words=int(plain[2]),
                       loop_event_ms=median_ms(
                           torch, lambda: call(budget=0), iters),
                       loop_queued_ms=queued_ms(
                           torch, lambda: call(budget=0), iters))
            row["tail_queued_ms"] = row["queued_ms"] - row["loop_queued_ms"]
        if sweep and has_lanes and op == "decode":
            row["sweep"] = []
            for g, threads in lane_counts(rans, S):
                assert same(call(g)), f"{label}: G={g} kernel != plain"
                row["sweep"].append({
                    "g": g, "threads": threads,
                    "event_ms": median_ms(torch, lambda: call(g), iters),
                    "queued_ms": queued_ms(torch, lambda: call(g), iters)})
        rows.append(row)
    print(json.dumps({"root": root, "ptxas": ptxas, "rows": rows}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout of the repo")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile",
                                                  "rans_ab.json"))
    ap.add_argument("--iters", type=int, default=30)
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
    from chip_smoke import rans_bound, rans_bound_threads

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
        print(json.dumps(turn), flush=True)
    # the yardstick: this checkout's chip_smoke.rans_bound at each width
    rounds = {}
    for threads in (32, 64, 128, 256, 512, 1024):
        rounds[threads] = rans_bound(torch, 0, 1, threads)[4]
    bounds = []
    for shape in SHAPES:
        label, op, P, n, S, w_budget = shape[:6]
        K = -(-n // S)
        row = next(r for r in turns[1]["rows"] if r["shape"] == label)
        if op == "decode":
            nbytes = 2 * row["w_max"] * P + 4 * S * P + 512 * P + P * n
        else:
            nbytes = n + 512 + 4 * S + 2 * w_budget + 4
        threads = rans_bound_threads(S)
        b = rans_bound(torch, nbytes, K, threads)
        bounds.append({"shape": label, "threads": threads,
                       "bound_ms": b[0], "bound_by": b[1], "bytes_ms": b[2],
                       "barrier_floor_ms": b[3], "barrier_round_ns": b[4]})
    for turn in turns:
        for row in turn["rows"]:
            row["us_a_step"] = row["queued_ms"] * 1e3 / row["K"]
            for sw in row.get("sweep", []):
                sw["us_a_step"] = sw["queued_ms"] * 1e3 / row["K"]
                sw["barrier_round_ns"] = rounds[sw["threads"]]
    summary = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
               "shapes": SHAPES, "barrier_round_ns": rounds,
               "bounds": bounds, "turns": turns}
    print(json.dumps({"bounds": bounds, "barrier_round_ns": rounds}))
    print(smi)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(summary, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
