#!/usr/bin/env python
"""Kernel 1 (the gallery top-k) of two checkouts of the port, timed in
alternation on one CUDA card.

    python scripts/torch_topk_ab.py --other DIR [--out PATH]

``DIR`` is another checkout of the repo (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
The script runs one worker process per turn, in the order other, this,
this, other, so that a drift of the card's clocks over the call falls on
both sides alike. Each worker imports its own checkout's
``audio_sheet_retrieval_tpu_torch``, builds that checkout's
``csrc/topk_gallery.cu``, and at each shape of ``SHAPES``:

- checks the kernel against the plain version on the same inputs (scores
  within 1e-4; the index sets equal up to rows tied with the k-th score);
- prints the median CUDA-event time of the kernel and of the plain version
  (after a warm-up).

A shape that a checkout's kernel refuses (k > 1024 before its lists could
sit in global memory) reads ``null``. Each turn prints one JSON line; the
card's name and power limit and all turns go to ``--out`` (default
``build/profile/topk_ab.json``). Without a CUDA card the script exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
# (Q, N, k) at d = 32 on unit rows: serving (Q = 100 excerpts), the
# streaming shapes (Q = 1 frame, Q = 8 a chunk), and large k
SHAPES = [(100, 12_000, 25), (100, 100_000, 25), (100, 1_000_000, 25),
          (1, 12_000, 25), (8, 12_000, 25), (1, 1_000_000, 25),
          (8, 1_000_000, 25), (100, 100_000, 128), (100, 100_000, 1024),
          (100, 100_000, 2048), (8, 3_000, 3_000)]


def median_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def worker(root: str) -> None:
    """Time ``root``'s kernel at every shape; print one JSON line."""
    sys.path.insert(0, root)
    import torch
    from audio_sheet_retrieval_tpu_torch.ops import topk_gallery as tk

    assert os.path.dirname(os.path.abspath(tk.__file__)).startswith(
        os.path.abspath(root)), tk.__file__
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for qn, n, k in SHAPES:
        g = torch.randn(n, 32, generator=gen, device=dev)
        q = torch.randn(qn, 32, generator=gen, device=dev)
        g = g / torch.linalg.vector_norm(g, dim=1, keepdim=True)
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
        try:
            s, i = tk.topk_gallery(q, g, k)
        except ValueError as exc:  # this checkout's kernel refuses k
            rows.append({"Q": qn, "N": n, "k": k, "ms": None,
                         "plain_ms": None, "refused": str(exc)})
            continue
        ps, pi = tk.topk_gallery_plain(q, g, k)
        err = float((s - ps).abs().max())
        assert err <= ATOL, (qn, n, k, err)
        ref = q @ g.T
        for r in range(qn):
            for j in set(i[r].tolist()) ^ set(pi[r].tolist()):
                assert abs(float(ref[r, j] - ps[r, -1])) <= ATOL, (qn, n, k)
        iters = 5 if k > 128 else 20
        rows.append({"Q": qn, "N": n, "k": k, "max_abs_err": err,
                     "ms": median_ms(torch, lambda: tk.topk_gallery(q, g, k),
                                     iters),
                     "plain_ms": median_ms(
                         torch, lambda: tk.topk_gallery_plain(q, g, k),
                         iters)})
    print(json.dumps({"root": root, "rows": rows}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout of the repo")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile",
                                                  "topk_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker)
        return 0
    if not args.other:
        ap.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this A/B "
                         "runs only on a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    other = os.path.abspath(args.other)
    turns = []
    for label, root in (("other", other), ("this", REPO), ("this", REPO),
                        ("other", other)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root], cwd=root, check=True,
                             capture_output=True, text=True).stdout
        turn = json.loads(out.strip().splitlines()[-1])
        turn["label"] = label
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    print(smi)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump({"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                   "shapes": SHAPES, "turns": turns}, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
