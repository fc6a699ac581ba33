#!/usr/bin/env python
"""Kernel 2 (the feature-window gather) of two checkouts of the port, timed
in alternation on one CUDA card.

    python scripts/torch_gather_ab.py --other DIR [--out PATH] [--iters N]

``DIR`` is another checkout of the repo (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
One worker process per turn, in the order other, this, this, other, so that
a drift of the card's clocks falls on both sides alike. Each worker imports
its own checkout's ``audio_sheet_retrieval_tpu_torch``, builds that
checkout's ``csrc/feature_windows.cu``, and at each shape of ``SHAPES``:

- checks the kernel bit for bit against the plain version on the same
  inputs;
- takes the median CUDA-event time of a call (which holds the host's
  launch gap) and, with ``torch.profiler``, the mean device microseconds of
  the launch itself;
- takes both times of the library's one call for the same function, a
  ``torch.gather`` along the columns of the plane expanded over the windows
  (checked bit for bit too; the port never calls it).

Each row carries the least time the card could take (this checkout's
``chip_smoke.gather_bound``: the sectors of the plane that these windows
reach and the starts read once, the windows written once, at 3.35 TB/s) and
the share of that rate the launch's device time reaches. Rows, the card's
name and its power limit go to ``--out`` (default
``build/profile/gather_ab.json``). Without a CUDA card the script exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, C, H4, Wq, n_cols, N, dtype, starts): "stride" = every 25th
# half-res column as a gallery build takes them (odd and even starts in
# turn), "random" = seeded starts of both parities over the legal range
SHAPES = [("serving", 24, 40, 3019, 50, 117, "float32", "stride"),
          ("serving", 24, 40, 3019, 50, 117, "bfloat16", "stride"),
          ("one window", 24, 40, 3019, 50, 1, "float32", "random"),
          ("eight windows", 24, 40, 3019, 50, 8, "float32", "random"),
          ("thousand windows", 24, 40, 3019, 50, 1000, "float32", "random"),
          ("thousand windows", 24, 40, 3019, 50, 1000, "bfloat16", "random"),
          ("short strip", 24, 40, 299, 50, 9, "float32", "stride"),
          ("mixed parity", 24, 40, 3019, 50, 117, "float32", "random")]


def make_starts(shape) -> np.ndarray:
    _, _, _, wq, n_cols, n, _, kind = shape
    smax = wq - 2 * (n_cols - 1)  # starts lie in [0, smax)
    if kind == "stride":
        starts = np.arange(0, smax, 25)[:n]
    else:
        starts = np.random.default_rng(n).integers(0, smax, n)
    assert len(starts) == n, (shape, len(starts))
    return starts.astype(np.int32)


def device_us(torch, fn, iters: int) -> float:
    """Mean device microseconds of the kernels one ``fn()`` launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / iters


def worker(root: str, iters: int) -> None:
    """Time ``root``'s kernel at every shape; print one JSON line."""
    sys.path.insert(0, root)
    import torch
    from audio_sheet_retrieval_tpu_torch.ops import windows as win
    from torch_topk_ab import median_ms

    assert os.path.dirname(os.path.abspath(win.__file__)).startswith(
        os.path.abspath(root)), win.__file__
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape in SHAPES:
        _, c, h4, wq, n_cols, n, dtype, _ = shape
        plane = torch.randn(c, h4, wq, generator=gen, device=dev).to(
            getattr(torch, dtype))
        starts = torch.from_numpy(make_starts(shape)).to(dev)
        idx = (starts.long()[:, None] + 2 * torch.arange(n_cols, device=dev))[
            :, None, None, :].expand(n, c, h4, n_cols)
        wide = plane[None].expand(n, -1, -1, -1)

        def kernel():
            return win.gather_feature_windows(plane, starts, n_cols)

        def library():
            return torch.gather(wide, 3, idx)

        want = win.gather_feature_windows_plain(plane, starts, n_cols)
        assert torch.equal(kernel(), want), shape
        assert torch.equal(library(), want), shape
        rows.append({"shape": shape[0], "Wq": wq, "N": n, "dtype": dtype,
                     "bit_identical": True,
                     "event_ms": median_ms(torch, kernel, iters),
                     "device_us": device_us(torch, kernel, iters),
                     "library_event_ms": median_ms(torch, library, iters),
                     "library_device_us": device_us(torch, library, iters)})
    print(json.dumps({"root": root, "rows": rows}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout of the repo")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile",
                                                  "gather_ab.json"))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.iters)
        return 0
    if not args.other:
        ap.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this A/B "
                         "runs only on a CUDA card")
    sys.path.insert(0, REPO)
    from chip_smoke import gather_bound

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    bounds = [gather_bound(s[1], s[2], s[3], s[4], make_starts(s),
                           2 if s[6] == "bfloat16" else 4)[0]
              for s in SHAPES]
    other = os.path.abspath(args.other)
    turns = []
    for label, root in (("other", other), ("this", REPO), ("this", REPO),
                        ("other", other)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root, "--iters", str(args.iters)],
                             cwd=root, check=True, capture_output=True,
                             text=True).stdout
        turn = json.loads(out.strip().splitlines()[-1])
        turn["label"] = label
        for row, bound_ms in zip(turn["rows"], bounds):
            row["bound_ms"] = bound_ms
            row["share_of_bound"] = bound_ms * 1e3 / row["device_us"]
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
