#!/usr/bin/env python
"""Device time of kernel 1's two launches (pass 1 and the merge) at the
shapes of ``scripts/torch_topk_ab.py``, on one CUDA card.

    python scripts/torch_topk_profile.py [--out PATH] [--iters N]

For each (Q, N, k) at d = 32 on unit rows: ``torch.profiler`` over
``--iters`` calls after a warm-up; prints one JSON line with the mean
device microseconds per call of each kernel (by name), their sum, and the
CUDA-event milliseconds of a call (which also hold the host's launch gaps).
The card's name and power limit and all rows go to ``--out`` (default
``build/profile/topk_profile.json``). Without a CUDA card the script exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from torch_topk_ab import SHAPES, median_ms  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile",
                                                  "topk_profile.json"))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this profile "
                         "runs only on a CUDA card")
    from audio_sheet_retrieval_tpu_torch.ops import topk_gallery as tk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for qn, n, k in SHAPES:
        g = torch.randn(n, 32, generator=gen, device=dev)
        q = torch.randn(qn, 32, generator=gen, device=dev)
        g = g / torch.linalg.vector_norm(g, dim=1, keepdim=True)
        q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
        event_ms = median_ms(torch, lambda: tk.topk_gallery(q, g, k),
                             args.iters)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                tk.topk_gallery(q, g, k)
            torch.cuda.synchronize()
        per_kernel = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                name = ("merge" if "merge" in ev.name else
                        "pass1" if "chunk" in ev.name else ev.name[:40])
                per_kernel[name] = per_kernel.get(name, 0.0) + \
                    ev.time_range.elapsed_us() / args.iters
        p = tk.plan(qn, n, k, 32)
        row = {"Q": qn, "N": n, "k": k, "event_ms": event_ms,
               "device_us": per_kernel,
               "device_us_total": sum(per_kernel.values()),
               "plan": p._asdict()}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(smi)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump({"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
                   "rows": rows}, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
