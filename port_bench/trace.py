"""The traced window: ``torch.profiler`` over the card's activity, read back
from its Chrome trace as device intervals and runtime calls.

Only the CUDA activity is recorded (kernels, copies, memsets and the CUDA
runtime calls that launched them), not every host-side ATen call, which
keeps a window's trace to a few hundred thousand events. The busy time is
the union of the device intervals (the arithmetic of the port's
``scripts/torch_profile_serving.py::device_summary``); kernels are sorted
into kinds by name (``chip_smoke.py::kernel_kind``, with cuDNN's FFT
kernels counted as convs).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
from typing import List, NamedTuple, Optional

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
TOPK_KERNELS = ("topk_chunk", "topk_merge")   # csrc/topk_gallery.cu


class Trace(NamedTuple):
    start: np.ndarray        # device intervals, microseconds
    end: np.ndarray
    name: List[str]
    cat: List[str]
    host_start: np.ndarray   # runtime / driver calls, microseconds
    host_end: np.ndarray
    host_name: List[str]


def read_chrome_trace(path: str) -> Trace:
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e.get("dur", 0.0)),
                        e.get("name", ""), cat))
        elif cat in HOST_CATS:
            host.append((float(e["ts"]), float(e.get("dur", 0.0)),
                         e.get("name", "")))
    dev.sort(key=lambda r: r[0])
    host.sort(key=lambda r: r[0])
    ds = np.array([r[0] for r in dev], np.float64)
    de = ds + np.array([r[1] for r in dev], np.float64)
    hs = np.array([r[0] for r in host], np.float64)
    he = hs + np.array([r[1] for r in host], np.float64)
    return Trace(ds, de, [r[2] for r in dev], [r[3] for r in dev],
                 hs, he, [r[2] for r in host])


@contextlib.contextmanager
def device_trace(enabled: bool):
    """Profile the card inside the block; afterwards ``holder["trace"]``
    is the ``Trace`` (the file is written to ``TMPDIR`` and removed)."""
    holder = {}
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        yield holder
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        holder["trace"] = read_chrome_trace(path)
        print(f"trace: {os.path.getsize(path)} bytes, "
              f"{holder['trace'].start.size} device events", file=sys.stderr)
    finally:
        os.unlink(path)


def merged(start: np.ndarray, end: np.ndarray):
    """Sorted intervals -> their union as disjoint (start, end) arrays."""
    if start.size == 0:
        return start, end
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    ends = np.append(run_end[idx[1:] - 1], run_end[-1])
    return s[idx], ends


def busy_s(tr: Trace) -> float:
    """Seconds in which some device activity ran."""
    s, e = merged(tr.start, tr.end)
    return float(np.sum(e - s)) * 1e-6


def kernel_kind(name: str) -> str:
    """A device activity's kind by its kernel name (cuDNN / ATen)."""
    low = name.lower()
    if "dgrad" in low:
        return "transposed conv"
    if "pool" in low:
        return "pool"
    if any(k in low for k in ("fprop", "conv", "gemm", "winograd", "xmma",
                              "cutlass", "implicit", "fft")):
        return "conv"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout"
    if "elementwise" in low:
        return "elementwise"
    if low.startswith(("memcpy", "memset")):
        return "copy"
    return "other"


def is_topk(name: str) -> bool:
    return any(k in name for k in TOPK_KERNELS)


def time_s(tr: Trace, keep) -> Optional[float]:
    """Summed device seconds of the kernels whose name ``keep`` accepts;
    None when there are none."""
    d = [e - s for s, e, n, c in zip(tr.start, tr.end, tr.name, tr.cat)
         if c == "kernel" and keep(n)]
    return float(np.sum(d)) * 1e-6 if d else None


def n_kernels(tr: Trace) -> int:
    return sum(1 for c in tr.cat if c == "kernel")


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the runtime call the host was in (or, between
    calls, by the device operation that ended the gap)."""
    by_name = {}
    for s, e, n in zip(tr.start, tr.end, tr.name):
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    s, e = merged(tr.start, tr.end)
    gaps = []
    if s.size > 1:
        gap = s[1:] - e[:-1]
        for i in np.argsort(-gap, kind="stable")[:top]:
            mid = 0.5 * (e[i] + s[i + 1])
            inside = np.flatnonzero((tr.host_start <= mid)
                                    & (tr.host_end >= mid))
            if inside.size:
                j = inside[np.argmin(tr.host_end[inside]
                                     - tr.host_start[inside])]
                label = f"host in {tr.host_name[j]}"
            else:
                nxt = int(np.searchsorted(tr.start, s[i + 1]))
                label = f"host before {tr.name[min(nxt, len(tr.name) - 1)]}"
            gaps.append([label[:160], float(gap[i]) * 1e-6])
    return {"device_ops": [[n[:160], float(v)] for n, v in ops],
            "idle_gaps": gaps}
