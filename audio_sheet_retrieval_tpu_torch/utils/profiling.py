"""Profiling / step-time instrumentation.

The port of the JAX package's ``utils/profiling.py``. The reference's only
telemetry is a 5-sample updates/sec running average in the train progress
bar (reference:utils/train_dcca_pool.py:216-231) and a 10-frame fps meter
in the streaming server (audio_sheet_server.py:202-207). Here: a
``torch.profiler`` trace of a block of work (CPU and, where there is a
card, CUDA activity) written as a Chrome trace, a step-time meter, and the
CUDA caching allocator's statistics. The JAX package's persistent compile
cache has no counterpart: eager PyTorch compiles nothing, and the port's
kernels are built once into ``build/torch_kernels``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is visible) and write it to
    ``<log_dir>/trace.json`` (Chrome trace format; chrome://tracing or
    Perfetto read it). Yields the trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


class StepTimer:
    """Running-average step timer (generalizes the reference 'ups' meter)."""

    def __init__(self, window: int = 5):
        self.times = np.zeros(window, np.float64)
        self.n = 0
        self._last: Optional[float] = None

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            self.times[:-1] = self.times[1:]
            self.times[-1] = now - self._last
            self.n += 1
        self._last = now
        return self.steps_per_sec

    @property
    def steps_per_sec(self) -> float:
        k = min(self.n, len(self.times))
        if k == 0:
            return 0.0
        return 1.0 / max(self.times[-k:].mean(), 1e-12)

    @property
    def mean_step_time(self) -> float:
        k = min(self.n, len(self.times))
        return float(self.times[-k:].mean()) if k else 0.0


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of every visible card, keyed
    ``cuda:<i>``; ``{}`` where there is none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
