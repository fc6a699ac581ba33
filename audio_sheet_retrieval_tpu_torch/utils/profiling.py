"""Profiling: a ``torch.profiler`` trace of a block of work, the port's
spans, and the CUDA caching allocator's statistics.

The port of the JAX package's ``utils/profiling.py``. The reference's only
telemetry is a 5-sample updates/sec running average in the train progress
bar (reference:utils/train_dcca_pool.py:216-231) and a 10-frame fps meter
in the streaming server (audio_sheet_server.py:202-207). Here: a
``torch.profiler`` trace of a block of work (CPU and, where there is a
card, CUDA activity) written as a Chrome trace with the spans recorded in
it, and the CUDA caching allocator's statistics. The JAX package's
persistent compile cache has no counterpart: eager PyTorch compiles
nothing, and the port's kernels are built once into
``build/torch_kernels``.

Spans name the stages of the query and gallery-build paths: the roots
``query`` (one fused piece-ID query, ``retrieval/gallery.py``) and
``build`` (``retrieval/accuracy.py::build_piece_gallery``), and inside
them ``upload`` (a host -> device copy), ``decode`` (a wire's inverse),
``windows`` (the window cut), ``encoder`` (encoder, CCA, L2), ``topk``
(kernel 1's launch) and ``vote``. A span is recorded only while a
``torch.profiler`` session runs (``torch.autograd.profiler.
_is_profiler_enabled``, which the profiler sets on start and clears on
stop, whatever its activities); otherwise ``span`` returns one shared
no-op context and records nothing. A recorded span keeps its name, its
start and end (``time.time_ns``) and the ids of its parent and of its
root, in memory until ``take_spans`` returns them on the clock of the
profiler's Chrome trace, or until the next profiler session starts and
drops them. Inside ``trace`` a span also opens a ``record_function``
range, so the trace file shows it beside the kernels; other sessions do
without that range and its cost.

The OMR page path (``retrieval/umc.py::make_page_query``) adds the root
``page`` and inside it ``unet`` (one U-Net's tiles, blend and codes),
``geometry`` (the system boxes on the device) and ``strip`` (the boxes'
download and the unroll), beside ``upload`` and the sheet query's own
stages. A span may carry counts (``note``: a page's ``tiles`` in each
``unet``, its ``systems`` in ``strip``) and, given a CUDA ``device``, the
device time between two CUDA events recorded at its ends (``unet``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# Kineto rounds its traces' base time down to a multiple of this many
# seconds (about three months)
_KINETO_BASE_SECONDS = 7889238


class _Spans:
    """The spans of this process: the finished ones, each thread's open
    ones, and whether a span opens a ``record_function`` range too."""

    def __init__(self):
        self.done = []
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.ranges = False


_SPANS = _Spans()
_OFF = contextlib.nullcontext()


def _on_profiler_start(start=_autograd_profiler._run_on_profiler_start):
    """A profiler session starts with none of an earlier one's spans:
    every session's start calls ``torch.autograd.profiler.
    _run_on_profiler_start``, which this replaces."""
    _SPANS.done = []
    start()


_autograd_profiler._run_on_profiler_start = _on_profiler_start


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "range", "counts",
                 "device", "events")

    def __init__(self, name: str, device=None):
        self.name = name
        self.counts = None
        self.device = device

    def __enter__(self):
        local = _SPANS.local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        self.id = next(_SPANS.ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.events = None
        if self.device is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.range = None
        if _SPANS.ranges:
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _SPANS.local.stack.pop()
        _SPANS.done.append((self.start, end, self.id, self.parent,
                            self.root, self.name, self.counts, self.events))
        return False


def span(name: str, device=None):
    """A context manager that records the block as the span ``name``
    while a ``torch.profiler`` session runs; otherwise one shared no-op
    context. With a CUDA ``device`` the span also times its block on that
    device's current stream (two CUDA events)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if device is not None and torch.device(device).type != "cuda":
        device = None
    return _Span(name, device)


def note(key: str, value) -> None:
    """Add ``value`` to the count ``key`` of the innermost open span of
    this thread; nothing while no span is recorded."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = getattr(_SPANS.local, "stack", None)
    if not stack:
        return
    top = stack[-1]
    if top.counts is None:
        top.counts = {}
    top.counts[key] = top.counts.get(key, 0) + value


def trace_base_ns() -> int:
    """The base time, in Unix ns, of the Chrome traces ``torch.profiler``
    exports now: their ``baseTimeNanoseconds``, which each event's ``ts``
    (µs) is counted from. Kineto takes the current time rounded down to a
    multiple of 7,889,238 s (libkineto's ``ChromeTraceBaseTime``; PyTorch's
    ``torch/profiler/_cupti_monitor_trace.py::_default_base_ns`` repeats
    the arithmetic, "matching Kineto"). So spans taken across such a
    boundary from their trace's export are off by that many seconds."""
    return ((int(time.time()) // _KINETO_BASE_SECONDS)
            * _KINETO_BASE_SECONDS * 1_000_000_000)


def take_spans(base_ns: Optional[int] = None) -> List[dict]:
    """The spans finished since the last call, by start, and forgets them.
    Each is a dict: ``name``, ``id``, ``parent`` (None for a root),
    ``root`` (its own id for a root), and ``ts_us`` and
    ``dur_us`` on a Chrome trace's clock: Unix µs less ``base_ns``
    (default ``trace_base_ns()``); ``counts`` where the span has any
    (``note``), ``device_us`` where it was timed on a device (waits for
    its end event)."""
    done, _SPANS.done = _SPANS.done, []
    base = trace_base_ns() if base_ns is None else base_ns
    out = []
    for start, end, i, parent, root, name, counts, events in sorted(
            done, key=lambda s: s[0]):
        s = dict(name=name, id=i, parent=parent, root=root,
                 ts_us=(start - base) / 1e3, dur_us=(end - start) / 1e3)
        if counts:
            s["counts"] = dict(counts)
        if events is not None:
            events[1].synchronize()
            s["device_us"] = events[0].elapsed_time(events[1]) * 1e3
        out.append(s)
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is visible) and write it to
    ``<log_dir>/trace.json`` (Chrome trace format; chrome://tracing or
    Perfetto read it), with each span of the block as a ``record_function``
    range, and the spans as ``take_spans`` gives them to
    ``<log_dir>/spans.json``, counted from the base time the trace file
    declares. Yields the trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    _SPANS.ranges = True
    try:
        with profile(activities=activities) as prof:
            yield path
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        _SPANS.ranges = False
    prof.export_chrome_trace(path)
    with open(path) as fp:
        # a trace that declares no base counts from the Unix epoch
        base = int(json.load(fp).get("baseTimeNanoseconds", 0))
    with open(os.path.join(log_dir, "spans.json"), "w") as fp:
        json.dump(take_spans(base), fp)


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of every visible card, keyed
    ``cuda:<i>``; ``{}`` where there is none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
