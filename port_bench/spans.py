"""The program's spans in a traced window, and the arithmetic of the
metrics that read them.

The port (``audio_sheet_retrieval_tpu_torch/utils/profiling.py``) records
a span only while a ``torch.profiler`` session runs: in a run of a cell,
the traced window alone. The first reader takes them
(``profiling.take_spans``, on the clock of the window's device trace) and
keeps them on the run for the others. A program that records no spans
gives None, and so does every reader.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np

from port_bench import trace


def of(run) -> Optional[List[dict]]:
    """The window's spans, or None where the program recorded none."""
    if not hasattr(run, "spans"):
        from audio_sheet_retrieval_tpu_torch.utils import profiling

        take = getattr(profiling, "take_spans", None)
        run.spans = take() if take is not None else []
    return run.spans or None


def under(run, root: str):
    """-> (the spans under roots named ``root``, roots included; the
    number of those roots), or None where there are none."""
    spans = of(run)
    if spans is None:
        return None
    roots = {s["id"] for s in spans
             if s["parent"] is None and s["name"] == root}
    if not roots:
        return None
    return [s for s in spans if s["root"] in roots], len(roots)


def host_ms(spans: List[dict], names: Iterable[str]) -> float:
    """Summed milliseconds inside the spans named ``names``."""
    names = set(names)
    return sum(s["dur_us"] for s in spans if s["name"] in names) * 1e-3


def self_ms(spans: List[dict], names: Iterable[str]) -> float:
    """Summed self time, in ms, of the spans named ``names``: each span's
    length less its children's."""
    names = set(names)
    child_us = {}
    for s in spans:
        if s["parent"] is not None:
            child_us[s["parent"]] = child_us.get(s["parent"], 0.0) \
                + s["dur_us"]
    return sum(s["dur_us"] - child_us.get(s["id"], 0.0)
               for s in spans if s["name"] in names) * 1e-3


def idle_inside(run, root: str) -> Optional[float]:
    """The time inside ``root`` spans in which no device interval of the
    window's trace runs, over the window, in %."""
    found = under(run, root)
    if found is None or run.trace is None:
        return None
    roots = [s for s in found[0] if s["parent"] is None]
    a = np.array([s["ts_us"] for s in roots], np.float64)
    b = a + np.array([s["dur_us"] for s in roots], np.float64)
    a, b = trace.merged(a, b)
    ds, de = trace.merged(run.trace.start, run.trace.end)
    busy = _busy_before(ds, de, b) - _busy_before(ds, de, a)
    return 100.0 * float(np.sum(b - a) - np.sum(busy)) * 1e-6 / run.seconds


def _busy_before(ds: np.ndarray, de: np.ndarray, t: np.ndarray
                 ) -> np.ndarray:
    """Device-busy µs before each time ``t``, over disjoint sorted
    intervals [ds, de)."""
    if ds.size == 0:
        return np.zeros_like(t)
    cum = np.concatenate([[0.0], np.cumsum(de - ds)])
    i = np.searchsorted(ds, t, side="right")    # intervals begun by t
    last = np.maximum(i - 1, 0)
    still = np.where(i > 0, np.maximum(de[last] - t, 0.0), 0.0)
    return cum[i] - still
