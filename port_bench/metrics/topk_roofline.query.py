"""Kernel 1's share of its roofline, in %: the least time of each query's
search (2 Q N d FLOPs at the float32 peak or its bytes at the HBM rate, the
larger) over kernel 1's device time (``topk_chunk*`` and ``topk_merge*``
kernels), summed over the traced window."""

from port_bench import roofline, trace


def read(run):
    w = run.work
    if run.trace is None or run.peaks is None or "queries" not in w:
        return None
    spent = trace.time_s(run.trace, trace.is_topk)
    if not spent:
        return None
    least = w["calls"] * roofline.topk_bound_s(
        w["query_rows"], w["gallery_rows"], w["d"], w["k"], run.peaks)
    return 100.0 * least / spent
