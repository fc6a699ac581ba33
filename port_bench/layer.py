"""Arithmetic the per-layer metric readers share."""

from __future__ import annotations

from port_bench import roofline, trace


def conv_roofline(run, count: str):
    """The convs of ``run.work[count]`` windows of the run's view at the
    float32 peak, over the conv kernels' device time, in %."""
    w = run.work
    if run.trace is None or run.peaks is None or count not in w:
        return None
    spent = trace.time_s(run.trace,
                         lambda n: trace.kernel_kind(n) == "conv")
    if not spent:
        return None
    flops = w[count] * sum(roofline.conv_flops(run.config, w["view"]))
    return 100.0 * flops / run.peaks["f32_flops"] / spent


def idle_share(run, count: str):
    """1 - busy / window, in %, for runs that counted ``count``."""
    if run.trace is None or count not in run.work:
        return None
    return 100.0 * (1.0 - trace.busy_s(run.trace) / run.seconds)
