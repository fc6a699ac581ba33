"""The labelling kernel's share of the HBM rate, in %: each page's least
labelling traffic (``omr_work.label_bytes``: the u8 mask read and the
int32 labels written once) at 3.35 TB/s, over the device time of the
``omr_label_*`` kernels (``csrc/omr_geometry.cu``) in the window."""

from port_bench import omr_work, trace


def read(run):
    w = run.work
    if run.trace is None or run.peaks is None or "pages" not in w:
        return None
    spent = trace.time_s(run.trace, lambda n: "omr_label" in n)
    if not spent:
        return None
    h, wd = w["page_shape"]
    least = w["calls"] * omr_work.label_bytes(h, wd) \
        / run.peaks["hbm_bytes_per_s"]
    return 100.0 * least / spent
