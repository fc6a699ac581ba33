"""The U-Nets' share of their roofline, in %: each `unet` span's tiles
(its recorded count) times one tile's least time (``omr_work``: its FLOPs
at the float32 peak or its bytes at the HBM rate, the larger), over the
spans' device time (CUDA events at their ends), summed over the window."""

from port_bench import omr_work, spans


def read(run):
    if run.peaks is None or "pages" not in run.work:
        return None
    found = spans.under(run, "page")
    if found is None:
        return None
    timed = [s for s in found[0] if s["name"] == "unet"
             and "device_us" in s and "tiles" in s.get("counts", {})]
    spent = sum(s["device_us"] for s in timed) * 1e-6
    if not timed or spent <= 0:
        return None
    h, w = run.config["unet"]["tile"]
    least = sum(s["counts"]["tiles"] for s in timed) \
        * omr_work.unet_bound_s(run.config, h, w, run.peaks)
    return 100.0 * least / spent
