"""Windows per second times the sheet embedding's FLOPs, over the float32
peak, in %."""

from port_bench import roofline


def read(run):
    if run.peaks is None or "windows" not in run.work:
        return None
    flops = run.work["windows"] * roofline.embed_flops(run.config, 1)
    return 100.0 * flops / run.seconds / run.peaks["f32_flops"]
