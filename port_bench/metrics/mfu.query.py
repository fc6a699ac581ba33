"""Queries' model FLOPs per second (each excerpt's embedding and the
search's 2 Q N d) over the float32 peak, in %."""

from port_bench import roofline


def read(run):
    w = run.work
    if run.peaks is None or "queries" not in w:
        return None
    flops = (w["excerpts"] * roofline.embed_flops(run.config, w["view"])
             + w["calls"] * 2 * w["query_rows"] * w["gallery_rows"] * w["d"])
    return 100.0 * flops / run.seconds / run.peaks["f32_flops"]
