"""Pages' model FLOPs per second over the float32 peak, in %: each page's
U-Net tiles (both detectors, ``omr_work``), its windows' sheet embedding
and the search's 2 Q N d."""

from port_bench import omr_work, roofline


def read(run):
    w = run.work
    if run.peaks is None or "pages" not in w:
        return None
    th, tw = run.config["unet"]["tile"]
    unet = omr_work.unet_work(run.config, th, tw)[0]
    flops = (w["pages"] * w["tiles_per_page"] * unet
             + w["excerpts"] * roofline.embed_flops(run.config, w["view"])
             + w["calls"] * 2 * w["query_rows"] * w["gallery_rows"] * w["d"])
    return 100.0 * flops / run.seconds / run.peaks["f32_flops"]
