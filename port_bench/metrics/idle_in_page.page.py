"""The time inside the program's `page` spans in which no device interval
of the window's trace runs, over the window, in %."""

from port_bench import spans


def read(run):
    if "pages" not in run.work:
        return None
    return spans.idle_inside(run, "page")
