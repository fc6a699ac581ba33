"""Host milliseconds inside the program's `geometry` spans (the system
boxes worked out on the card, enqueued) under its `page` roots, a page."""

from port_bench import spans


def read(run):
    if "pages" not in run.work:
        return None
    found = spans.under(run, "page")
    if found is None:
        return None
    within, n = found
    return spans.host_ms(within, ["geometry"]) / n
