"""Host time inside the program's `upload` spans under its `build`
roots, a piece embedded, in ms."""

from port_bench import spans


def read(run):
    found = spans.under(run, "build")
    if found is None or not run.work.get("pieces"):
        return None
    return spans.host_ms(found[0], ["upload"]) / run.work["pieces"]
