"""Self time (children excluded) of the program's `windows` and
`encoder` spans under its `build` roots, a piece embedded, in ms."""

from port_bench import spans


def read(run):
    found = spans.under(run, "build")
    if found is None or not run.work.get("pieces"):
        return None
    return spans.self_ms(found[0], ["windows", "encoder"]) \
        / run.work["pieces"]
