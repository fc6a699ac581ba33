"""Host time inside the program's `vote` spans (the ids gather,
`bincount`, the slice) under its `query` roots, a query, in ms."""

from port_bench import spans


def read(run):
    found = spans.under(run, "query")
    if found is None:
        return None
    within, n = found
    return spans.host_ms(within, ["vote"]) / n
