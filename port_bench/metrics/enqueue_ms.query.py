"""Self time (children excluded) of the program's `decode`, `windows`,
`encoder` and `topk` spans under its `query` roots, a query, in ms: the
host enqueueing the query's device work."""

from port_bench import spans


def read(run):
    found = spans.under(run, "query")
    if found is None:
        return None
    within, n = found
    return spans.self_ms(within, ["decode", "windows", "encoder",
                                  "topk"]) / n
