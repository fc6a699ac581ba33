"""Host time a query: the mean of each call's own host-clock time less the
device's busy time a query, in ms."""

from port_bench import trace


def read(run):
    if run.trace is None or not run.work.get("queries"):
        return None
    n = run.work["calls"]
    return (float(run.service.sum()) - trace.busy_s(run.trace)) / n * 1e3
