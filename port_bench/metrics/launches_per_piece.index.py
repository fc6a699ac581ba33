"""Device kernels launched in the traced window per piece embedded."""

from port_bench import trace


def read(run):
    if run.trace is None or not run.work.get("pieces"):
        return None
    return trace.n_kernels(run.trace) / run.work["pieces"]
