"""The share of the traced window in which no device activity ran, in %."""

from port_bench import layer


def read(run):
    return layer.idle_share(run, "queries")
