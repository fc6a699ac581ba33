"""The 95th percentile of every query's host-clock time, from the call to
the downloaded vote counts, over all queries of the window."""

import numpy as np


def read(run):
    if "queries" not in run.work or run.latencies.size == 0:
        return None
    return float(np.percentile(run.latencies, 95)) * 1e3
