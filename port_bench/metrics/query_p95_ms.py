"""The 95th percentile of every query's host-clock latency, over all
queries of the window: what a user waits, from the call (in an open loop,
from the query's due time) to the downloaded vote counts."""

import numpy as np


def read(run):
    if "queries" not in run.work or run.latencies.size == 0:
        return None
    return float(np.percentile(run.latencies, 95)) * 1e3
