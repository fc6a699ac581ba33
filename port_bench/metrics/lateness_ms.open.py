"""The open loop's own lateness: the 99th percentile, in ms, of a call's
start less its due time, over the calls whose client was free before
their due time (the others waited for the call before them, which the
latency counts). None in a closed loop."""

import numpy as np


def read(run):
    late = getattr(run, "lateness", None)
    if late is None or late.size == 0:
        return None
    return float(np.percentile(late, 99)) * 1e3
