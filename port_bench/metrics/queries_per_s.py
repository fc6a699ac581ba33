"""Queries answered in the window, per second of it."""


def read(run):
    if "queries" not in run.work:
        return None
    return run.work["queries"] / run.seconds
