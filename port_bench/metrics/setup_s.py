"""Set-up: process start to the first measured call (host clock)."""


def read(run):
    return run.setup_s
