"""Sheet windows embedded into galleries in the window, per second of it."""


def read(run):
    if "windows" not in run.work:
        return None
    return run.work["windows"] / run.seconds
