"""Seconds a step spent waiting for the loader's next batch (the
harness's span around fetching it), the mean over the window's steps."""


def read(run):
    return sum(s["wait"] for s in run.steps) / len(run.steps) if run.steps else None
