"""Seconds a training step: the window's elapsed time, ending in a
synchronise, over the steps it completed (loader waits included)."""


def read(run):
    return run.window_s / len(run.steps) if run.steps else None
