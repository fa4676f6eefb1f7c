"""Seconds an object: the window's elapsed time over the objects it ran
(an object begun before the window's end is finished and counted)."""


def read(run):
    return run.window_s / len(run.objects) if run.objects else None
