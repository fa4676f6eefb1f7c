"""Seconds an object in the encode phase (the harness's host-clock span,
ending with its data on the host), the mean over the window's objects."""


def read(run):
    vals = [o["timings"]["encode"] for o in run.objects if "encode" in o["timings"]]
    return sum(vals) / len(vals) if vals else None
