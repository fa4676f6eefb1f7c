"""Seconds an object in marching cubes and the two mesh cleanups (the
engine's "mesh" and "clean" phases), the mean over the window's objects."""


def read(run):
    vals = [o["timings"]["mesh"] + o["timings"]["clean"] for o in run.objects
            if "clean" in o["timings"]]
    return sum(vals) / len(vals) if vals else None
