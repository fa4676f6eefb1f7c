"""Field queries an object: the evaluator's own count of grid queries and
refinement iterates, plus the iterates of vertices whose candidate
certificate failed and were refined again, the mean over the objects."""


def read(run):
    vals = [o["queries"] for o in run.objects]
    return sum(vals) / len(vals) if vals else None
