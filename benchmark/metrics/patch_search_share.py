"""The share of the traced window's field queries that ran a patch
search of their own (the K1 call at k=P where PPSurf's patch is wider
than the decoder's k): 100 x the `queries` the program's `field.patch`
spans count over the queries of the window's objects (`field_queries`'
count: grid queries, refinement iterates and the failed certificates'
iterates), in percent. Where no `field.patch` span was recorded (a
patch within the decoder's ids, or a program from before the span)
it gives nothing."""
from benchmark.harness.program_spans import recorded


def read(run):
    found = recorded(run)
    if not found:
        return None
    searched = sum(s.counts.get("queries", 0) for s in found if s.name == "field.patch")
    queries = sum(o["queries"] for o in run.objects)
    if searched <= 0 or queries <= 0:
        return None
    return 100.0 * searched / queries
