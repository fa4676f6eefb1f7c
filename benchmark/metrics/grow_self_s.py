"""Seconds an object of the region grower's own host work: the program's
`grow` spans less the `field` calls inside them, over the traced
window's objects."""
from benchmark.harness.program_spans import ancestor, recorded


def read(run):
    found = recorded(run)
    if not found or not run.objects:
        return None
    grow = sum(s.seconds for s in found if s.name == "grow")
    if grow <= 0:
        return None
    field = sum(s.seconds for s in found
                if s.name == "field" and ancestor(s, ("grow",)) is not None)
    return (grow - field) / len(run.objects)
