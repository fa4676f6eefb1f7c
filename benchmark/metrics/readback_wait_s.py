"""Seconds an object the host waited on the card for the field's
results: the program's `readback` spans inside `field` and `field.refine`
of the traced window over its objects."""
from benchmark.harness.program_spans import seconds_per


def read(run):
    return seconds_per(run, len(run.objects), "readback", inside=("field", "field.refine"))
