"""Seconds a training step in `step.backward`: the program's span around
autograd's backward pass (host time), over the traced window's steps."""
from benchmark.harness.program_spans import seconds_per


def read(run):
    return seconds_per(run, len(run.steps), "step.backward")
