"""Seconds a training step in `step.forward`: the program's span around
assembling the step's data, the forward pass and the loss (host time),
over the traced window's steps."""
from benchmark.harness.program_spans import seconds_per


def read(run):
    return seconds_per(run, len(run.steps), "step.forward")
