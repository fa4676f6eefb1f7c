"""Seconds a training step in `step.optimizer`: the program's span around
the zero-filled gradients and AdamW's update (host time), over the
traced window's steps."""
from benchmark.harness.program_spans import seconds_per


def read(run):
    return seconds_per(run, len(run.steps), "step.optimizer")
