"""Seconds an object in the encoder's graph builds: the program's
`encode.graph` spans (K1 and the subsampling of each chunk, host time) of
the traced window over its objects."""
from benchmark.harness.program_spans import seconds_per


def read(run):
    return seconds_per(run, len(run.objects), "encode.graph")
