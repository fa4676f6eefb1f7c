"""Seconds an object in the encoder's network runs: the program's
`encode.net` spans (`get_latent` of each chunk, host time) of the traced
window over its objects."""
from benchmark.harness.program_spans import seconds_per


def read(run):
    return seconds_per(run, len(run.objects), "encode.net")
