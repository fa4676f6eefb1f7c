"""The share of the traced window's encoder chunks run from a captured
CUDA graph: 100 x the `replays` over the `chunks` the program's `encode`
spans count, in percent. A program whose encoder counts no chunks gives
nothing."""
from benchmark.harness.program_spans import recorded


def read(run):
    found = recorded(run)
    if not found:
        return None
    enc = [s.counts for s in found if s.name == "encode"]
    chunks = sum(c.get("chunks", 0) for c in enc)
    if chunks <= 0:
        return None
    return 100.0 * sum(c.get("replays", 0) for c in enc) / chunks
