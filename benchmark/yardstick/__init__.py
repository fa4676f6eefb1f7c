"""The benchmark's own yardstick: inputs, operation and byte counts, peaks.

Frozen copies: a later change to the program's `ops/opcount.py` or
`data/synthetic.py` does not move what the benchmark measures.
"""
