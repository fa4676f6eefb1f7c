"""The harness: the command line, the generators of each traffic kind, the trace."""
