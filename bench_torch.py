"""End-to-end reconstruction benchmark of the PyTorch/CUDA port, the twin
of `bench.py` (`ppsurf_tpu_torch/tools/bench.py` says what it times).

Usage:
    python3 bench_torch.py                      # res 257, 3 timed passes on the card
    python3 bench_torch.py --device cpu --resolution 33 --reps 1
"""
import sys

from ppsurf_tpu_torch.tools.bench import main

if __name__ == "__main__":
    sys.exit(main())
