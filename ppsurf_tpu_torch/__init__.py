"""ppsurf_tpu_torch — the PyTorch/CUDA port of ppsurf_tpu.

Reconstructs a surface from a point cloud with the PPSurf or the POCO
network on an NVIDIA GPU (`python -m ppsurf_tpu_torch.cli predict|rec`). Plain tensor code is PyTorch; the hot kernels of the field
evaluation and refinement (k-NN, candidate selection, decoder tail, and
the two PointNet stages) are CUDA C++ under `csrc/`, built with nvcc on
first use into `_build/`. On CPU tensors every kernel wrapper runs its
plain PyTorch version instead, which is how the tests hold the port
against the JAX package.
"""

__version__ = "0.1.0"
