"""The benchmark of the PyTorch/CUDA port (`ppsurf_tpu_torch`); see README.md."""
