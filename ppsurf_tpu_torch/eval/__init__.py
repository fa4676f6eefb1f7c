"""eval modules of the PyTorch/CUDA port."""
