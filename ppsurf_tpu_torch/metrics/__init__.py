"""metrics modules of the PyTorch/CUDA port."""
