"""Diagnostic tools of the PyTorch/CUDA port."""
