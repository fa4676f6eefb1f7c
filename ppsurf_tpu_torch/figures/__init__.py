"""figures modules of the PyTorch/CUDA port: the comparison configurations
of the paper, its figure data and their renders."""
