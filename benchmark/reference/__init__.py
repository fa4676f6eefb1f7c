"""Plain float32 PyTorch reference of the networks the benchmark runs.

It imports nothing of the program (`ppsurf_tpu_torch`), of the JAX package
(`ppsurf_tpu`) or of JAX; it reads the weights and the inputs that the
benchmark hands to both sides, and works out every draw again.
"""
