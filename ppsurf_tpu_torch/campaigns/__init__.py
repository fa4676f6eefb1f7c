"""Campaign scripts of the PyTorch/CUDA port: fit -> test -> predict (->
make_comparison) through `ppsurf_tpu_torch.cli`, twins of the JAX
package's `full_run_*.py` at the repository root."""
