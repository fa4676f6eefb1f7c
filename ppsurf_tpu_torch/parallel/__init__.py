"""Data parallelism of the port on torch.distributed (`parallel/mesh.py`)."""
from ppsurf_tpu_torch.parallel.mesh import get_data_mesh, shard_batch  # noqa: F401
