"""The data axis on torch.distributed: one process (rank) a device.

Port of `ppsurf_tpu/parallel/mesh.py` (reference Lightning DDP over NCCL,
`configs/device_server.yaml:2`, and the DistributedSampler,
`occupancy_data_module.py:115-124`). The JAX package lays one `Mesh` axis
`data` over the devices of one or more processes and reduces inside
`shard_map`; here each rank is one process that drives one device, and
the reductions are collectives of the default process group:

- `get_data_mesh` describes the axis: this process's rank, the world size
  and its device; without a process group, rank 0 of 1 and the local
  devices one process drives (the sharded field evaluator's replicas);
- `maybe_init_distributed` joins the group from torchrun's environment;
- `process_batch_slice` / `shard_batch`: every rank draws the same seeded
  global batch and keeps its contiguous slice, as the JAX package's
  multi-host path does;
- `replicate`, `all_mean_`, `all_sum_`, `broadcast_`: one collective a
  dtype over a flat copy of the tensors. The backend is the caller's
  choice (`nccl` across cards, `gloo` on the CPU or where asked); a gloo
  group reduces a card's tensors through a host copy.

One host thread dispatches every device of a process. The kernels' C
entries keep one static per-card cache keyed by the last device
(`csrc/decoder_tail.cu:954`, `csrc/pointnet.cu:1044-1045`,
`csrc/select.cu:316`): correct when one thread alternates devices, not
when two threads launch at once. So the sharded field evaluator
(`recon/field.py`) launches its replicas from the calling thread, and
nothing here starts a thread.
"""
from __future__ import annotations

import dataclasses
import os
import typing

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data axis as one process sees it. `rank` of `size` processes
    (0 of 1 without a process group); `devices` the devices this process
    drives: its one device in a group, else a list of local devices.
    `distributed` is True where the tensors are reduced over a group (at
    world size 1 too, where the mean is the identity)."""

    rank: int
    size: int
    devices: typing.Tuple[torch.device, ...]
    distributed: bool

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_devices(device: typing.Union[str, torch.device] = "cuda") -> typing.List[torch.device]:
    """The cards of this host (`device` CUDA), else the one CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(device: torch.device) -> torch.device:
    """A CUDA device with its index (the current card where none is given)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def get_data_mesh(num_devices: typing.Optional[int] = None,
                  device: typing.Union[str, torch.device] = "cuda") -> DataMesh:
    """The data axis. In a process group: this rank of the world, on
    `device` (a card without an index is the current card, which
    `maybe_init_distributed` set); `num_devices`, where given, must be
    the world size. Without one: the first `num_devices` local devices
    (every one where None) of `device`'s type."""
    device = torch.device(device)
    if is_distributed():
        size = dist.get_world_size()
        if num_devices is not None and num_devices != size:
            raise ValueError(f"{num_devices} devices asked for in a process group of {size} "
                             "ranks: one rank drives one device")
        return DataMesh(dist.get_rank(), size, (_indexed(device),), True)
    devices = local_devices(device)
    if num_devices is not None:
        devices = devices[:num_devices]
    return DataMesh(0, 1, tuple(devices), False)


def single_device_mesh(device: torch.device) -> DataMesh:
    """One process on one device, no group."""
    return DataMesh(0, 1, (_indexed(device),), False)


def maybe_init_distributed(backend: str = "nccl") -> bool:
    """Join the default process group from the environment; returns True
    when it initialised one.

    It fires on `PPSURF_DIST=1` or on torchrun's variables (`RANK`,
    `WORLD_SIZE` and `MASTER_ADDR` all set), and initialises with
    `env://` (so `MASTER_ADDR` and `MASTER_PORT` are read from the
    environment) at rank `RANK` of `WORLD_SIZE` (0 of 1 where unset).
    `backend` is the caller's: `nccl` across cards, `gloo` on the CPU or
    where asked (NCCL refuses two ranks on one card). For `nccl` it makes
    card `LOCAL_RANK` (else `RANK`) current first, before any launch. A
    process already in a group is left as it is."""
    env = os.environ
    torchrun = all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if is_distributed() or not (torchrun or env.get("PPSURF_DIST") == "1"):
        return False
    rank = int(env.get("RANK", "0"))
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=int(env.get("WORLD_SIZE", "1")))
    return True


def free_port() -> int:
    """A TCP port of localhost that was free when asked (bound to port 0
    and released), for a rendezvous that `MASTER_PORT` names."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def process_batch_slice(global_batch: int, mesh: typing.Optional[DataMesh] = None
                        ) -> typing.Tuple[int, int]:
    """This rank's [start, stop) share of a global batch
    (`ppsurf_tpu/parallel/mesh.py:58-72`): contiguous slices, the first
    `global_batch % size` ranks one item longer."""
    mesh = mesh or get_data_mesh(device="cpu")
    n, i = mesh.size, mesh.rank
    per = global_batch // n
    extra = global_batch % n
    start = i * per + min(i, extra)
    stop = start + per + (1 if i < extra else 0)
    return start, stop


def shard_batch(batch: typing.Dict[str, typing.Any], mesh: DataMesh
                ) -> typing.Dict[str, typing.Any]:
    """This rank's slice of every leaf's leading (batch) axis. Every rank
    holds the same seeded global batch (`ppsurf_tpu/parallel/mesh.py:75-106`);
    a batch that does not divide over the ranks raises."""
    if mesh.size == 1:
        return batch
    out = {}
    for key, x in batch.items():
        if x.shape[0] % mesh.size != 0:
            raise ValueError(f"global batch {x.shape[0]} not divisible by the mesh's "
                             f"{mesh.size} devices; adjust data.batch_size")
        start, stop = process_batch_slice(x.shape[0], mesh)
        out[key] = x[start:stop]
    return out


def _flat_collective(tensors: typing.Iterable[torch.Tensor],
                     op: typing.Callable[[torch.Tensor], None]) -> None:
    """`op` (an in-place collective) on one flat copy of the tensors of
    each dtype, the results copied back in place. Gloo reduces a card's
    tensors through a host copy."""
    by_dtype: typing.Dict[torch.dtype, typing.List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    gloo = dist.get_backend() == "gloo"
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        wire = flat.cpu() if gloo and flat.is_cuda else flat
        op(wire)
        if wire is not flat:
            flat.copy_(wire)
        offset = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def all_sum_(tensors: typing.Iterable[torch.Tensor], mesh: DataMesh) -> None:
    """psum over the ranks, in place."""
    if mesh.distributed:
        _flat_collective(tensors, dist.all_reduce)


def all_mean_(tensors: typing.Iterable[torch.Tensor], mesh: DataMesh) -> None:
    """pmean over the ranks, in place: the sum, then divided by the world
    size, as `jax.lax.pmean`."""
    if mesh.distributed:
        _flat_collective(tensors, lambda t: (dist.all_reduce(t), t.div_(mesh.size)))


def broadcast_(tensors: typing.Iterable[torch.Tensor], mesh: DataMesh, src: int = 0) -> None:
    """Rank `src`'s values on every rank, in place."""
    if mesh.distributed:
        _flat_collective(tensors, lambda t: dist.broadcast(t, src))


def replicate(module: torch.nn.Module, mesh: DataMesh) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank."""
    broadcast_(list(module.parameters()) + list(module.buffers()), mesh)
    return module


def barrier(mesh: DataMesh) -> None:
    if mesh.distributed:
        dist.barrier()
