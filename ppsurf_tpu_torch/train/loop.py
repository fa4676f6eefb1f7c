"""Training loop of the port: data-parallel ranks, AdamW + MultiStep LR.

Port of `ppsurf_tpu/train/loop.py` (reference Lightning Trainer and DDP,
`configs/poco.yaml:4-25, 60-77`), one process a device (`parallel/mesh.py`):

- `train_step`: the batch's graphs, decoder ids and patches on the device
  (K1 on a card), the forward in train mode (BatchNorm on the batch's
  statistics, running statistics and FKAConv radii updated in place,
  dropout from a `torch.Generator` or given masks), the cross-entropy of
  the f32 logits, autograd's backward and one AdamW update;
- the learning rate follows optax's `piecewise_constant_schedule` over the
  update count, as the JAX package's: the update after `count` updates
  uses `lr * gamma^(number of milestones m with count >= m *
  steps_per_epoch)`. `torch.optim.AdamW` decays weights as
  `optax.adamw` does (p - lr * (adam + wd * p)); a parameter without a
  gradient (POCO's unused bottleneck) gets a zero gradient, so it decays
  and its moments step, as optax's zero gradient does;
- data parallelism in a process group (`ppsurf_tpu/train/loop.py:120-204`):
  each rank steps on its slice of the global batch with its own
  generator; after the backward one all-reduce averages a flat buffer of
  every gradient (`pmean`), the loss is averaged and the confusion counts
  summed over the ranks; the module buffers (BatchNorm running
  statistics, FKAConv radius EMAs) take rank 0's values, or with
  `sync_batch_stats` the ranks' mean (`loop.py:136-149`), so every rank
  holds the same state after every step;
- `eval_step`: the whole batch in eval mode (eval BatchNorm couples no
  items, so this equals the JAX package's per-item map), the loss
  averaged and the counts summed over the ranks;
- `Trainer.fit`: epochs of shuffled batches, a validation pass and the
  `last.pt` checkpoint after each, resume at `step // batches per epoch`
  (every rank loads the same checkpoint), TensorBoard scalars under the
  reference's tag names when `torch.utils.tensorboard` imports
  (`poco_model.py:302-322`), else none; rank 0 alone writes the
  checkpoint, the scalars and the run dir's files. With `profiler: jax`
  (`configs/profiler.yaml`) steps 2-4 are traced with torch.profiler
  into `<run dir>/profile` (`loop.py:323-346`, `utils/profiling.py`),
  with the device's time by span (`utils/spans.py`: `train_step N`,
  `step.forward`, `step.backward`, `step.optimizer`, `data.wait`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import typing

import numpy as np
import torch
from torch.nn import functional as F

from ppsurf_tpu_torch.convert.checkpoint import CHECKPOINT_NAME, load_checkpoint, save_checkpoint
from ppsurf_tpu_torch.convert.infer_npz import from_jax_variables
from ppsurf_tpu_torch.convert.init import init_variables
from ppsurf_tpu_torch.device import resolve_device
from ppsurf_tpu_torch.metrics.classification import binary_confusion, metrics_from_confusion
from ppsurf_tpu_torch.ops.graph import Draws
from ppsurf_tpu_torch.parallel.mesh import (
    DataMesh, all_mean_, all_sum_, barrier, broadcast_, get_data_mesh, is_distributed,
    replicate, shard_batch, single_device_mesh,
)
from ppsurf_tpu_torch.train.model import ModelSpec
from ppsurf_tpu_torch.utils.profiling import torch_trace
from ppsurf_tpu_torch.utils.spans import span

BATCH_KEYS = ("pts_ms", "pts_query_ms", "occ", "pts_raw_ms", "raw_valid")


@dataclasses.dataclass
class TrainConfig:
    """Trainer/optimizer configuration (reference `configs/poco.yaml`)."""

    max_epochs: int = 150
    lr: float = 1e-3
    weight_decay: float = 1e-2
    betas: typing.Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-5
    lr_milestones: typing.Tuple[int, ...] = (75, 125)  # epochs
    lr_gamma: float = 0.1
    batch_size: int = 10
    seed: int = 42
    log_every_n_steps: int = 1
    default_root_dir: str = "models/ppsurf"
    # ranks of the data axis: the process group's world size (None: any);
    # without a group one device, and more than 1 raises
    num_devices: typing.Optional[int] = None
    debug: bool = False  # autograd anomaly detection (reference --debug)
    profiler: typing.Optional[str] = None  # 'jax': trace steps 2-4 (torch.profiler)
    # False (default): BatchNorm running statistics and FKAConv radius
    # EMAs take rank 0's values, as the reference's per-rank BN under DDP
    # saves rank 0's (`ppsurf_tpu/models/norm.py:3-7`); True: their mean
    sync_batch_stats: bool = False


@dataclasses.dataclass
class TrainState:
    step: int
    net: torch.nn.Module
    optimizer: torch.optim.Optimizer


def lr_at(config: TrainConfig, steps_per_epoch: int, count: int) -> float:
    """The learning rate of the update after `count` updates
    (optax `piecewise_constant_schedule`, `ppsurf_tpu/train/loop.py:66-70`)."""
    lr = config.lr
    for m in sorted({int(m) * steps_per_epoch for m in config.lr_milestones}):
        if count >= m:
            lr *= config.lr_gamma
    return lr


def make_optimizer(net: torch.nn.Module, config: TrainConfig) -> torch.optim.Optimizer:
    """AdamW (reference `configs/poco.yaml:60-70`); `train_step` sets its
    learning rate from `lr_at` before every update."""
    return torch.optim.AdamW(net.parameters(), lr=config.lr, betas=tuple(config.betas),
                             eps=config.eps, weight_decay=config.weight_decay)


def cross_entropy_loss(logits: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """2-class CE of the f32 logits on the occupancy sign
    (reference `poco_model.py:75-88`)."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           occ.reshape(-1).long())


def to_device(batch: typing.Dict[str, np.ndarray], device: torch.device
              ) -> typing.Dict[str, torch.Tensor]:
    """A collated numpy batch's network inputs as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if k in BATCH_KEYS}


def _reduce_metrics(loss: torch.Tensor, conf: dict, mesh: typing.Optional[DataMesh]
                    ) -> typing.Tuple[torch.Tensor, dict]:
    """The loss averaged and the confusion counts summed over the ranks."""
    if mesh is not None:
        all_mean_([loss], mesh)
        all_sum_(list(conf.values()), mesh)
    return loss, conf


def train_step(net: torch.nn.Module, spec: ModelSpec, optimizer: torch.optim.Optimizer,
               batch: typing.Dict[str, torch.Tensor], draws: typing.Sequence[Draws],
               lr: float, generator: typing.Optional[torch.Generator] = None,
               masks=None, mesh: typing.Optional[DataMesh] = None,
               sync_batch_stats: bool = False) -> typing.Tuple[torch.Tensor, dict]:
    """One update: (loss, confusion counts) as device tensors. The graph
    draws come from `draws` (`ModelSpec.draw_step`); PPSurf's dropout masks
    from `masks`, else `generator`. In a process group (`mesh`) the batch
    is this rank's slice; the gradients, loss, counts and buffers are
    reduced over the ranks before the update (module docstring)."""
    with span("step.forward"):
        data = spec.assemble_step_data(batch, draws)
        optimizer.zero_grad(set_to_none=True)
        logits = net(data, train=True, generator=generator, masks=masks)
        loss = cross_entropy_loss(logits, batch["occ"])
    with span("step.backward"):
        loss.backward()
    with span("step.optimizer"):  # in a process group also the ranks' reductions
        for p in net.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if mesh is not None:
            all_mean_([p.grad for p in net.parameters()], mesh)
            (all_mean_ if sync_batch_stats else broadcast_)(list(net.buffers()), mesh)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
    return _reduce_metrics(loss.detach(),
                           binary_confusion(logits.detach().argmax(-1), batch["occ"]), mesh)


@torch.no_grad()
def eval_step(net: torch.nn.Module, spec: ModelSpec, batch: typing.Dict[str, torch.Tensor],
              draws: typing.Sequence[Draws], mesh: typing.Optional[DataMesh] = None
              ) -> typing.Tuple[torch.Tensor, dict, torch.Tensor]:
    """Eval-mode (loss, confusion counts, logits) of a batch; in a process
    group the loss is averaged and the counts summed over the ranks
    (`ppsurf_tpu/train/loop.py:179-198`), the logits are this rank's."""
    logits = net(spec.assemble_step_data(batch, draws), train=False)
    loss, conf = _reduce_metrics(cross_entropy_loss(logits, batch["occ"]),
                                 binary_confusion(logits.argmax(-1), batch["occ"]), mesh)
    return loss, conf, logits


def find_version_dir(root_dir: str, resume: bool = False) -> str:
    """Auto-incrementing version_{v} run dirs (reference `README.md:231-234`)."""
    v = 0
    while os.path.isdir(os.path.join(root_dir, f"version_{v}")):
        v += 1
    if resume and v > 0:
        v -= 1
    return os.path.join(root_dir, f"version_{v}")


class Trainer:
    """fit/validate loop, one device a rank (CUDA unless `device` says
    otherwise). In a process group (`parallel.mesh.maybe_init_distributed`,
    torchrun, or `cli fit --trainer.devices N`) the rank's device is
    `device` with the current card's index, and `config.num_devices`, where
    set, must be the world size; without one it trains on `device` alone.
    `history` holds (step, train loss averaged over the ranks) of every
    update."""

    def __init__(self, spec: ModelSpec, config: TrainConfig,
                 device: typing.Union[str, torch.device, None] = None):
        self.spec = spec
        self.config = config
        device = resolve_device(device)
        if is_distributed():
            self.mesh = get_data_mesh(config.num_devices, device)
        elif config.num_devices not in (None, 1):
            raise ValueError(
                f"trainer.devices={config.num_devices}: one process drives one device; "
                "launch the ranks with torchrun or `cli fit --trainer.devices N`")
        else:
            self.mesh = single_device_mesh(device)
        self.device = self.mesh.device
        if config.batch_size % self.mesh.size != 0:
            raise ValueError(f"batch_size {config.batch_size} must divide over "
                             f"{self.mesh.size} devices")
        self.is_main = self.mesh.rank == 0
        version_dir = [find_version_dir(config.default_root_dir)]
        if self.mesh.distributed:  # rank 0's choice, before any rank writes there
            torch.distributed.broadcast_object_list(version_dir, src=0)
        self.version_dir = version_dir[0]
        self.ckpt_dir = os.path.join(self.version_dir, "checkpoints")
        self.history: typing.List[typing.Tuple[int, float]] = []
        self._writer = None
        self._steps_per_epoch = 1

    def init_state(self) -> TrainState:
        """Seeded weights (`convert.init.init_variables`), rank 0's on every
        rank, and a fresh AdamW."""
        net = self.spec.make_network()
        variables = init_variables(self.spec, seed=self.config.seed)
        net.load_state_dict(from_jax_variables(variables, net), strict=True)
        net = replicate(net.to(self.device), self.mesh)
        return TrainState(0, net, make_optimizer(net, self.config))

    def save_checkpoint(self, state: TrainState, name: str = CHECKPOINT_NAME) -> str:
        """Rank 0 writes `name`; every rank returns once it is written."""
        path = os.path.join(self.ckpt_dir, name)
        if self.is_main:
            save_checkpoint(path, state.net, state.optimizer, state.step)
        barrier(self.mesh)
        return path

    def restore_checkpoint(self, state: TrainState, path: str) -> TrainState:
        payload = load_checkpoint(path)
        state.net.load_state_dict(from_jax_variables(payload["variables"], state.net),
                                  strict=True)
        if payload.get("optimizer") is not None:
            state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def _log_scalars(self, log_type: str, step: int, loss: float, metrics: dict):
        """Reference tag names (`poco_model.py:302-322`), rank 0 only."""
        if not self.is_main:
            return
        if self._writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(log_dir=self.version_dir)
            except Exception:
                self._writer = False
        if self._writer:
            self._writer.add_scalar(f"loss/{log_type}/00_all", loss, step)
            for k in ("accuracy", "precision", "recall", "f1_score"):
                v = metrics.get(k, float("nan"))
                self._writer.add_scalar(f"metrics/{log_type}/{k}", 0.0 if np.isnan(v) else v,
                                        step)
            if log_type == "train":
                self._writer.add_scalar(
                    "lr-AdamW", lr_at(self.config, self._steps_per_epoch, step), step)

    def _local_batch(self, batch: typing.Dict[str, np.ndarray]
                     ) -> typing.Dict[str, torch.Tensor]:
        """This rank's slice of a collated global batch, on its device."""
        return to_device(shard_batch({k: v for k, v in batch.items() if k in BATCH_KEYS},
                                     self.mesh), self.device)

    def fit(self, datamodule, ckpt_path: typing.Optional[str] = None) -> TrainState:
        cfg = self.config
        train_ds = datamodule.train_dataset()
        val_ds = datamodule.val_dataset()
        n_batches = max(1, -(-len(train_ds) // cfg.batch_size))
        self._steps_per_epoch = n_batches

        # every rank draws the same global batches and keeps its slice
        rng = np.random.RandomState(cfg.seed)
        state = self.init_state()
        if ckpt_path:
            state = self.restore_checkpoint(state, ckpt_path)
        # each rank's own draws (the JAX step folds in the device index)
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed + self.mesh.rank)
        if self.is_main:
            os.makedirs(self.ckpt_dir, exist_ok=True)
        t_start = time.time()
        # resume at the epoch of the restored step (Lightning's --ckpt_path)
        start_epoch = min(state.step // n_batches, cfg.max_epochs)
        # the profiler preset traces steps 2-4 (`ppsurf_tpu/train/loop.py:323-346`)
        trace_steps = (2, 5) if cfg.profiler == "jax" else None

        with torch.autograd.set_detect_anomaly(cfg.debug), contextlib.ExitStack() as trace:
            for epoch in range(start_epoch, cfg.max_epochs):
                for batch in datamodule.epoch_batches(train_ds, rng, shuffle=True):
                    if trace_steps and state.step == trace_steps[0]:
                        trace.enter_context(torch_trace(
                            os.path.join(self.version_dir, "profile"),
                            file_name=f"trace_rank{self.mesh.rank}.json"))
                    tb = self._local_batch(batch)
                    b, n = tb["pts_ms"].shape[:2]
                    with span(f"train_step {state.step}"):
                        draws = self.spec.draw_step(b, n, generator, self.device)
                        loss, conf = train_step(
                            state.net, self.spec, state.optimizer, tb, draws,
                            lr_at(cfg, n_batches, state.step), generator=generator,
                            mesh=self.mesh, sync_batch_stats=cfg.sync_batch_stats)
                    state.step += 1
                    if trace_steps and state.step >= trace_steps[1]:
                        trace.close()  # writes the trace
                        trace_steps = None
                    if state.step % cfg.log_every_n_steps == 0:
                        loss_f = float(loss)
                        self.history.append((state.step, loss_f))
                        metrics = metrics_from_confusion({k: float(v) for k, v in conf.items()})
                        self._log_scalars("train", state.step, loss_f, metrics)

                val_losses, val_confs = [], []
                for batch in datamodule.epoch_batches(val_ds, rng, shuffle=False):
                    tb = self._local_batch(batch)
                    b, n = tb["pts_ms"].shape[:2]
                    loss, conf, _ = eval_step(state.net, self.spec, tb,
                                              self.spec.draw_step(b, n, generator, self.device),
                                              mesh=self.mesh)
                    val_losses.append(float(loss))
                    val_confs.append({k: float(v) for k, v in conf.items()})
                if val_confs:
                    total = {k: float(np.sum([c[k] for c in val_confs])) for k in val_confs[0]}
                    metrics = metrics_from_confusion(total)
                    self._log_scalars("val", state.step, float(np.mean(val_losses)), metrics)
                    if self.is_main:
                        print(f"epoch {epoch}: val_loss={np.mean(val_losses):.4f} "
                              f"F1={metrics['f1_score']:.4f} "
                              f"({time.time() - t_start:.1f}s elapsed)", flush=True)
                self.save_checkpoint(state)

        if self._writer:
            self._writer.close()
        return state
