"""Training loop of the port: one device, AdamW + MultiStep LR.

Port of `ppsurf_tpu/train/loop.py` (reference Lightning Trainer,
`configs/poco.yaml:4-25, 60-77`) on one device:

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
- `eval_step`: the whole batch in eval mode (eval BatchNorm couples no
  items, so this equals the JAX package's per-item map);
- `Trainer.fit`: epochs of shuffled batches, a validation pass and the
  `last.pt` checkpoint after each, resume at `step // batches per epoch`,
  TensorBoard scalars under the reference's tag names when
  `torch.utils.tensorboard` imports (`poco_model.py:302-322`), else none.

Multi-GPU data parallelism, `sync_batch_stats` and the `profiler: jax`
preset are not ported (ROADMAP.md).
"""
from __future__ import annotations

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
from ppsurf_tpu_torch.train.model import ModelSpec

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
    debug: bool = False  # autograd anomaly detection (reference --debug)
    profiler: typing.Optional[str] = None  # read, not ported


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


def train_step(net: torch.nn.Module, spec: ModelSpec, optimizer: torch.optim.Optimizer,
               batch: typing.Dict[str, torch.Tensor], draws: typing.Sequence[Draws],
               lr: float, generator: typing.Optional[torch.Generator] = None,
               masks=None) -> typing.Tuple[torch.Tensor, dict]:
    """One update: (loss, confusion counts) as device tensors. The graph
    draws come from `draws` (`ModelSpec.draw_step`); PPSurf's dropout masks
    from `masks`, else `generator`."""
    data = spec.assemble_step_data(batch, draws)
    optimizer.zero_grad(set_to_none=True)
    logits = net(data, train=True, generator=generator, masks=masks)
    loss = cross_entropy_loss(logits, batch["occ"])
    loss.backward()
    for p in net.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return loss.detach(), binary_confusion(logits.detach().argmax(-1), batch["occ"])


@torch.no_grad()
def eval_step(net: torch.nn.Module, spec: ModelSpec, batch: typing.Dict[str, torch.Tensor],
              draws: typing.Sequence[Draws]) -> typing.Tuple[torch.Tensor, dict, torch.Tensor]:
    """Eval-mode (loss, confusion counts, logits) of a batch."""
    logits = net(spec.assemble_step_data(batch, draws), train=False)
    return (cross_entropy_loss(logits, batch["occ"]),
            binary_confusion(logits.argmax(-1), batch["occ"]), logits)


def find_version_dir(root_dir: str, resume: bool = False) -> str:
    """Auto-incrementing version_{v} run dirs (reference `README.md:231-234`)."""
    v = 0
    while os.path.isdir(os.path.join(root_dir, f"version_{v}")):
        v += 1
    if resume and v > 0:
        v -= 1
    return os.path.join(root_dir, f"version_{v}")


class Trainer:
    """fit/validate loop on one device (CUDA unless `device` says
    otherwise). `history` holds (step, train loss) of every update."""

    def __init__(self, spec: ModelSpec, config: TrainConfig,
                 device: typing.Union[str, torch.device, None] = None):
        self.spec = spec
        self.config = config
        self.device = resolve_device(device)
        self.version_dir = find_version_dir(config.default_root_dir)
        self.ckpt_dir = os.path.join(self.version_dir, "checkpoints")
        self.history: typing.List[typing.Tuple[int, float]] = []
        self._writer = None
        self._steps_per_epoch = 1

    def init_state(self) -> TrainState:
        """Seeded weights (`convert.init.init_variables`) and a fresh AdamW."""
        net = self.spec.make_network()
        variables = init_variables(self.spec, seed=self.config.seed)
        net.load_state_dict(from_jax_variables(variables, net), strict=True)
        net = net.to(self.device)
        return TrainState(0, net, make_optimizer(net, self.config))

    def save_checkpoint(self, state: TrainState, name: str = CHECKPOINT_NAME) -> str:
        return save_checkpoint(os.path.join(self.ckpt_dir, name), state.net,
                               state.optimizer, state.step)

    def restore_checkpoint(self, state: TrainState, path: str) -> TrainState:
        payload = load_checkpoint(path)
        state.net.load_state_dict(from_jax_variables(payload["variables"], state.net),
                                  strict=True)
        if payload.get("optimizer") is not None:
            state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state

    def _log_scalars(self, log_type: str, step: int, loss: float, metrics: dict):
        """Reference tag names (`poco_model.py:302-322`)."""
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

    def fit(self, datamodule, ckpt_path: typing.Optional[str] = None) -> TrainState:
        cfg = self.config
        if cfg.profiler:
            print(f"trainer.profiler={cfg.profiler!r} is not ported; training without it")
        train_ds = datamodule.train_dataset()
        val_ds = datamodule.val_dataset()
        n_batches = max(1, -(-len(train_ds) // cfg.batch_size))
        self._steps_per_epoch = n_batches

        rng = np.random.RandomState(cfg.seed)
        state = self.init_state()
        if ckpt_path:
            state = self.restore_checkpoint(state, ckpt_path)
        generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        t_start = time.time()
        # resume at the epoch of the restored step (Lightning's --ckpt_path)
        start_epoch = min(state.step // n_batches, cfg.max_epochs)

        with torch.autograd.set_detect_anomaly(cfg.debug):
            for epoch in range(start_epoch, cfg.max_epochs):
                for batch in datamodule.epoch_batches(train_ds, rng, shuffle=True):
                    tb = to_device(batch, self.device)
                    b, n = tb["pts_ms"].shape[:2]
                    draws = self.spec.draw_step(b, n, generator, self.device)
                    loss, conf = train_step(
                        state.net, self.spec, state.optimizer, tb, draws,
                        lr_at(cfg, n_batches, state.step), generator=generator)
                    state.step += 1
                    if state.step % cfg.log_every_n_steps == 0:
                        loss_f = float(loss)
                        self.history.append((state.step, loss_f))
                        metrics = metrics_from_confusion({k: float(v) for k, v in conf.items()})
                        self._log_scalars("train", state.step, loss_f, metrics)

                val_losses, val_confs = [], []
                for batch in datamodule.epoch_batches(val_ds, rng, shuffle=False):
                    tb = to_device(batch, self.device)
                    b, n = tb["pts_ms"].shape[:2]
                    loss, conf, _ = eval_step(state.net, self.spec, tb,
                                              self.spec.draw_step(b, n, generator, self.device))
                    val_losses.append(float(loss))
                    val_confs.append({k: float(v) for k, v in conf.items()})
                if val_confs:
                    total = {k: float(np.sum([c[k] for c in val_confs])) for k in val_confs[0]}
                    metrics = metrics_from_confusion(total)
                    self._log_scalars("val", state.step, float(np.mean(val_losses)), metrics)
                    print(f"epoch {epoch}: val_loss={np.mean(val_losses):.4f} "
                          f"F1={metrics['f1_score']:.4f} ({time.time() - t_start:.1f}s elapsed)",
                          flush=True)
                self.save_checkpoint(state)

        if self._writer:
            self._writer.close()
        return state
