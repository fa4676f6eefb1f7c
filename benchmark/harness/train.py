"""The generator of `"kind": "train"` mixes: training steps back to back.

Set-up writes the mix's dataset of seeded analytic solids
(`yardstick/solids.py`) into a fresh directory under TMPDIR, builds the
configuration's network from seeded initial weights (the benchmark's own,
`weights.seeded` on the mix's `init_seed`), its AdamW and the program's
`OccupancyDataModule`, and then drives that one state through its first
`check_steps` steps, in the window's own loop: each step's batch from the
loader (as `Trainer.fit` draws it: an epoch's shuffled batches, prefetched
by its worker threads), the graph draws and dropout from one torch
generator (`ModelSpec.draw_step`, `train.loop.train_step`), the loss read
back each step as `Trainer.fit` logs it. It keeps each of those steps'
loss, the first step's gradient (from AdamW's first moment after one
step) and the parameters before the first and after the last of them for
the comparison with the reference (`reference/compare_train.py`). The
window then runs more steps of the same state back to back.

Mix keys: `shapes`, `points` ([least, most] a solid), `queries` (a
solid's, all used a step), `manifold_points`, `batch_size`, `workers`,
`augment`, `lr`, `weight_decay`, `init_seed`, `check_steps`.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
import typing

import numpy as np
import torch

from benchmark.harness import weights as weights_mod
from benchmark.harness.common import Trace, reduce_trace
from benchmark.harness.reconstruct import sync, spec_of
from benchmark.yardstick import solids
from benchmark.yardstick.synthetic import rng_for

BETA1 = 0.9


@dataclasses.dataclass
class Run:
    """What a training run hands the metric readers."""

    config: dict
    mix: dict
    setup_s: float
    window_s: float
    steps: typing.List[dict]  # per window step: seconds, loader wait
    trace: typing.Optional[Trace] = None
    failed: int = 0
    inputs: typing.Optional[dict] = None  # weights, dataset, seeds: what both sides get

    @property
    def objects(self) -> typing.List[dict]:  # the result line's `attempted`
        return self.steps


def seeds_of(seed: int) -> typing.Dict[str, int]:
    """The run's seeds: the epoch shuffle, the dataset's item stream and
    the torch generator of graph draws and dropout."""
    rng = rng_for(seed, 3)
    return {k: int(rng.randint(0, 2**31 - 1)) for k in ("shuffle", "data", "generator")}


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, log) -> typing.Tuple[Run, typing.Callable[[], dict]]:
    from ppsurf_tpu_torch.convert.infer_npz import from_jax_variables
    from ppsurf_tpu_torch.data.datasets import OccupancyDataModule
    from ppsurf_tpu_torch.metrics.classification import metrics_from_confusion
    from ppsurf_tpu_torch.train import loop
    from ppsurf_tpu_torch.utils.alloc import tune_host_allocator

    tune_host_allocator()  # as the program's entry (`cli.main`) starts
    config, mix = cell.config, cell.mix
    spec = spec_of(config, mix)
    seeds = seeds_of(seed)
    root = tempfile.mkdtemp(prefix="ppsurf_bench_train_")
    shapes = solids.write_dataset(root, rng_for(seed, 2), int(mix["shapes"]),
                                  int(mix["queries"]), tuple(mix["points"]))
    flat = weights_mod.seeded(config, int(mix["init_seed"]), device)
    net = spec.make_network()
    net.load_state_dict(from_jax_variables(weights_mod.nested(flat), net), strict=True)
    net = net.to(device)
    cfg = loop.TrainConfig(lr=float(mix["lr"]), weight_decay=float(mix["weight_decay"]),
                           batch_size=int(mix["batch_size"]), seed=seeds["shuffle"])
    optimizer = loop.make_optimizer(net, cfg)
    dm = OccupancyDataModule(root + "/trainset.txt", batch_size=cfg.batch_size,
                             manifold_points=int(mix["manifold_points"]), seed=seeds["data"],
                             do_data_augmentation=bool(mix["augment"]),
                             workers=int(mix["workers"]))
    train_ds = dm.train_dataset()
    n_batches = max(1, -(-len(train_ds) // cfg.batch_size))
    generator = torch.Generator(device=device).manual_seed(seeds["generator"])
    shuffle_rng = np.random.RandomState(cfg.seed)
    phases: typing.List[typing.Tuple[str, int, int]] = []

    def feed():
        while True:  # epochs, as Trainer.fit runs them (its validation pass aside)
            yield from dm.epoch_batches(train_ds, shuffle_rng, shuffle=True)

    batches = feed()
    count = [0]

    def step() -> dict:
        t0, m0 = time.perf_counter(), time.monotonic_ns()
        batch = next(batches)
        wait = time.perf_counter() - t0
        m1 = time.monotonic_ns()
        phases.append(("loader wait", m0, m1))
        tb = loop.to_device({k: v for k, v in batch.items() if k in loop.BATCH_KEYS}, device)
        b, n = tb["pts_ms"].shape[:2]
        draws = spec.draw_step(b, n, generator, device)
        loss, conf = loop.train_step(net, spec, optimizer, tb, draws,
                                     loop.lr_at(cfg, n_batches, count[0]), generator=generator)
        count[0] += 1
        loss_f = float(loss)  # Trainer.fit logs every step's loss and scores
        metrics_from_confusion({k: float(v) for k, v in conf.items()})
        phases.append(("step", m1, time.monotonic_ns()))
        return dict(seconds=time.perf_counter() - t0, wait=wait, loss=loss_f)

    names = {name: "params/" + name.replace(".", "/") for name, _ in net.named_parameters()}
    p0 = {names[k]: p.detach().clone() for k, p in net.named_parameters()}
    check_losses, first_grad = [], None
    for i in range(int(mix["check_steps"])):
        check_losses.append(step()["loss"])
        if i == 0:  # the gradient as AdamW got it: its first moment over (1 - beta1)
            first_grad = {names[k]: optimizer.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p)).detach() / (1.0 - BETA1)
                for k, p in net.named_parameters()}
    p_end = {names[k]: p.detach().clone() for k, p in net.named_parameters()}
    log(f"# set-up steps: losses {check_losses}")
    phases.clear()

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    sync(device)
    setup_s = time.perf_counter() - t_start
    steps = []
    w0, m0 = time.perf_counter(), time.monotonic_ns()
    while not steps or time.perf_counter() - w0 < seconds:
        steps.append(step())
    sync(device)
    window_s = time.perf_counter() - w0
    m1 = time.monotonic_ns()
    tr = None
    if prof is not None:
        prof.stop()
        tr = reduce_trace(prof, phases, (m0, m1))
        del prof
    failed = sum(not np.isfinite(s["loss"]) for s in steps)
    losses = [round(s["loss"], 4) for s in steps]
    log(f"# window: {len(steps)} steps in {window_s:.3f} s; "
        f"losses {losses[:3]} ... {losses[-3:]}")
    result = Run(config, mix, setup_s, window_s, steps, tr, failed,
                 dict(flat=flat, shapes=shapes, seeds=seeds, p0=p0))

    def check() -> dict:
        from benchmark.reference import compare_train

        nonlocal net, optimizer, batches
        batches.close()
        net = optimizer = batches = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        try:
            return compare_train.numbers(config, mix, flat, shapes, seeds, device, dict(
                losses=check_losses, first_grad=first_grad, p0=p0, p_end=p_end), log)
        finally:
            shutil.rmtree(root, ignore_errors=True)

    return result, check
