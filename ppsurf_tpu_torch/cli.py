"""Command line of the port: fit / test / predict / rec with YAML config
stacking.

    python -m ppsurf_tpu_torch.cli fit|test|predict [-c a.yaml -c b.yaml ...] [--dotted.key value ...]
    python -m ppsurf_tpu_torch.cli rec <cloud> <out_dir> [-c ...] [--dotted.key value ...]

As `ppsurf_tpu/cli.py` (reference `source/cli.py`, `pps.py`): the
`configs/*.yaml` files stack in order with a later-wins deep merge
(`:33-50, 93-101`), `--section.init_args.key value` overrides a key with
a YAML-typed value, the model spec, the trainer's configuration and the
data module come from the merged config (`:104-194`), and
`rec in_file out_dir` is `predict` with `data.init_args.in_file` and
`model.init_args.results_dir` set (`:241-251`). `--print_config` prints
the merged config.

- `fit` trains from seeded weights (or resumes `--ckpt_path`) and writes
  `<trainer.default_root_dir>/version_{v}/checkpoints/last.pt` with the
  resolved config as `config.yaml` beside it. `--trainer.devices N`
  (`auto` or unset: every local card, as the JAX package's mesh) trains
  data-parallel: run outside a process group, `fit` spawns N ranks over
  the local cards, one process a card, and joins them (NCCL; gloo with
  `--device cpu`); launched by torchrun, each rank joins the group from
  the environment (`parallel.mesh.maybe_init_distributed`, called first,
  as `ppsurf_tpu/cli.py:280-286`).
- `test` scores the classifier on the test set into
  `<results>/<name>/<dataset>/metrics_<name>.csv` and `.xlsx`, and
  `predict` writes the meshes (`Predictor.predict_dataset`); both take
  `--ckpt_path` (a port `.pt` checkpoint or an inference `.npz`), else the
  newest `last.pt` under `trainer.default_root_dir`; `predict` of a
  PPSurf model falls back to the committed
  `models_pretrained/ppsurf_mini_infer.npz`. Orbax checkpoints are read by
  the JAX package only. Their resolved config goes beside the checkpoint
  as `config_test.yaml` / `config_predict.yaml`. `predict` shards the
  field's query chunks over `trainer.devices` local cards (clamped to
  those present; unset: one), as the JAX package's `Predictor(devices=)`.
- `--device cuda` (the default) or `--device cpu`; the network computes in
  bfloat16 on the card when the trainer's precision is 16-bit, and in
  float32 on the CPU, as the JAX package picks its dtype from its platform.
- `main` first tells glibc to keep freed memory (`utils/alloc.py`, as
  `ppsurf_tpu/cli.py:275-277` does).
- After reconstructing a dataset, `predict` scores its meshes against the
  dataset's `03_meshes` (`train.evaluate.evaluate_reconstructions`, as
  `ppsurf_tpu/cli.py:350-351`): Chamfer, F1, IoU and normal-error tables
  beside the meshes, the inside/outside tests on `--device`. A dataset
  without `03_meshes` skips the scoring with a warning.
"""
from __future__ import annotations

import copy
import os
import sys
import typing

import torch
import yaml

USAGE = ("usage: python -m ppsurf_tpu_torch.cli {fit,test,predict,rec} "
         "[rec: <cloud> <out_dir>] [-c config.yaml ...] [--dotted.key value ...] "
         "[--print_config]")


def deep_merge(base: dict, override: dict) -> dict:
    """Later-wins recursive dict merge (jsonargparse config stacking)."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def set_dotted(cfg: dict, dotted_key: str, value: str) -> None:
    """Apply a `--a.b.c value` override with YAML-typed parsing."""
    keys = dotted_key.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = yaml.safe_load(value)


def parse_cli(argv: typing.Sequence[str]):
    """argv -> (subcommand, config files, dotted overrides, positional
    arguments, flags)."""
    if not argv:
        raise SystemExit(USAGE)
    subcommand = argv[0]
    configs: typing.List[str] = []
    overrides: typing.List[typing.Tuple[str, str]] = []
    positional: typing.List[str] = []
    flags = {"print_config": False}
    i = 1
    while i < len(argv):
        a = argv[i]
        if a in ("-c", "--config"):
            configs.append(argv[i + 1])
            i += 2
        elif a == "--print_config":
            flags["print_config"] = True
            i += 1
        elif a.startswith("--"):
            overrides.append((a[2:], argv[i + 1]))
            i += 2
        else:
            positional.append(a)
            i += 1
    return subcommand, configs, overrides, positional, flags


_MODEL_KIND_BY_CLASS = {
    "source.poco_model.PocoModel": "poco",
    "source.ppsurf_model.PPSurfModel": "ppsurf",
    "ppsurf_tpu.PocoModel": "poco",
    "ppsurf_tpu.PPSurfModel": "ppsurf",
    "poco": "poco",
    "ppsurf": "ppsurf",
}


def resolve_config(configs: typing.Sequence[str], overrides, subcommand: str) -> dict:
    """The configs merged in order, then the overrides applied."""
    cfg: dict = {}
    for path in configs:
        with open(path) as fp:
            cfg = deep_merge(cfg, yaml.safe_load(fp) or {})
    for key, value in overrides:
        set_dotted(cfg, key, value)
    cfg.setdefault("subcommand", subcommand)
    return cfg


def rewrite_rec_args(positional, overrides):
    """`rec in_file out_dir` -> the overrides of a predict run."""
    if len(positional) < 2:
        raise SystemExit("usage: rec <in_file> <out_dir> [-c config.yaml ...] "
                         "[--dotted.key value ...]")
    in_file, out_dir = positional[0], positional[1]
    return list(overrides) + [("data.init_args.in_file", in_file),
                              ("model.init_args.results_dir", out_dir)]


def _section(cfg: dict, name: str) -> dict:
    sec = cfg.get(name, {}) or {}
    return sec.get("init_args", sec) or {}


def build_spec(cfg: dict, device: torch.device):
    """The model spec of a merged config (`ppsurf_tpu/cli.py:104-160`)."""
    from ppsurf_tpu_torch.train.model import ModelSpec

    model_sec = cfg.get("model", {}) or {}
    model_args = _section(cfg, "model")
    data_args = _section(cfg, "data")
    kind = _MODEL_KIND_BY_CLASS.get(
        model_sec.get("class_path", model_args.get("kind", "ppsurf")), "ppsurf")
    precision = str((cfg.get("trainer", {}) or {}).get("precision", "16-mixed"))
    half = "16" in precision and "32" not in precision
    dtype = torch.bfloat16 if half and device.type == "cuda" else torch.float32
    return ModelSpec(
        name=model_args.get("name", "ppsurf"),
        kind=kind,
        in_channels=model_args.get("in_channels", 3),
        out_channels=model_args.get("out_channels", 2),
        k=model_args.get("k", 64),
        network_latent_size=model_args.get("network_latent_size",
                                           256 if kind == "ppsurf" else 32),
        pointnet_latent_size=model_args.get("pointnet_latent_size", 256),
        num_pts_local=model_args.get("num_pts_local", 50 if kind == "ppsurf" else None),
        gen_subsample_manifold=model_args.get("gen_subsample_manifold", 10000),
        gen_subsample_manifold_iter=model_args.get("gen_subsample_manifold_iter", 10),
        gen_resolution_global=model_args.get("gen_resolution_global", 257),
        rec_batch_size=model_args.get("rec_batch_size", 50000),
        gen_refine_iter=model_args.get("gen_refine_iter", 10),
        output_names=tuple(model_args.get("output_names", ["imp_surf_sign"])),
        results_dir=model_args.get("results_dir", "results"),
        padding_factor=data_args.get("padding_factor", 0.05),
        dtype=dtype,
    )


def build_train_config(cfg: dict, spec):
    """The trainer's configuration of a merged config (`ppsurf_tpu/cli.py:162-181`)."""
    from ppsurf_tpu_torch.train.loop import TrainConfig

    trainer = cfg.get("trainer", {}) or {}
    opt_args = _section(cfg, "optimizer")
    sched_args = _section(cfg, "lr_scheduler")
    return TrainConfig(
        max_epochs=trainer.get("max_epochs", 150),
        lr=float(opt_args.get("lr", 1e-3)),
        weight_decay=float(opt_args.get("weight_decay", 1e-2)),
        betas=tuple(float(b) for b in opt_args.get("betas", (0.9, 0.999))),
        eps=float(opt_args.get("eps", 1e-5)),
        lr_milestones=tuple(sched_args.get("milestones", (75, 125))),
        lr_gamma=float(sched_args.get("gamma", 0.1)),
        batch_size=_section(cfg, "data").get("batch_size", 10),
        seed=cfg.get("seed_everything", 42),
        log_every_n_steps=trainer.get("log_every_n_steps", 1),
        default_root_dir=trainer.get("default_root_dir", f"models/{spec.name}"),
        debug=bool(cfg.get("debug", False) or _section(cfg, "model").get("debug", False)),
        num_devices=_none_if_auto(trainer.get("devices")),
        profiler=trainer.get("profiler"),
    )


def _none_if_auto(v):
    """`trainer.devices`: None, 'auto' and -1 mean every local device."""
    if v in (None, "auto", -1):
        return None
    return int(v)


def _none_if_neg(v):
    if v is None or (isinstance(v, int) and v <= 0):
        return None
    return v


def build_datamodule(cfg: dict, spec, train_cfg):
    """The data module of a merged config (`ppsurf_tpu/cli.py:183-194`)."""
    from ppsurf_tpu_torch.data.datasets import OccupancyDataModule

    data_args = _section(cfg, "data")
    return OccupancyDataModule(
        in_file=data_args.get("in_file", "datasets/abc_train/testset.txt"),
        batch_size=train_cfg.batch_size,
        manifold_points=data_args.get("manifold_points", 10000),
        padding_factor=data_args.get("padding_factor", 0.05),
        seed=data_args.get("seed", train_cfg.seed),
        do_data_augmentation=bool(data_args.get("do_data_augmentation", True)),
        patches_per_shape=_none_if_neg(data_args.get("patches_per_shape", -1)),
        with_raw_cloud=spec.is_ppsurf,
        workers=data_args.get("workers", 8),
    )


def save_resolved_config(cfg: dict, version_dir: str, subcommand: str) -> None:
    """The resolved config as `config.yaml` (fit) or `config_{subcommand}.yaml`
    in the run dir (`ppsurf_tpu/cli.py:254-274`)."""
    name = "config.yaml" if subcommand == "fit" else f"config_{subcommand}.yaml"
    os.makedirs(version_dir, exist_ok=True)
    with open(os.path.join(version_dir, name), "w") as fp:
        yaml.safe_dump(cfg, fp, sort_keys=False)


def checkpoint_path(cfg: dict, spec, train_cfg, subcommand: str) -> str:
    """The weights a test or predict run loads: `ckpt_path`, else the newest
    `last.pt` under the trainer's root, else (predict, PPSurf) the
    committed inference `.npz`."""
    from ppsurf_tpu_torch.convert.checkpoint import find_last_checkpoint
    from ppsurf_tpu_torch.recon.predict import DEFAULT_WEIGHTS

    ckpt = cfg.get("ckpt_path") or find_last_checkpoint(train_cfg.default_root_dir)
    if ckpt is None:
        if subcommand == "predict" and spec.is_ppsurf:
            return DEFAULT_WEIGHTS
        raise SystemExit(f"no weights for the {spec.kind} network: no checkpoint under "
                         f"{train_cfg.default_root_dir}; pass --ckpt_path <last.pt or "
                         "inference .npz>")
    if not str(ckpt).endswith((".pt", ".npz")):
        raise SystemExit(
            f"{ckpt}: the port reads its own `.pt` checkpoints and inference `.npz` "
            "weights only; orbax checkpoints are read by the JAX package "
            "(ppsurf_tpu.convert.infer_npz writes the `.npz`)")
    return str(ckpt)


def _fit_rank(rank: int, argv: typing.Sequence[str], world: int, port: int) -> None:
    """One rank of a spawned `fit` (`spawn_fit`): torchrun's environment,
    then `main`."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    rc = main(argv)
    if rc != 0:
        raise SystemExit(rc)


def spawn_fit(argv: typing.Sequence[str], world: int) -> None:
    """`fit` on `world` ranks of this host, one process each (spawned,
    joined; a failed rank raises)."""
    import torch.multiprocessing

    from ppsurf_tpu_torch.parallel.mesh import free_port

    torch.multiprocessing.start_processes(_fit_rank, args=(list(argv), world, free_port()),
                                          nprocs=world, join=True, start_method="spawn")


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    from ppsurf_tpu_torch.convert.checkpoint import load_checkpoint_variables
    from ppsurf_tpu_torch.convert.infer_npz import load_network
    from ppsurf_tpu_torch.device import resolve_device
    from ppsurf_tpu_torch.parallel.mesh import is_distributed, local_devices, maybe_init_distributed
    from ppsurf_tpu_torch.utils.alloc import tune_host_allocator

    tune_host_allocator()
    argv = list(sys.argv[1:] if argv is None else argv)
    subcommand, configs, overrides, positional, flags = parse_cli(argv)
    if subcommand == "rec":
        overrides = rewrite_rec_args(positional, overrides)
        subcommand = "predict"
    if subcommand not in ("fit", "test", "predict"):
        raise SystemExit(f"unknown subcommand: {subcommand}\n{USAGE}")

    cfg = resolve_config(configs, overrides, subcommand)
    if flags["print_config"]:
        print(yaml.safe_dump(cfg, sort_keys=False))
        return 0
    device = resolve_device(cfg.get("device", "cuda"))
    # torchrun's ranks join their group before any launch (NCCL across
    # cards, gloo on the CPU)
    maybe_init_distributed("gloo" if device.type == "cpu" else "nccl")
    spec = build_spec(cfg, device)
    train_cfg = build_train_config(cfg, spec)
    datamodule = build_datamodule(cfg, spec, train_cfg)

    if subcommand == "fit":
        from ppsurf_tpu_torch.train.loop import Trainer

        world = train_cfg.num_devices or len(local_devices(device))
        if world > 1 and not is_distributed():
            spawn_fit(argv, world)
            print(f"fit: {world} ranks joined ({spec.name}, {spec.kind}, {device})")
            return 0
        trainer = Trainer(spec, train_cfg, device=device)
        if trainer.is_main:
            save_resolved_config(cfg, trainer.version_dir, subcommand)
        state = trainer.fit(datamodule, ckpt_path=cfg.get("ckpt_path"))
        if trainer.is_main:
            print(f"fit: {state.step} steps ({spec.name}, {spec.kind}, "
                  f"{str(spec.dtype).replace('torch.', '')}, {trainer.device}, "
                  f"{trainer.mesh.size} rank(s)) -> {os.path.join(trainer.ckpt_dir, 'last.pt')}")
        return 0

    ckpt = checkpoint_path(cfg, spec, train_cfg, subcommand)
    variables = load_checkpoint_variables(ckpt)
    if ckpt.endswith(".pt"):  # .../version_{v}/checkpoints/last.pt -> version_{v}
        save_resolved_config(cfg, os.path.dirname(os.path.dirname(os.path.abspath(ckpt))),
                             subcommand)

    if subcommand == "test":
        from ppsurf_tpu_torch.train.evaluate import run_test

        run_test(spec, load_network(spec, variables, device), datamodule.test_dataset(),
                 seed=train_cfg.seed)
        return 0

    from ppsurf_tpu_torch.recon.predict import Predictor
    from ppsurf_tpu_torch.train.evaluate import evaluate_reconstructions

    predictor = Predictor(spec, variables=variables, device=device,
                          devices=train_cfg.num_devices)
    results = predictor.predict_dataset(datamodule.predict_dataset())
    done = [r for r in results if r[1] is not None]
    for name, out_file, seconds in done:
        print(f"{name}: {seconds:.2f} s -> {out_file}")
    print(f"{len(done)} of {len(results)} shapes reconstructed ({spec.name}, {spec.kind}, "
          f"{str(spec.dtype).replace('torch.', '')}, {device}, weights {ckpt})")
    evaluate_reconstructions(spec, datamodule.paths.in_file, device=device)
    return 0 if len(done) == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
