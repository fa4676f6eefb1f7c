"""Command line of the port: predict / rec with YAML config stacking.

    python -m ppsurf_tpu_torch.cli predict [-c a.yaml -c b.yaml ...] [--dotted.key value ...]
    python -m ppsurf_tpu_torch.cli rec <cloud> <out_dir> [-c ...] [--dotted.key value ...]

As `ppsurf_tpu/cli.py` (reference `source/cli.py`, `pps.py`): the
`configs/*.yaml` files stack in order with a later-wins deep merge
(`:33-50, 93-101`), `--section.init_args.key value` overrides a key with
a YAML-typed value, the model spec comes from the merged config
(`:104-160`), and `rec in_file out_dir` is `predict` with
`data.init_args.in_file` and `model.init_args.results_dir` set
(`:241-251`). `--print_config` prints the merged config.

- Weights: `--ckpt_path` names an inference `.npz` (the JAX package's
  `convert/infer_npz.py` format); without one, a PPSurf model takes the
  committed `models_pretrained/ppsurf_mini_infer.npz`. Orbax checkpoints
  are read by the JAX package only, until training is ported.
- `--device cuda` (the default) or `--device cpu`; the network computes in
  bfloat16 on the card when the trainer's precision is 16-bit, and in
  float32 on the CPU, as the JAX package picks its dtype from its platform.
- `predict` writes the meshes (`Predictor.predict_dataset`). Scoring them
  (`evaluate_reconstructions`) waits for the port of the metrics.
- `fit` and `test` belong to the JAX package until training is ported.
"""
from __future__ import annotations

import copy
import sys
import typing

import torch
import yaml

USAGE = ("usage: python -m ppsurf_tpu_torch.cli {predict,rec} [rec: <cloud> <out_dir>] "
         "[-c config.yaml ...] [--dotted.key value ...] [--print_config]")


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
        results_dir=model_args.get("results_dir", "results"),
        padding_factor=data_args.get("padding_factor", 0.05),
        dtype=dtype,
    )


def weights_path(cfg: dict, spec) -> str:
    """The inference `.npz` a predict run loads."""
    from ppsurf_tpu_torch.recon.predict import DEFAULT_WEIGHTS

    ckpt = cfg.get("ckpt_path")
    if ckpt is None:
        if not spec.is_ppsurf:
            raise SystemExit(f"no weights are committed for the {spec.kind} network: "
                             "pass --ckpt_path <inference .npz>")
        return DEFAULT_WEIGHTS
    if not str(ckpt).endswith(".npz"):
        raise SystemExit(
            f"{ckpt}: the port reads inference .npz weights only; orbax checkpoints "
            "are read by the JAX package (ppsurf_tpu.convert.infer_npz writes the "
            ".npz) until training is ported")
    return str(ckpt)


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    from ppsurf_tpu_torch.data.datasets import ShapeDataset
    from ppsurf_tpu_torch.device import resolve_device
    from ppsurf_tpu_torch.recon.predict import Predictor

    argv = list(sys.argv[1:] if argv is None else argv)
    subcommand, configs, overrides, positional, flags = parse_cli(argv)
    if subcommand in ("fit", "test"):
        raise SystemExit(f"`{subcommand}` is not ported yet: run it with the JAX "
                         "package (pps.py / poco.py)")
    if subcommand == "rec":
        overrides = rewrite_rec_args(positional, overrides)
        subcommand = "predict"
    if subcommand != "predict":
        raise SystemExit(f"unknown subcommand: {subcommand}\n{USAGE}")

    cfg = resolve_config(configs, overrides, subcommand)
    if flags["print_config"]:
        print(yaml.safe_dump(cfg, sort_keys=False))
        return 0
    device = resolve_device(cfg.get("device", "cuda"))
    spec = build_spec(cfg, device)
    in_file = _section(cfg, "data").get("in_file", "datasets/abc_train/testset.txt")
    predictor = Predictor(spec, weights=weights_path(cfg, spec), device=device)
    results = predictor.predict_dataset(ShapeDataset(in_file, padding_factor=spec.padding_factor))
    done = [r for r in results if r[1] is not None]
    for name, out_file, seconds in done:
        print(f"{name}: {seconds:.2f} s -> {out_file}")
    print(f"{len(done)} of {len(results)} shapes reconstructed ({spec.name}, {spec.kind}, "
          f"{str(spec.dtype).replace('torch.', '')}, {device}); scoring them "
          "(evaluate_reconstructions) waits for the port of the metrics")
    return 0 if len(done) == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
