"""The profiler preset of the port (`trainer.profiler: jax`,
`configs/profiler.yaml`, `utils/profiling.py::torch_trace`): a CPU
`Trainer.fit` of 6 steps traces steps 2-4, as the JAX package's loop does
(`ppsurf_tpu/train/loop.py:323-346`), into `<run dir>/profile` as a Chrome
trace whose step spans are those three and no other, with the time by
span beside it (`utils/profiling.py::attribute`), and prints nothing
about the preset being unsupported; the config file sets the preset.
"""
from __future__ import annotations

import json
import os

import yaml

from ppsurf_tpu_torch import cli
from ppsurf_tpu_torch.data.datasets import OccupancyDataModule
from ppsurf_tpu_torch.train import loop
from ppsurf_tpu_torch.train import model as tmodel
from ppsurf_tpu_torch.utils import profiling

from test_torch_data import write_training_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_profiler_preset_traces_steps_2_to_4(tmp_path, capsys):
    with open(os.path.join(REPO, "configs", "profiler.yaml")) as fp:
        preset = yaml.safe_load(fp)
    cfg = cli.build_train_config(preset, tmodel.ppsurf_spec())
    assert cfg.profiler == "jax"

    in_file = write_training_dataset(str(tmp_path / "ds"), n_train=6, n_val=1, n_test=1,
                                     n_pts=200, n_query=32)
    spec = tmodel.ppsurf_spec(network_latent_size=16, pointnet_latent_size=16,
                              num_pts_local=8, k=8)
    config = loop.TrainConfig(max_epochs=2, batch_size=2, profiler=cfg.profiler,
                              default_root_dir=str(tmp_path / "models"))
    dm = OccupancyDataModule(in_file=in_file, batch_size=2, manifold_points=64,
                             patches_per_shape=16, seed=42, workers=1)
    trainer = loop.Trainer(spec, config, device="cpu")
    state = trainer.fit(dm)
    assert state.step == 6  # 3 steps an epoch
    trace = os.path.join(trainer.version_dir, "profile", "trace_rank0.json")
    with open(trace) as fp:
        events = json.load(fp)["traceEvents"]
    steps = sorted({e["name"] for e in events if e.get("name", "").startswith("train_step ")})
    assert steps == ["train_step 2", "train_step 3", "train_step 4"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::addmm" in names or "aten::matmul" in names
    assert "not ported" not in capsys.readouterr().out
    # beside the trace, the time by span of the three traced steps
    with open(os.path.join(trainer.version_dir, "profile", "trace_rank0.spans.json")) as fp:
        table = json.load(fp)["spans"]
    assert sorted(k for k in table if k.startswith("train_step ")) == steps
    for name in ("step.forward", "step.backward", "step.optimizer"):
        assert table[name]["count"] == 3 and table[name]["host_s"] > 0
    assert table["train_step 2"]["self_s"] < table["train_step 2"]["host_s"]


def test_torch_trace_disabled(tmp_path):
    with profiling.torch_trace(str(tmp_path / "p"), enabled=False) as prof:
        assert prof is None
    assert not os.path.exists(tmp_path / "p")
