"""A configuration's weights, made or loaded by the benchmark and handed
to both sides: the program gets a nested {'params', 'batch_stats'} tree of
numpy arrays (the form its loader takes), the reference a flat dict of
float32 tensors on the card under the same names.

`weights` in a configuration is a path in the checkout (an inference
`.npz` with 'params/...' and 'batch_stats/...' keys, float16 kernels read
as float32) or "seeded": values drawn on the card in one call, for every
leaf of the architecture (`shapes`), from the configuration's
`weights_seed`: one network for every run, so that a run's seed moves
only its inputs (a network drawn per run moved the grown surface, and
the work, by up to 50% more grower rounds).
"""
from __future__ import annotations

import math
import os
import typing

import numpy as np
import torch

from benchmark.harness.common import ROOT

# the layer that makes the two logits: seeded at a tenth of its lecun
# scale, so the field softmax(p0) - softmax(p1) does not saturate at +-1
LOGITS = {"poco": "params/projection/fc8/kernel", "ppsurf": "params/mlp/fc_final/kernel"}


def _dense(out: dict, path: str, cin: int, cout: int, bias: bool = True) -> None:
    out[f"params/{path}/kernel"] = (cin, cout)
    if bias:
        out[f"params/{path}/bias"] = (cout,)


def _bn(out: dict, path: str, ch: int) -> None:
    out[f"params/{path}/scale"] = (ch,)
    out[f"params/{path}/bias"] = (ch,)
    out[f"batch_stats/{path}/mean"] = (ch,)
    out[f"batch_stats/{path}/var"] = (ch,)


def _fkaconv(out: dict, path: str, cin: int, cout: int, ks: int = 16) -> None:
    _dense(out, path + "/fc1", 3, ks, False)
    _dense(out, path + "/fc2", 2 * ks, ks, False)
    _dense(out, path + "/fc3", 2 * ks, ks, False)
    for bn in ("bn1", "bn2"):
        out[f"params/{path}/{bn}/scale"] = (ks,)
        out[f"params/{path}/{bn}/bias"] = (ks,)
    out[f"params/{path}/alpha"] = ()
    out[f"params/{path}/beta"] = ()
    out[f"params/{path}/cv"] = (cin, ks, cout)
    out[f"batch_stats/{path}/norm_radius"] = ()


def shapes(config: dict) -> typing.Dict[str, tuple]:
    """Every leaf of the configuration's network, by its flax name."""
    out: dict = {}
    h, lat = 64, config["network_latent_size"]
    e = "encoder/"
    _fkaconv(out, e + "cv0", 3, h)
    _bn(out, e + "bn0", h)
    for name, cin, cout in (("01", h, h), ("10", h, 2 * h), ("11", 2 * h, 2 * h),
                            ("20", 2 * h, 4 * h), ("21", 4 * h, 4 * h), ("30", 4 * h, 8 * h),
                            ("31", 8 * h, 8 * h), ("40", 8 * h, 16 * h), ("41", 16 * h, 16 * h)):
        p = f"{e}resnetb{name}/"
        half = cin // 2
        _dense(out, p + "cv0", cin, half)
        _bn(out, p + "bn0", half)
        _fkaconv(out, p + "cv1", half, half)
        _bn(out, p + "bn1", half)
        _dense(out, p + "cv2", half, cout)
        _bn(out, p + "bn2", cout)
        if cin != cout:
            _dense(out, p + "shortcut", cin, cout)
            _bn(out, p + "bn_shortcut", cout)
    for name, cin, cout in (("5", 32 * h, 16 * h), ("3d", 24 * h, 8 * h), ("2d", 12 * h, 4 * h),
                            ("1d", 6 * h, 2 * h), ("0d", 3 * h, h)):
        _dense(out, e + "cv" + name, cin, cout)
        _bn(out, e + "bn" + name, cout)
    _dense(out, e + "fcout", h, lat)
    ppsurf = config["kind"] == "ppsurf"
    d = "projection/"
    _dense(out, d + "fc1", lat + 3, lat)
    for name in ("fc2", "fc3", "fc_value"):
        _dense(out, d + name, lat, lat)
    _dense(out, d + "fc_query", lat, 64)
    _dense(out, d + "fc8", lat, lat if ppsurf else config["out_channels"])
    if ppsurf:
        p, nsm = "point_net/", config["pointnet_latent_size"]
        for conv, bn, cin, cout in (("conv0a", "bn0a", 3, 64), ("conv0b", "bn0b", 64, 64),
                                    ("stn2/conv1", "stn2/bn1", 64, 64),
                                    ("stn2/conv2", "stn2/bn2", 64, 128),
                                    ("stn2/conv3", "stn2/bn3", 128, nsm),
                                    ("stn2/fc1", "stn2/bn4", nsm, nsm // 2),
                                    ("stn2/fc2", "stn2/bn5", nsm // 2, nsm // 4),
                                    ("conv1", "bn1", 64, 64), ("conv2", "bn2", 64, 128),
                                    ("conv3", "bn3", 128, lat)):
            _dense(out, p + conv, cin, cout)
            _bn(out, p + bn, cout)
        _dense(out, p + "stn2/fc3", nsm // 4, 64 * 64)
        _dense(out, p + "att/fc_query", lat, 1)
        _dense(out, p + "att/fc_value", lat, lat)
        for i in range(2):
            _dense(out, f"mlp/fc{i}", lat, lat)
            _bn(out, f"mlp/bn{i}", lat)
        _dense(out, "mlp/fc_final", lat, config["out_channels"])
    return out


def seeded(config: dict, seed: int, device: torch.device) -> typing.Dict[str, torch.Tensor]:
    """Every leaf drawn from one normal draw on `device`: kernels
    lecun-normal (variance 1 / fan-in; FKAConv's `cv` also over its ks
    summed neighbours, so a layer keeps its input's scale), biases, norm
    shifts and BatchNorm means N(0, 0.1^2), norm scales 1 + N(0, 0.1^2), BatchNorm variances
    exp(N(0, 0.2^2)), FKAConv's alpha and beta and radius 1; the logits'
    layer at a tenth of its scale (`LOGITS`)."""
    leaves = shapes(config)
    sizes = [math.prod(s) for s in leaves.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(leaves.items(), sizes):
        z = flat[at:at + size].reshape(shape)
        at += size
        leaf = name.rsplit("/", 1)[1]
        if leaf == "kernel":
            z = z / math.sqrt(math.prod(shape[:-1]))
            if name == LOGITS.get(config["kind"]):
                z = 0.1 * z
        elif leaf == "cv":  # fan-in C x ks, and a sum over ks neighbours before it
            z = z / math.sqrt(math.prod(shape[:-1]) * shape[1])
        elif leaf in ("bias", "mean"):
            z = 0.1 * z
        elif leaf == "scale":
            z = 1.0 + 0.1 * z
        elif leaf == "var":
            z = torch.exp(0.2 * z)
        else:  # alpha, beta, norm_radius
            z = torch.ones_like(z)
        out[name] = z.contiguous()
    return out


def load(config: dict, seed: int, device: torch.device) -> typing.Dict[str, torch.Tensor]:
    """The configuration's weights as a flat dict of float32 tensors on
    `device`, checked against the architecture's leaves and shapes."""
    if config["weights"] == "seeded":  # the configuration's own network, whatever the run's seed
        return seeded(config, config["weights_seed"], device)
    with np.load(os.path.join(ROOT, config["weights"])) as z:
        flat = {k: torch.from_numpy(z[k].astype(np.float32)).to(device) for k in z.files}
    want = shapes(config)
    bad = sorted(set(want) ^ set(flat)) + sorted(
        k for k in want if k in flat and tuple(flat[k].shape) != tuple(want[k]))
    if bad:
        raise ValueError(f"{config['weights']}: leaves that do not fit {config['kind']}: "
                         f"{bad[:8]}")
    return flat


def nested(flat: typing.Dict[str, torch.Tensor]) -> dict:
    """The program's form: {'params': {...}, 'batch_stats': {...}} of numpy."""
    out: dict = {}
    for key, t in flat.items():
        *path, leaf = key.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy().copy()
    return out
