"""Convert the reference's published Lightning checkpoints to the port's
`last.pt`.

The reference ships trained weights as a Lightning `last.ckpt` whose
`state_dict` holds `network.*` tensors (`models/download_ppsurf_50nn.py`,
reference `poco_model.py:51`, `ppsurf_model.py:33`). The port's modules
carry the flax names of the JAX package, so the conversion is the JAX
package's re-layout (`ppsurf_tpu/convert/torch_ckpt.py:30-206`) into the
nested {'params', 'batch_stats'} numpy tree:

  torch Conv1d/Conv2d(1x1) weight (out,in,1[,1]) -> Dense kernel (in,out)
  torch Linear weight (out,in)                   -> Dense kernel (in,out)
  FKAConv cv Conv2d weight (out,in,1,K)          -> cv (in,K,out)
  BatchNorm1d weight/bias/running_{mean,var}     -> scale/bias + batch_stats
  InstanceNorm2d weight/bias                     -> scale/bias
  alpha/beta/norm_radius (1,)                    -> scalars

`convert_torch_checkpoint` writes that tree as a port checkpoint
(`convert/checkpoint.py`, the step from the file's `global_step`, no
optimizer state), which `cli test|predict --ckpt_path` reads.

    python -m ppsurf_tpu_torch.convert.torch_ckpt last.ckpt \
        models/ppsurf_50nn/version_0/checkpoints/last.pt
"""
from __future__ import annotations

import argparse
import typing

import numpy as np


def _np(t) -> np.ndarray:
    try:  # torch tensor
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


class _Flat:
    """Prefix view over the flat torch state_dict."""

    def __init__(self, sd: dict, prefix: str = ""):
        self.sd = sd
        self.prefix = prefix

    def sub(self, name: str) -> "_Flat":
        return _Flat(self.sd, f"{self.prefix}{name}.")

    def __contains__(self, name: str) -> bool:
        return f"{self.prefix}{name}" in self.sd

    def get(self, name: str) -> np.ndarray:
        return _np(self.sd[f"{self.prefix}{name}"])


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """1x1 Conv1d/Conv2d (out,in,1[,1]) or Linear (out,in) -> (in,out)."""
    return np.ascontiguousarray(w.reshape(w.shape[0], w.shape[1]).T)


def _dense(f: _Flat, name: str) -> dict:
    p = {"kernel": _conv_kernel(f.get(f"{name}.weight"))}
    if f"{name}.bias" in f:
        p["bias"] = f.get(f"{name}.bias")
    return p


def _bn(f: _Flat, name: str) -> typing.Tuple[dict, dict]:
    params = {"scale": f.get(f"{name}.weight"), "bias": f.get(f"{name}.bias")}
    stats = {
        "mean": f.get(f"{name}.running_mean"),
        "var": f.get(f"{name}.running_var"),
    }
    return params, stats


def _instance_norm(f: _Flat, name: str) -> dict:
    return {"scale": f.get(f"{name}.weight"), "bias": f.get(f"{name}.bias")}


def _fkaconv_layer(f: _Flat) -> typing.Tuple[dict, dict]:
    w_cv = f.get("cv.weight")  # (out, in, 1, K)
    params = {
        "alpha": f.get("alpha").reshape(()),
        "beta": f.get("beta").reshape(()),
        "cv": np.ascontiguousarray(np.transpose(w_cv[:, :, 0, :], (1, 2, 0))),
        "fc1": {"kernel": _conv_kernel(f.get("fc1.weight"))},
        "fc2": {"kernel": _conv_kernel(f.get("fc2.weight"))},
        "fc3": {"kernel": _conv_kernel(f.get("fc3.weight"))},
        "bn1": _instance_norm(f, "bn1"),
        "bn2": _instance_norm(f, "bn2"),
    }
    stats = {"norm_radius": f.get("norm_radius").reshape(())}
    return params, stats


def _residual_block(f: _Flat) -> typing.Tuple[dict, dict]:
    cv1_p, cv1_s = _fkaconv_layer(f.sub("cv1"))
    params = {"cv0": _dense(f, "cv0"), "cv1": cv1_p, "cv2": _dense(f, "cv2")}
    stats = {"cv1": cv1_s}
    for bn in ("bn0", "bn1", "bn2"):
        params[bn], stats[bn] = _bn(f, bn)
    if "shortcut.weight" in f:  # identity when in_channels == out_channels
        params["shortcut"] = _dense(f, "shortcut")
        params["bn_shortcut"], stats["bn_shortcut"] = _bn(f, "bn_shortcut")
    return params, stats


def _fkaconv_network(f: _Flat) -> typing.Tuple[dict, dict]:
    cv0_p, cv0_s = _fkaconv_layer(f.sub("cv0"))
    params: dict = {"cv0": cv0_p}
    stats: dict = {"cv0": cv0_s}
    params["bn0"], stats["bn0"] = _bn(f, "bn0")
    for name in (
        "resnetb01", "resnetb10", "resnetb11", "resnetb20", "resnetb21",
        "resnetb30", "resnetb31", "resnetb40", "resnetb41",
    ):
        params[name], stats[name] = _residual_block(f.sub(name))
    for cv, bn in (
        ("cv5", "bn5"), ("cv3d", "bn3d"), ("cv2d", "bn2d"),
        ("cv1d", "bn1d"), ("cv0d", "bn0d"),
    ):
        if f"{cv}.weight" in f:  # segmentation head
            params[cv] = _dense(f, cv)
            params[bn], stats[bn] = _bn(f, bn)
    params["fcout"] = _dense(f, "fcout")
    return params, stats


def _interp_attention(f: _Flat) -> dict:
    return {
        name: _dense(f, name)
        for name in ("fc1", "fc2", "fc3", "fc8", "fc_query", "fc_value")
    }


def _stn(f: _Flat) -> typing.Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    for conv in ("conv1", "conv2", "conv3"):
        params[conv] = _dense(f, conv)
    for fc in ("fc1", "fc2", "fc3"):
        params[fc] = _dense(f, fc)
    for bn in ("bn1", "bn2", "bn3", "bn4", "bn5"):
        params[bn], stats[bn] = _bn(f, bn)
    if "fc0.weight" in f:  # multi-scale variant
        params["fc0"] = _dense(f, "fc0")
        params["bn0"], stats["bn0"] = _bn(f, "bn0")
    return params, stats


def _pointnetfeat(f: _Flat) -> typing.Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    for conv in ("conv0a", "conv0b", "conv1", "conv2", "conv3", "conv4"):
        if f"{conv}.weight" in f:
            params[conv] = _dense(f, conv)
    for bn in ("bn0a", "bn0b", "bn1", "bn2", "bn3", "bn4"):
        if f"{bn}.weight" in f:
            params[bn], stats[bn] = _bn(f, bn)
    if "stn1.conv1.weight" in f:
        params["stn1"], stats["stn1"] = _stn(f.sub("stn1"))
    if "stn2.conv1.weight" in f:
        params["stn2"], stats["stn2"] = _stn(f.sub("stn2"))
    if "att.fc_query.weight" in f:
        params["att"] = {
            "fc_query": _dense(f, "att.fc_query"),
            "fc_value": _dense(f, "att.fc_value"),
        }
    return params, stats


def _mlp(f: _Flat) -> typing.Tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    i = 0
    while f"layers.{i}.0.weight" in f:
        has_bn = f"layers.{i}.1.weight" in f
        if has_bn:
            params[f"fc{i}"] = _dense(f, f"layers.{i}.0")
            params[f"bn{i}"], stats[f"bn{i}"] = _bn(f, f"layers.{i}.1")
        else:  # final layer
            params["fc_final"] = _dense(f, f"layers.{i}.0")
        i += 1
    return params, stats


def convert_state_dict(
    state_dict: dict, network_prefix: str = "network."
) -> typing.Tuple[dict, dict]:
    """Flat Lightning state_dict -> nested (params, batch_stats) numpy trees.

    Handles both PPSurfNetwork (encoder/projection/point_net/mlp,
    reference `ppsurf_model.py:39-117`) and PocoNetwork
    (encoder/projection, `poco_model.py:332-359`).
    """
    f = _Flat(state_dict, network_prefix)
    params: dict = {}
    stats: dict = {}
    params["encoder"], stats["encoder"] = _fkaconv_network(f.sub("encoder"))
    params["projection"] = _interp_attention(f.sub("projection"))
    if "point_net.conv0a.weight" in f:
        params["point_net"], stats["point_net"] = _pointnetfeat(
            f.sub("point_net")
        )
    if "mlp.layers.0.0.weight" in f:
        params["mlp"], stats["mlp"] = _mlp(f.sub("mlp"))
    return params, stats


def convert_torch_checkpoint(ckpt_path: str, out_path: str) -> str:
    """Read a reference Lightning `.ckpt` and write the port's `last.pt`
    (`convert/checkpoint.py::save_checkpoint`'s format) to `out_path`."""
    import torch

    from ppsurf_tpu_torch.convert.checkpoint import save_variables

    # a Lightning checkpoint pickles more than tensors (loops, callbacks,
    # hyper-parameters): it loads only with weights_only=False
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw)
    params, stats = convert_state_dict(sd)
    return save_variables(out_path, {"params": params, "batch_stats": stats},
                          step=int(raw.get("global_step", 0)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("ckpt", help="Lightning .ckpt of the reference")
    parser.add_argument("out", help="the port checkpoint (.pt) to write")
    args = parser.parse_args(argv)
    out = convert_torch_checkpoint(args.ckpt, args.out)
    print(f"converted {args.ckpt} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
