"""Reconstruct one point cloud file into a mesh.

    python -m ppsurf_tpu_torch.rec <cloud.{ply,xyz,npy,...}> <out_dir>
        [-c config.yaml ...] [--dotted.key value ...] [--device cuda|cpu]

The front of `python -m ppsurf_tpu_torch.cli rec` (see `cli.py`): the
cloud is normalized into the unit cube (with the model's padding),
reconstructed, and the mesh is written in the input's coordinates to
`<out_dir>/<base>/<base>.ply`, the base name keeping its extension, as the
JAX package writes it (`ppsurf_tpu/recon/predict.py:132-136`).
"""
from __future__ import annotations

import sys
import typing

from ppsurf_tpu_torch import cli


def main(argv: typing.Optional[typing.List[str]] = None) -> int:
    return cli.main(["rec", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    sys.exit(main())
