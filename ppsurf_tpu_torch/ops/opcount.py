"""Operation counts of the field and the H100's peak rates.

The multiply-adds a field query costs, from the model's widths, as the
port computes them: K3 runs the decoder tail on each of the k neighbour
rows (fc1's relative-position rows, fc2, fc3, fc_value and fc_query of
the 64 heads; fc1's latent rows are folded into the latents once a shape
and are not counted), fc8 runs once; for PPSurf K4 runs the PointNet
trunk (conv0a, conv0b, the STN's conv1-conv3) and K5 the head (conv1-conv3,
the attention pool's fc_query and fc_value) on each of the P patch
points, the STN head (fc1-fc3) and the MLP once. Weights only: the STN's
64 x 64 transform, the softmaxes and the gathers are not counted.

`chip_smoke.py` bounds K3-K5 with the per-row counts; the benchmark
(`tools/bench.py`) divides the field's operations by its field seconds.
"""
from __future__ import annotations

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}

HEADS = 64  # the decoder's attention heads
STN_DIM = 64  # the feature transform's size


def tail_macs(lat: int, heads: int = HEADS) -> int:
    """Multiply-adds of one neighbour row of K3 at latent `lat`."""
    return 3 * lat + 3 * lat * lat + lat * heads


def trunk_macs(net_size_max: int = 256) -> int:
    """Multiply-adds of one patch point of K4."""
    return 3 * 64 + 64 * 64 + STN_DIM * 64 + 64 * 128 + 128 * net_size_max


def head_macs(out: int = 256) -> int:
    """Multiply-adds of one patch point of K5."""
    return 64 * 64 + 64 * 128 + 128 * out + out + out * out


def stn_head_macs(net_size_max: int = 256) -> int:
    """Multiply-adds of the STN's fc1-fc3, once a query."""
    half, quarter = net_size_max // 2, net_size_max // 4
    return net_size_max * half + half * quarter + quarter * STN_DIM * STN_DIM


TRUNK_MACS = trunk_macs()
HEAD_MACS = head_macs()


def field_macs(spec) -> int:
    """Multiply-adds of one field query of `spec`'s network (a
    `train.model.ModelSpec`)."""
    lat = spec.network_latent_size
    if not spec.is_ppsurf:  # POCO: the decoder, fc8 to the logits
        return spec.k * tail_macs(lat) + lat * spec.out_channels
    p, nsm = spec.num_pts_local, spec.pointnet_latent_size
    mlp = 2 * lat * lat + lat * spec.out_channels  # fc0, fc1, fc_final
    return (spec.k * tail_macs(lat) + lat * lat
            + p * (trunk_macs(nsm) + head_macs(lat)) + stn_head_macs(nsm) + mlp)


def field_flops(spec) -> float:
    """Operations (two a multiply-add) of one field query."""
    return 2.0 * field_macs(spec)
