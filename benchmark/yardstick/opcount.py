"""Operations and bytes of the work a reconstruction asks for, and the
H100's peaks.

The field's counts are a frozen copy of the program's `ops/opcount.py`
(multiply-adds from the widths: K3 runs the decoder tail on each of the k
neighbour rows, fc8 once; for PPSurf K4 runs the PointNet trunk and K5
the head on each of the P patch points, the STN head and the MLP once).
Added here: the FKAConv encoder's products, fc1's latent rows folded into
the latents once a shape, and the bytes each kernel call has to move at
least (inputs read once, outputs written once). Weights only: softmaxes,
norms, gathers and the STN's 64 x 64 transform are not counted.

`config` below is a configuration file's dict (`benchmark/configs/*.json`).
"""
from __future__ import annotations

import typing

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "tf32": 495e12}

HEADS = 64  # the decoder's attention heads
STN_DIM = 64  # the feature transform's size
ENC_HIDDEN = 64  # the FKAConv U-Net's first width
ENC_KERNEL = 16  # FKAConv kernel size and neighbourhood
BF16, F32, I32 = 2, 4, 4  # bytes an element


def peak_ops(config: dict) -> float:
    return PEAK_OPS["bf16" if config["precision"] == "bf16" else "f32"]


def elem_bytes(config: dict) -> int:
    return BF16 if config["precision"] == "bf16" else F32


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


def is_ppsurf(config: dict) -> bool:
    return config["kind"] == "ppsurf"


def decoder_tail_query_macs(config: dict) -> int:
    """K3's multiply-adds a field query: k rows of the tail."""
    return config["k"] * tail_macs(config["network_latent_size"])


def pointnet_query_macs(config: dict) -> int:
    """K4's and K5's multiply-adds a field query (0 for POCO)."""
    if not is_ppsurf(config):
        return 0
    return config["num_pts_local"] * (trunk_macs(config["pointnet_latent_size"])
                                      + head_macs(config["network_latent_size"]))


def field_macs(config: dict) -> int:
    """Multiply-adds of one field query."""
    lat = config["network_latent_size"]
    out = config["out_channels"]
    if not is_ppsurf(config):  # POCO: the decoder, fc8 to the logits
        return decoder_tail_query_macs(config) + lat * out
    mlp = 2 * lat * lat + lat * out  # fc0, fc1, fc_final
    return (decoder_tail_query_macs(config) + lat * lat + pointnet_query_macs(config)
            + stn_head_macs(config["pointnet_latent_size"]) + mlp)


def level_sizes(n: int, num_levels: int = 4, ratio: float = 0.25) -> typing.List[int]:
    """Support points a level of the FKAConv U-Net (the program's
    `ops/graph.py::level_sizes`)."""
    sizes, cur = [], n
    for _ in range(num_levels):
        nxt = max(1, int(cur * ratio))
        nxt = min(cur, ((nxt + 7) // 8) * 8) if cur >= 8 else max(1, nxt)
        sizes.append(nxt)
        cur = nxt
    return sizes


def _fkaconv_macs(c_in: int, c_out: int, m: int, k: int = ENC_KERNEL) -> int:
    """One FKAConv layer at m support points: the kernel net (fc1 3->ks,
    fc2 and fc3 2ks->ks on each neighbour), x^T mat and the (C*ks -> O)
    product."""
    ks = ENC_KERNEL
    return m * (k * (3 * ks + 2 * (2 * ks) * ks) + k * c_in * ks + c_in * ks * c_out)


def _resblock_macs(c_in: int, c_out: int, n_in: int, m: int) -> int:
    half = c_in // 2
    macs = n_in * c_in * half + _fkaconv_macs(half, half, m) + m * half * c_out
    if c_in != c_out:
        macs += n_in * c_in * c_out  # the shortcut, before its max pool
    return macs


def encoder_chunk_macs(config: dict, n: int) -> int:
    """Multiply-adds of one FKAConv U-Net pass over a chunk of n points."""
    h = ENC_HIDDEN
    n1, n2, n3, n4 = level_sizes(n)
    macs = _fkaconv_macs(3, h, n)
    macs += _resblock_macs(h, h, n, n)
    macs += _resblock_macs(h, 2 * h, n, n1) + _resblock_macs(2 * h, 2 * h, n1, n1)
    macs += _resblock_macs(2 * h, 4 * h, n1, n2) + _resblock_macs(4 * h, 4 * h, n2, n2)
    macs += _resblock_macs(4 * h, 8 * h, n2, n3) + _resblock_macs(8 * h, 8 * h, n3, n3)
    macs += _resblock_macs(8 * h, 16 * h, n3, n4) + _resblock_macs(16 * h, 16 * h, n4, n4)
    if is_ppsurf(config):  # the global-max bottleneck (POCO discards it unrun)
        macs += n4 * 32 * h * 16 * h
    macs += n3 * 24 * h * 8 * h + n2 * 12 * h * 4 * h + n1 * 6 * h * 2 * h + n * 3 * h * h
    macs += n * h * config["network_latent_size"]
    return macs


def encoder_layout(config: dict, n: int) -> typing.Tuple[int, int]:
    """(chunk size, chunks a pass) of the latent encoder on n points
    (the cloud's size bucketed up to 5 000, cut into chunks)."""
    s = min(config["gen_subsample_manifold"], n)
    nb = -(-n // 5000) * 5000 if n > s else n
    return s, -(-nb // s)


def object_flops(config: dict, n_points: int, field_queries: int) -> float:
    """Operations (two a multiply-add) of one reconstruction: every
    encoder pass, fc1's latent rows folded once, every field query."""
    s, chunks = encoder_layout(config, n_points)
    lat = config["network_latent_size"]
    enc = config["gen_subsample_manifold_iter"] * chunks * encoder_chunk_macs(config, s)
    fold = n_points * lat * lat
    return 2.0 * (enc + fold + field_queries * field_macs(config))


def decoder_tail_work(config: dict, queries: int, calls: int
                      ) -> typing.Tuple[float, float]:
    """(operations, bytes) of K3 over `calls` launches that together
    evaluate `queries` rows: each launch reads the weights once; each
    query its point and its k ids, and writes its pooled row (the latent
    and point rows it gathers are left out: which it needs depends on the
    cloud, so the bound stays a lower one)."""
    lat, k, e = config["network_latent_size"], config["k"], elem_bytes(config)
    weights = (3 * lat + 2 * lat * lat + lat * HEADS + lat * lat + 4 * lat + HEADS) * e
    per_query = 3 * F32 + k * I32 + lat * e
    return 2.0 * queries * decoder_tail_query_macs(config), calls * weights + queries * per_query


def pointnet_work(config: dict, queries: int, calls: int) -> typing.Tuple[float, float]:
    """(operations, bytes) of K4 and K5 together, as one piece of work,
    over `calls` launches of each: each query's P patch points in, its
    pooled row out; the weights once a launch."""
    if not is_ppsurf(config):
        return 0.0, 0.0
    p, nsm, lat, e = (config["num_pts_local"], config["pointnet_latent_size"],
                      config["network_latent_size"], elem_bytes(config))
    weights = (trunk_macs(nsm) + head_macs(lat)) * e
    per_query = p * 3 * e + lat * e
    return 2.0 * queries * pointnet_query_macs(config), calls * weights + queries * per_query


def roofline_seconds(ops: float, nbytes: float, config: dict) -> float:
    """The least time the work could take on one H100."""
    return max(ops / peak_ops(config), nbytes / PEAK_BYTES)


def train_step_flops(config: dict, batch: int, points: int, queries: int) -> float:
    """Operations of one training step: three times the forward's (the
    backward's two products a forward one) over the batch: the encoder on
    each item's `points`, and at each of its `queries` the decoder with
    fc1's latent rows on every neighbour row (nothing is folded in
    training), the PointNet branch and the MLP."""
    lat = config["network_latent_size"]
    field = config["k"] * (tail_macs(lat) + lat * lat) + lat * config["out_channels"]
    if is_ppsurf(config):
        field += (lat * lat - lat * config["out_channels"] + pointnet_query_macs(config)
                  + stn_head_macs(config["pointnet_latent_size"])
                  + 2 * lat * lat + lat * config["out_channels"])
    fwd = batch * encoder_chunk_macs(config, points) + batch * queries * field
    return 3 * 2.0 * fwd
