"""The PPSurf PointNet branch: kernels K4 (trunk) and K5 (head).

Replaces the TPU kernels `_trunk_kernel` and `_head_kernel`
(`ppsurf_tpu/ops/pointnet_pallas.py:56` and `:72`, launched at `:180` and
`:237` by `pointnet_att_pallas`, called from
`ppsurf_tpu/recon/field.py:123-133`). The branch is
PointNetfeat(use_point_stn=False, use_feat_stn=True, sym_op='att'):

    K4:  conv0a 3->64, conv0b 64->64 (dense + eval BN + relu)    -> b
         STN trunk conv1 64, conv2 128, conv3 256 (+BN+relu), max -> pooled
    STN head (plain PyTorch): fc1 128, fc2 64 (+BN+relu), fc3 4096 + I
         -> (C, 64, 64) transform, applied to b                  -> x2
    K5:  conv1 64, conv2 128 (+BN+relu), conv3 256 (+BN), then attention
         pooling over the P points: softmax of a scalar fc_query logit,
         weighted sum of fc_value (256) in f32                   -> (C, 256)

Eval BatchNorm is folded into (g, c) rows, and a dense output is rounded
to the compute dtype BEFORE the f32 affine, as in
`pointnet_pallas.py:25-29, 41-53`.

The CUDA kernels (`csrc/pointnet.cu`) take a patch of P <= 256 points as
ceil(P/64) tiles of 64 rows, each the 64 rows of every product: a tile's
rows past P repeat its first point, which leaves the max unchanged and is
masked out of the softmax (the TPU's padding of P to 56, a Mosaic tiling
constraint, and its `p_real` mask, `pointnet_pallas.py:90-95`, become
this). P=50 is one tile; the 100NN and 200NN configurations take two and
four. K4 takes its max across the tiles. K5 must round as the plain
version does: the max and the sum of the softmax come over all P rows
before any weight exists (an online softmax, rescaling a running sum tile
by tile, would round differently in bf16). For P > 64 the bf16 K5
(`head_cluster_kernel`) runs a patch's T = ceil(P/64) tiles side by side
on the T CTAs of a thread-block cluster: each CTA computes conv1-conv3
and the logits of its tile once, stores the logits into every CTA's
shared memory (distributed shared memory), and after a cluster barrier
each takes the max and the sum over all P rows in the same order, weights
its own tile's values (its conv3 output never left its shared memory) and
sends its column sums to the leader, which adds them in tile order. One
producer thread multicasts each weight slice to all T CTAs, so one L2
read serves 2T tiles: 216 KB a round of two patches, as for one tile.
The cluster is launched with a runtime size (`cudaLaunchKernelEx`) and
the grid holds as many clusters as `cudaOccupancyMaxActiveClusters` says
fit (30 of 4 CTAs on the H100, PERF.md). For one tile the bf16 K5 keeps
its own kernel, which holds the softmax in registers. The f32 K5
(`tf32::head_tf32_kernel`) runs every P in 1..256 on clusters of ceil(P/64)
CTAs the same way (one CTA for P <= 64), so no tile's conv1-conv3 runs
twice.

What bounds them on an H100: operations. Per patch K4 is about 4.9 MFLOP
and K5 about 11.1 MFLOP, 0.25 and 0.56 TFLOP per 50 048-query chunk —
0.25 ms and 0.56 ms at the bf16 tensor-core peak of 989 TFLOP/s, while
their bytes (patches, b, x2 and the outputs, 13 MB to 0.4 GB) take at
most 0.13 ms. The 64-row tiles do 28% more work than the 50 real rows.

- bf16 (the reconstruction's dtype): one patch is one `wgmma` m64 tile,
  and each consumer warpgroup owns whole patches, so a patch's max and
  softmax never leave it. Every product but conv0a (K=3, CUDA cores) is a
  `wgmma` m64n64k16 / m64n128k16 product with f32 accumulators in
  registers, one 64-deep K-tile at a time, the partials added in f32 on
  the CUDA cores as in K3 (`ops/decoder_tail.py`); each epilogue rounds,
  adds the bias, applies BN and relu as the plain version does and writes
  the next layer's swizzled bf16 operand to shared memory. Persistent
  blocks, one per SM. K4 keeps its 96 KB of weights (`trunk_pack`)
  resident in shared memory and runs three warpgroups, each through its
  own patches; b is copied out after conv0b, and stn conv3's output only
  feeds the max, taken from the accumulator fragments. K5's weights are
  216 KB (`head_pack`) and do not fit beside the activations: a producer
  warpgroup streams them through a ring of four 16 KB slices with 1-D bulk
  copies and mbarriers to two consumer warpgroups, one patch each, and
  gives them its registers (`setmaxnreg`, 232 a consumer thread), so the
  f32 accumulators never spill. A slice serves two patches: a patch costs
  108 KB of L2 reads, 5.4 GB per 50 048-patch call. fc_query (256 -> 1) is
  a dot product on the CUDA cores in conv3's epilogue; fc_value's
  epilogue weights each rounded value by its row's softmax weight and
  sums over the rows in f32 from the fragments, so its (64, 256) output
  is never stored. PERF.md (Findings) records the designs that were
  measured and dropped.
- f32 K5: every product but fc_query on the tensor cores as 3xTF32: each
  f32 operand x is split into tf32 hi = tf32(x) (round to nearest, ties
  away) and lo = tf32(x - hi), and a product is hi.hi + hi.lo + lo.hi,
  three `wgmma` m64n64k8 tf32 products into one f32 accumulator (about
  2^-22 relative error a product, the order of an f32 rounding; one TF32
  product, about 2^-11, would miss the f32 limit the field is held to).
  Bound at P=50: 3 x 0.55 TFLOP at the TF32 peak of 495 TFLOP/s, 3.4 ms
  a chunk (8.3 ms at the f32 FMA peak). The weights are split once per
  table (`pack_head_tf32x3`, 864 KB in 54 slices of 16 KB, the hi and lo
  tile of 64 output columns x 32 inputs) and each CTA's thread 0
  streams them through a ring of four slices for its two warpgroups, one
  tile each: 432 KB of L2 reads a tile. A tile's f32 activations (64 KB)
  stay in shared memory, each layer's output written over its input;
  each product splits its A fragments in registers one K-chunk of 32
  inputs at a time, each chunk a fresh partial added in f32 on the CUDA
  cores. fc_query is a dot product on the CUDA cores in conv3's
  epilogue; the softmax and the weighted sum are the cluster K5's.
- f32 K4: every product but conv0a (K=3, CUDA cores) as 3xTF32, as the
  f32 K5. Bound at P=50: 3 x 0.25 TFLOP at the TF32 peak, 1.5 ms a chunk
  (3.7 ms at the f32 FMA peak). Persistent blocks of three warpgroups, one
  patch each, its tiles one after the other (a max needs no cluster);
  each block's thread 0 streams the 384 KB of split weights
  (`pack_trunk_tf32x3`, 24 slices) through a ring of four, so a slice
  serves three tiles: 128 KB of L2 reads a tile. conv0b, stn conv1 and
  stn conv2 write their output over their input in shared memory (32 KB
  a warpgroup: stn conv3's output is never stored, its max over the rows
  taken from the fragments and over the tiles in shared memory).

In f32 the rounding to the compute dtype is the identity.
"""
from __future__ import annotations

import dataclasses
import typing

import torch

from ppsurf_tpu_torch.models.norm import dense, softmax
from ppsurf_tpu_torch.ops import kernels
from ppsurf_tpu_torch.ops.wgmma_layout import column_halves, tf32_stream, weight_tile

WIDTH = 256  # row width of the affine tables (widest layer)
PMAX = 256  # the most points a patch the kernels take (four 64-row tiles)
# (in, out) of conv0a, conv0b, stn conv1..3, then conv1..3, fc_query and
# fc_value: the PPSurf widths the kernels are built for
KERNEL_SHAPES = [(3, 64), (64, 64), (64, 64), (64, 128), (128, WIDTH),
                 (64, 64), (64, 128), (128, WIDTH), (WIDTH, 1), (WIDTH, WIDTH)]
# the order of the column quarters of conv1, conv2, conv3 and fc_value in
# the f32 K5's weight stream (`csrc/pointnet.cu`, `namespace tf32`)
HEAD_QUARTERS = ((0,), (1, 0), (2, 3, 0, 1), (0, 1, 2, 3))
# and of conv0b, stn conv1, stn conv2 and stn conv3 in the f32 K4's
TRUNK_QUARTERS = ((0,), (0,), (1, 0), (0, 1, 2, 3))


@dataclasses.dataclass
class PointNetTables:
    """Weights of the branch in the compute dtype; `*_aff` hold, per
    layer, three f32 rows (dense bias rounded to dt, BN g, BN c); at the
    PPSurf widths also the weights of the tensor-core kernels in their
    operand layout, `trunk_pack` and `head_pack`: in bf16
    (`pack_trunk_weights`, `pack_head_weights`) and in f32
    (`pack_trunk_tf32x3`, `pack_head_tf32x3`)."""

    dt: torch.dtype
    trunk_w: typing.Tuple[torch.Tensor, ...]  # conv0a, conv0b, stn conv1..3
    trunk_aff: torch.Tensor  # (15, WIDTH)
    stn: typing.Dict[str, torch.Tensor]  # STN head, plain PyTorch
    head_w: typing.Tuple[torch.Tensor, ...]  # conv1..3, fc_query, fc_value
    head_aff: torch.Tensor  # (9, WIDTH)
    bqv: torch.Tensor  # (2, WIDTH): fc_query bias, fc_value bias
    trunk_pack: typing.Optional[torch.Tensor] = None
    head_pack: typing.Optional[torch.Tensor] = None


def pack_trunk_weights(w0b: torch.Tensor, ws1: torch.Tensor, ws2: torch.Tensor,
                       ws3: torch.Tensor) -> torch.Tensor:
    """K4's 96 KB of resident weights, tiles of `ops/wgmma_layout.py`:
    conv0b and stn conv1 (one (64 x 64) tile each), stn conv2 (one
    (128 x 64) tile), then stn conv3's four (128 x 64) tiles, columns
    0-127 over inputs 0-63 and 64-127, then columns 128-255."""
    return torch.cat([weight_tile(w0b, slice(None), 0), weight_tile(ws1, slice(None), 0),
                      weight_tile(ws2, slice(None), 0), *column_halves(ws3)]).contiguous()


def pack_head_weights(wc1: torch.Tensor, wc2: torch.Tensor, wc3: torch.Tensor,
                      wv: torch.Tensor) -> torch.Tensor:
    """K5's weight stream, 216 KB: 14 slices in the order it multiplies,
    conv1 (one (64 x 64) tile, 8 KB), conv2 (one (128 x 64) tile), conv3
    (four (128 x 64) tiles: columns 0-127 over inputs 0-63 and 64-127,
    then columns 128-255), fc_value (eight, likewise over four K-tiles);
    16 KB each but the first."""
    return torch.cat([weight_tile(wc1, slice(None), 0), weight_tile(wc2, slice(None), 0),
                      *column_halves(wc3), *column_halves(wv)]).contiguous()


def pack_head_tf32x3(wc1: torch.Tensor, wc2: torch.Tensor, wc3: torch.Tensor,
                     wv: torch.Tensor) -> torch.Tensor:
    """The f32 K5's weight stream, 864 KB: 54 slices of 16 KB in the order
    it multiplies (`ops/wgmma_layout.py::tf32_stream`), each the tf32 hi
    and lo tile of 64 output columns x 32 inputs: conv1 2, conv2 4, conv3
    16, fc_value 32. A layer writes its output over its input, so the
    column quarters beyond its input width come first (`HEAD_QUARTERS`)."""
    return torch.cat([s for w, quarters in zip((wc1, wc2, wc3, wv), HEAD_QUARTERS)
                      for s in tf32_stream(w, quarters)]).contiguous()


def pack_trunk_tf32x3(w0b: torch.Tensor, ws1: torch.Tensor, ws2: torch.Tensor,
                      ws3: torch.Tensor) -> torch.Tensor:
    """The f32 K4's weight stream, 384 KB: 24 slices of 16 KB in the order
    it multiplies (`ops/wgmma_layout.py::tf32_stream`), each the tf32 hi
    and lo tile of 64 output columns x 32 inputs: conv0b 2, stn conv1 2,
    stn conv2 4, stn conv3 16. A layer writes its output over its input, so
    stn conv2's quarter beyond its input width comes first
    (`TRUNK_QUARTERS`); stn conv3's output is never stored."""
    return torch.cat([s for w, quarters in zip((w0b, ws1, ws2, ws3), TRUNK_QUARTERS)
                      for s in tf32_stream(w, quarters)]).contiguous()


def _aff(pairs) -> torch.Tensor:
    rows = []
    for layer, bn in pairs:
        g, c = bn.folded()
        for vec in (layer.bias.detach().to(layer.dtype).float(), g, c):
            row = torch.zeros(WIDTH, device=vec.device)
            row[: vec.shape[0]] = vec
            rows.append(row)
    return torch.stack(rows).contiguous()


@torch.no_grad()
def pointnet_tables(point_net) -> PointNetTables:
    """Tables from a `models.pointnet.PointNetfeat`."""
    pn, stn, att = point_net, point_net.stn2, point_net.att
    dt = pn.dtype

    def w(layer):
        return layer.kernel.detach().to(dt).contiguous()

    stn_tab = {"eye": torch.eye(64, device=stn.fc3.kernel.device).reshape(-1)}
    for name, layer, bn in (("fc1", stn.fc1, stn.bn4), ("fc2", stn.fc2, stn.bn5),
                            ("fc3", stn.fc3, None)):
        stn_tab[f"{name}_w"] = w(layer)
        stn_tab[f"{name}_b"] = layer.bias.detach().to(dt).float()
        if bn is not None:
            stn_tab[f"{name}_g"], stn_tab[f"{name}_c"] = bn.folded()
    bqv = torch.zeros(2, WIDTH, device=pn.conv1.kernel.device)
    bqv[0, :1] = att.fc_query.bias.detach().to(dt).float()
    bqv[1, : att.fc_value.bias.shape[0]] = att.fc_value.bias.detach().to(dt).float()
    t = PointNetTables(
        dt=dt,
        trunk_w=(w(pn.conv0a), w(pn.conv0b), w(stn.conv1), w(stn.conv2),
                 w(stn.conv3)),
        trunk_aff=_aff([(pn.conv0a, pn.bn0a), (pn.conv0b, pn.bn0b),
                        (stn.conv1, stn.bn1), (stn.conv2, stn.bn2),
                        (stn.conv3, stn.bn3)]),
        stn=stn_tab,
        head_w=(w(pn.conv1), w(pn.conv2), w(pn.conv3), w(att.fc_query),
                w(att.fc_value)),
        head_aff=_aff([(pn.conv1, pn.bn1), (pn.conv2, pn.bn2),
                       (pn.conv3, pn.bn3)]),
        bqv=bqv.contiguous(),
    )
    if dt == torch.bfloat16 and _shapes(t) == KERNEL_SHAPES:
        t.trunk_pack = pack_trunk_weights(*t.trunk_w[1:])
        t.head_pack = pack_head_weights(*t.head_w[:3], t.head_w[4])
    elif dt == torch.float32 and _shapes(t) == KERNEL_SHAPES:
        t.trunk_pack = pack_trunk_tf32x3(*t.trunk_w[1:])
        t.head_pack = pack_head_tf32x3(*t.head_w[:3], t.head_w[4])
    return t


def _dense_bn(x, w, aff, layer: int, dt, relu: bool = True):
    """Dense -> eval BN (-> relu), rounding as the kernels do."""
    n = w.shape[1]
    y = dense(x, w, aff[3 * layer, :n], dt)
    y = (y.float() * aff[3 * layer + 1, :n] + aff[3 * layer + 2, :n]).to(dt)
    return torch.relu(y) if relu else y


def pointnet_trunk_plain(patches: torch.Tensor, t: PointNetTables):
    """Plain PyTorch version of K4: (C, P, 3) -> b (C, P, 64), pooled (C, 256)."""
    x = patches.to(t.dt)
    for layer in range(2):
        x = _dense_bn(x, t.trunk_w[layer], t.trunk_aff, layer, t.dt)
    b = x
    for layer in range(2, 5):
        x = _dense_bn(x, t.trunk_w[layer], t.trunk_aff, layer, t.dt)
    return b, x.amax(dim=1)


def attention_pool_plain(logit: torch.Tensor, value: torch.Tensor,
                         dt: torch.dtype) -> torch.Tensor:
    """K5's pooling: softmax of the (C, P, 1) logits over the P points,
    the (C, P, N) values weighted by it and summed in f32 -> (C, N)."""
    att = softmax(logit, 1, dt)
    return (att * value.float()).sum(dim=1).to(dt)


def pointnet_head_plain(x2: torch.Tensor, t: PointNetTables) -> torch.Tensor:
    """Plain PyTorch version of K5: (C, P, 64) -> (C, 256)."""
    x = x2
    for layer in range(3):
        x = _dense_bn(x, t.head_w[layer], t.head_aff, layer, t.dt, relu=layer < 2)
    wq, wv = t.head_w[3], t.head_w[4]
    logit = dense(x, wq, t.bqv[0, :1], t.dt)  # (C, P, 1)
    value = dense(x, wv, t.bqv[1, : wv.shape[1]], t.dt)  # (C, P, 256)
    return attention_pool_plain(logit, value, t.dt)


def pad_rows(x: torch.Tensor, rows: typing.Optional[int]) -> torch.Tensor:
    """x with zero rows appended up to `rows` (x itself where None)."""
    if rows is None or rows == x.shape[0]:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])


def stn_apply(pooled: torch.Tensor, b: torch.Tensor, t: PointNetTables,
              rows: typing.Optional[int] = None) -> torch.Tensor:
    """STN head -> (C, 64, 64) transform, applied to b (C, P, 64) -> x2.

    Plain matmuls, as the JAX package leaves this stage to XLA
    (`pointnet_pallas.py:207-219`). rows (>= C), where given: the head's
    three products run on that many rows, `pooled` padded with zeros.
    cuBLAS picks its algorithm by the row count, and some of its
    algorithms split the sum, so at a fixed count a patch's transform
    does not depend on how many patches share the call (the batched
    product that applies it does not vary so on the card)."""
    dt, s = t.dt, t.stn
    h = pad_rows(pooled, rows)
    for name in ("fc1", "fc2"):
        h = dense(h, s[f"{name}_w"], s[f"{name}_b"], dt)
        h = torch.relu((h.float() * s[f"{name}_g"] + s[f"{name}_c"]).to(dt))
    tm = dense(h, s["fc3_w"], s["fc3_b"], dt)[:pooled.shape[0]]
    trans = (tm.float() + s["eye"]).to(dt).reshape(-1, 64, 64)
    return torch.matmul(b.float(), trans.float().transpose(1, 2)).to(dt)


def pointnet_trunk(patches: torch.Tensor, t: PointNetTables):
    """K4 wrapper. CPU tensors take the plain version."""
    if patches.device.type == "cpu":
        return pointnet_trunk_plain(patches, t)
    c, p, _ = patches.shape
    patches = patches.to(t.dt).contiguous()
    _check(t, p, "pointnet_trunk", {"patches": patches}, t.trunk_pack)
    b = torch.empty((c, p, 64), dtype=t.dt, device=patches.device)
    pooled = torch.empty((c, WIDTH), dtype=t.dt, device=patches.device)
    if c:
        kernels.launch(
            "pointnet_trunk" if p <= 64 else "pointnet_trunk_wide", "ppsurf_pointnet_trunk",
            patches.device,
            *(kernels.ptr(a) for a in (patches, *t.trunk_w, t.trunk_aff, t.trunk_pack,
                                       b, pooled)),
            c, p, kernels.dtype_code(t.dt),
        )
    return b, pooled


def pointnet_head(x2: torch.Tensor, t: PointNetTables) -> torch.Tensor:
    """K5 wrapper. CPU tensors take the plain version."""
    if x2.device.type == "cpu":
        return pointnet_head_plain(x2, t)
    c, p, _ = x2.shape
    x2 = x2.contiguous()
    _check(t, p, "pointnet_head", {"x2": x2}, t.head_pack)
    out = torch.empty((c, WIDTH), dtype=t.dt, device=x2.device)
    if c:
        kernels.launch(
            "pointnet_head" if p <= 64 else "pointnet_head_wide", "ppsurf_pointnet_head",
            x2.device,
            *(kernels.ptr(a) for a in (x2, *t.head_w, t.head_aff, t.bqv, t.head_pack,
                                       out)),
            c, p, kernels.dtype_code(t.dt),
        )
    return out


def _shapes(t: PointNetTables):
    return [tuple(w.shape) for w in t.trunk_w + t.head_w]


def _check(t: PointNetTables, p: int, name: str, data: typing.Dict[str, torch.Tensor],
           pack: typing.Optional[torch.Tensor]):
    """Raise unless the kernel is built for these tables and P, and the
    tables carry the kernel's weight pack (every build runs on the tensor
    cores) on the card."""
    if _shapes(t) != KERNEL_SHAPES or not 1 <= p <= PMAX:
        raise ValueError(
            f"{name} kernel is built for the PPSurf widths (latent 256) and "
            f"P <= {PMAX}; got P={p}, weights {_shapes(t)}"
        )
    tensors = dict(data)
    tensors.update({f"w{i}": w for i, w in enumerate(t.trunk_w + t.head_w)})
    tensors.update(trunk_aff=t.trunk_aff, head_aff=t.head_aff, bqv=t.bqv)
    dtypes = {k: t.dt for k in tensors if k not in ("trunk_aff", "head_aff", "bqv")}
    dtypes.update(trunk_aff=torch.float32, head_aff=torch.float32, bqv=torch.float32)
    if pack is None:
        raise ValueError(f"{name}: the tables need their weight pack "
                         "(made by pointnet_tables)")
    tensors["pack"] = pack
    kernels.check_cuda_args(name, tensors, dtypes)


def pointnet_att(patches: torch.Tensor, t: PointNetTables,
                 rows: typing.Optional[int] = None) -> torch.Tensor:
    """(C, P, 3) patch-space points -> (C, 256) features: K4, STN, K5;
    `rows` as `stn_apply`'s."""
    b, pooled = pointnet_trunk(patches, t)
    return pointnet_head(stn_apply(pooled, b, t, rows), t)
