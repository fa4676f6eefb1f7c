"""The InterpAttention decoder tail (kernel K3).

Replaces the TPU kernel `_decoder_tail_kernel`
(`ppsurf_tpu/ops/decoder_pallas.py:49`, launched at `:113` by
`decoder_tail_pallas`, called from `ppsurf_tpu/recon/field.py:86-109`).
For each query it computes, over its k <= 64 neighbours (64 but for
clouds of fewer points),

    h = relu(x + rel @ W1)  ->  fc2+relu  ->  fc3+relu
    -> fc_query (64 heads), fc_value (L)
    -> softmax over k per head, mean over heads
    -> attention-weighted sum of the values (f32)    = (L,) pre-fc8

where x holds the neighbours' projected latents (fc1's latent rows and
bias folded in per shape, `FieldEvaluator`) and rel = query - neighbour.
It is built for two widths: L=256 (PPSurf) and L=32 (POCO, whose tail the
JAX package leaves to XLA, `ppsurf_tpu/recon/field.py:589-596`), 64 heads
each. The kernels take a query's rows as 64 neighbours; for k < 64 the
rows past k repeat neighbour 0, count as -inf logits in the per-head
softmax and get weight 0.

The CUDA kernel (`csrc/decoder_tail.cu`) takes the (N, L) latent table,
the cloud and the kNN ids and gathers inside: the (C*k, L) gathered tensor
(1.6 GB in bf16 at C=50 048) that the TPU path materialises never exists.

What bounds it on an H100: operations. One query is 27.4 MFLOP
(64 rows x (3*256 + 3*256^2 + 256*64) multiply-adds x 2), 1.37 TFLOP per
50 048-query chunk: 1.4 ms at the bf16 tensor-core peak of 989 TFLOP/s,
while its bytes (latent table, ids, output) move in well under 0.1 ms.

- bf16 (the reconstruction's dtype): one query's 64 neighbours are the 64
  rows of one `wgmma` tile. Persistent blocks (one per SM) run two
  queries at a time, one per consumer warpgroup; fc2, fc3, fc_query and
  fc_value are `wgmma` m64n128k16 / m64n64k16 products with f32
  accumulators in registers, the activations a swizzled bf16 operand in
  shared memory that each epilogue overwrites with the next layer's
  input. Each 256-wide product runs as two 128-column halves, and each
  half sums four 64-deep partial products on the CUDA cores in f32:
  tensor-core accumulation over all of K=256 (bf16 `torch.matmul`, the
  smoke's K3 control) reads about twice as far from the plain version's
  f32 products (PERF.md, Findings). A producer warp
  streams the 416 KB of weights, laid out once per table in the operand
  layout (`pack_wgmma_weights`), through a ring of four 16 KB slices with
  1-D bulk copies, so each slice serves both queries: about 208 KB of L2
  reads a query.
- f32 (`tf32::decoder_tail_tf32_kernel`): the bf16 kernel's shape with
  every product on the tensor cores as 3xTF32: each f32 operand x is
  split into tf32 hi = tf32(x) (round to nearest, ties away) and lo =
  tf32(x - hi), and a product is hi.hi + hi.lo + lo.hi, three `wgmma`
  m64n64k8 tf32 products into one f32 accumulator (about 2^-22 relative
  error a product, the order of an f32 rounding; one TF32 product, about
  2^-11, would miss the f32 limit the field is held to). Bound: 3 x 1.37
  TFLOP at the TF32 peak of 495 TFLOP/s, 8.3 ms a chunk (20.4 ms at the
  f32 FMA peak). The weights are split once per table
  (`pack_tf32x3_weights`, 1.66 MB in 104 slices of 16 KB, each the hi
  and lo tile of 64 output columns x 32 inputs) and streamed through a
  ring of three slices by the block's thread 0, which also computes (a
  producer warp would cut the registers to 168 a thread); two warpgroups
  a block, one query each. A query's f32 activations (64 KB) stay in
  shared memory; each product runs a column quarter at a time, splits its
  A fragments in registers two k8 steps at a time, and adds each K-chunk
  of 32 inputs as a fresh partial to the total in f32 on the CUDA cores;
  fc2 and fc3 write over their input (one quarter staged in the logits'
  space, three held in registers). Two queries share each slice: 832 KB
  of L2 reads a query, about 42 GB a chunk, which the L2 serves at the
  order of the operations' bound.
- L=32 (POCO): 64 rows x 5 216 multiply-adds a query, 33 GFLOP at
  C=50 048 (0.034 ms on the bf16 tensor cores, 0.5 ms at the f32 FMA
  peak); the gathered latents are 0.2 GB in bf16, most of them served by
  the L2. What bounds the bf16 build is the softmax: 4 096 exponentials
  and 4 096 divisions a query on the SFU (16 a clock an SM), about
  0.1 ms a chunk. bf16 (`decoder_tail_narrow_wgmma_kernel`): one warpgroup a
  query, its 64 rows one `wgmma` m64 tile; fc2, fc3, fc_value
  (m64n32k16) and fc_query (m64n64k16) take A from registers, each
  product's rounded output fragment the next one's operand, and the
  20 KB of weights (`pack_l32_weights`) stay in shared memory; h1 is made
  on the CUDA cores from the gathered rows, which cp.async copies a query
  ahead; the per-head softmax runs on the fc_query fragments, each
  exponential once. f32 (`decoder_tail_narrow_tf32_kernel`): the same
  body (the CUDA source templates it on the dtype) with every product as
  3xTF32: each value of a product's A fragment, the previous product's
  output fragment, is split into tf32 hi and lo in registers, and fc2,
  fc3, fc_value (m64n32k8) and fc_query (m64n64k8) each issue 12 `wgmma`
  tf32 products (four k8 steps x hi.lo, lo.hi, hi.hi) into one f32
  accumulator; the 40 KB of split weights (`pack_l32_tf32x3`, inputs in
  `TF32_K_ORDER`, so a thread's accumulator pairs are its next A
  fragment) stay in shared memory; the gathered rows are 8 KB a query.
  Bound: 3 x 33 GFLOP at the TF32 peak, 0.20 ms a chunk; the softmax's
  SFU floor is the bf16 build's.

Rounding follows the plain version below and `decoder_pallas.py:22-26,
38-46, 72-80`: every product accumulates in f32 and rounds to the compute
dtype at its output; bias, relu and the softmax steps (shift, exp, sum,
division, mean over heads) round to the compute dtype; the attention-
weighted sum accumulates in f32. In f32 the rounding to the compute dtype
is the identity.
"""
from __future__ import annotations

import dataclasses
import typing

import torch

from ppsurf_tpu_torch.models.norm import dense, softmax
from ppsurf_tpu_torch.ops import kernels
from ppsurf_tpu_torch.ops.wgmma_layout import (
    column_halves, tf32_slice, tf32_split, tf32_stream, weight_tile,
)


# (latent width, heads) of the builds; each runs on the tensor cores in
# bf16 and in f32 and needs `wpack`
SHAPES = ((256, 64), (32, 64))
WGMMA_SHAPE = (256, 64)
L32_SHAPE = (32, 64)
KMAX = 64  # neighbours a query


@dataclasses.dataclass
class DecoderTables:
    """Decoder-tail weights in the compute dtype (biases f32, rounded to
    it): w1 (3, L) rel rows of fc1; w* (in, out); `wpack`, w2, w3, wq and
    wv in the tensor-core kernel's operand layout: in bf16
    (`pack_wgmma_weights` at L=256, `pack_l32_weights` at L=32) and in
    f32 (`pack_tf32x3_weights` at L=256, `pack_l32_tf32x3` at L=32)."""

    dt: torch.dtype
    w1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    wq: torch.Tensor
    bq: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wpack: typing.Optional[torch.Tensor] = None

    @property
    def heads(self) -> int:
        return self.wq.shape[1]


def pack_wgmma_weights(w2: torch.Tensor, w3: torch.Tensor, wq: torch.Tensor,
                       wv: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's weight stream: 26 slices of 16 KB, in the order it
    multiplies, each a tile of `ops/wgmma_layout.py`. W2, W3 and Wv each
    give 8 slices, one (128 x 64) tile each, for output columns 0-127 then
    128-255, inputs 0-63 first; Wq gives 2 slices of two (64 x 64) tiles
    (inputs 0-127, 128-255)."""
    query = [torch.cat([weight_tile(wq, slice(None), 2 * s + t) for t in range(2)])
             for s in range(2)]
    return torch.cat(column_halves(w2) + column_halves(w3) + query
                     + column_halves(wv)).contiguous()


def pack_l32_weights(w2: torch.Tensor, w3: torch.Tensor, wq: torch.Tensor,
                     wv: torch.Tensor) -> torch.Tensor:
    """The latent-32 bf16 kernel's resident weights, 20 KB: W2, W3 (one
    (32 x 64) tile each), Wq (one (64 x 64) tile), Wv (one (32 x 64) tile),
    each a tile of `ops/wgmma_layout.py` whose K of 32 is padded with 32
    zero inputs; the kernel multiplies only the first 32."""
    def tile(w):
        padded = torch.cat([w, torch.zeros_like(w)])  # (64, out)
        return weight_tile(padded, slice(None), 0)

    return torch.cat([tile(w2), tile(w3), tile(wq), tile(wv)]).contiguous()


def pack_l32_tf32x3(w2: torch.Tensor, w3: torch.Tensor, wq: torch.Tensor,
                    wv: torch.Tensor) -> torch.Tensor:
    """The latent-32 f32 kernel's resident weights, 40 KB: for W2, W3 (32
    output columns), Wq (64) and Wv, in that order, the tf32 hi tile and
    then the lo tile of all its output columns x its 32 inputs, each group
    of 8 inputs in `TF32_K_ORDER` (`ops/wgmma_layout.py::tf32_slice`)."""
    return torch.cat([tf32_slice(*tf32_split(w), slice(None), 0)
                      for w in (w2, w3, wq, wv)]).contiguous()


def pack_tf32x3_weights(w2: torch.Tensor, w3: torch.Tensor, wq: torch.Tensor,
                        wv: torch.Tensor) -> torch.Tensor:
    """The f32 kernel's weight stream, 1.66 MB: 104 slices of 16 KB in the
    order it multiplies (`ops/wgmma_layout.py::tf32_stream`), each the tf32
    hi and lo tile of 64 output columns x 32 inputs: W2, W3 and Wv 32
    slices each (4 column quarters x 8 K-chunks), Wq 8."""
    return torch.cat(tf32_stream(w2) + tf32_stream(w3) + tf32_stream(wq)
                     + tf32_stream(wv)).contiguous()


@torch.no_grad()
def decoder_tables(projection, dt: torch.dtype) -> DecoderTables:
    """Tables from an `InterpAttentionKHeadsNet` (fc1 is (L+3, L))."""
    lat = projection.fc2.kernel.shape[0]

    def w(t):
        return t.detach().to(dt).contiguous()

    def b(t):
        return t.detach().to(dt).float().contiguous()

    t = DecoderTables(
        dt=dt, w1=w(projection.fc1.kernel[lat:]),
        w2=w(projection.fc2.kernel), b2=b(projection.fc2.bias),
        w3=w(projection.fc3.kernel), b3=b(projection.fc3.bias),
        wq=w(projection.fc_query.kernel), bq=b(projection.fc_query.bias),
        wv=w(projection.fc_value.kernel), bv=b(projection.fc_value.bias),
    )
    if dt == torch.bfloat16 and (lat, t.heads) == WGMMA_SHAPE:
        t.wpack = pack_wgmma_weights(t.w2, t.w3, t.wq, t.wv)
    elif dt == torch.bfloat16 and (lat, t.heads) == L32_SHAPE:
        t.wpack = pack_l32_weights(t.w2, t.w3, t.wq, t.wv)
    elif dt == torch.float32 and (lat, t.heads) == WGMMA_SHAPE:
        t.wpack = pack_tf32x3_weights(t.w2, t.w3, t.wq, t.wv)
    elif dt == torch.float32 and (lat, t.heads) == L32_SHAPE:
        t.wpack = pack_l32_tf32x3(t.w2, t.w3, t.wq, t.wv)
    return t


def decoder_tail_plain(latents: torch.Tensor, pts: torch.Tensor,
                       queries: torch.Tensor, ids: torch.Tensor,
                       t: DecoderTables) -> torch.Tensor:
    """Plain PyTorch version of K3, with the explicit gather."""
    dt = t.dt
    x = latents[ids]  # (C, k, L)
    rel = (queries[:, None, :] - pts[ids]).to(dt)
    relw = torch.matmul(rel.float(), t.w1.float()).to(dt)
    h = torch.relu((x.float() + relw.float()).to(dt))
    h = torch.relu(dense(h, t.w2, t.b2, dt))
    h = torch.relu(dense(h, t.w3, t.b3, dt))
    qv = dense(h, t.wq, t.bq, dt)  # (C, k, H)
    vv = dense(h, t.wv, t.bv, dt)  # (C, k, L)
    att = softmax(qv, 1, dt).mean(dim=-1).to(dt).float()  # (C, k)
    return (att[..., None] * vv.float()).sum(dim=1).to(dt)


def _check(t: DecoderTables, lat: int, k: int) -> None:
    """Raise unless the kernel is built for these tables and k, and the
    tables carry their weight pack on the card (every build runs on the
    tensor cores)."""
    if not 1 <= k <= KMAX or (lat, t.heads) not in SHAPES:
        raise ValueError(
            f"decoder_tail kernel is built for 1 <= k <= {KMAX} and (L, heads) in "
            f"{SHAPES}; got k={k}, L={lat}, heads={t.heads}"
        )
    if t.wpack is None or not t.wpack.is_cuda:
        raise ValueError("decoder_tail: the tables need `wpack` on the card "
                         "(made by decoder_tables)")


def decoder_tail(latents: torch.Tensor, pts: torch.Tensor, queries: torch.Tensor,
                 ids: torch.Tensor, t: DecoderTables) -> torch.Tensor:
    """latents (N, L) projected, compute dtype; pts (N, 3) f32; queries
    (C, 3) f32; ids (C, k) int64, 1 <= k <= 64 -> (C, L) attention-pooled
    features.

    CPU tensors take the plain version; CUDA tensors launch K3."""
    if latents.device.type == "cpu":
        return decoder_tail_plain(latents, pts, queries, ids, t)
    c, k = ids.shape
    lat = latents.shape[1]
    kernels.check_cuda_args(
        "decoder_tail",
        {"latents": latents, "pts": pts, "queries": queries, "ids": ids,
         "w1": t.w1, "w2": t.w2, "b2": t.b2, "w3": t.w3, "b3": t.b3,
         "wq": t.wq, "bq": t.bq, "wv": t.wv, "bv": t.bv},
        {"latents": t.dt, "pts": torch.float32, "queries": torch.float32,
         "ids": torch.int64, "w1": t.dt, "w2": t.dt, "w3": t.dt, "wq": t.dt,
         "wv": t.dt, "b2": torch.float32, "b3": torch.float32,
         "bq": torch.float32, "bv": torch.float32},
    )
    _check(t, lat, k)
    out = torch.empty((c, lat), dtype=t.dt, device=latents.device)
    if c:
        kernels.launch(
            "decoder_tail" if lat == 256 else "decoder_tail_l32", "ppsurf_decoder_tail",
            latents.device,
            *(kernels.ptr(a) for a in (
                latents, pts, queries, ids, t.w1, t.w2, t.b2, t.w3, t.b3,
                t.wq, t.bq, t.wv, t.bv, t.wpack, out)),
            c, k, lat, t.heads, kernels.dtype_code(t.dt),
        )
    return out
