// K4 and K5: the PPSurf PointNet branch around its STN head.
//
// K4 replaces `_trunk_kernel` (ppsurf_tpu/ops/pointnet_pallas.py:56):
//   conv0a (3->64), conv0b (64->64), each dense + eval BN + relu -> b,
//   then the STN trunk conv1 64 / conv2 128 / conv3 256 (+BN+relu) and the
//   max over the patch points -> pooled.
// K5 replaces `_head_kernel` (ppsurf_tpu/ops/pointnet_pallas.py:72):
//   conv1 64 / conv2 128 (+BN+relu), conv3 256 (+BN), then attention
//   pooling: a scalar fc_query logit per point, softmax over the P real
//   points, fc_value (256) and the weighted sum in f32.
// Design and bounds: see ppsurf_tpu_torch/ops/pointnet_att.py. A patch of
// P <= 256 points is ceil(P / 64) tiles of 64 rows, each tile the 64 rows
// of every product; a tile's rows past P repeat the tile's first point:
// they never change a max and are masked out of the softmax. K4 takes its
// max across the tiles. K5 has a kernel for one tile (P <= 64) and, in
// bf16, one for several (`head_cluster_kernel`), which rounds as the plain
// version does: the tiles of a patch run on the CTAs of a thread-block
// cluster, each tile's logits meet through distributed shared memory
// before the max, the exp, the sum and the division, and each CTA weights
// the values of its own tile, whose conv3 output never left its shared
// memory. The f32 K5 runs every P on such clusters.
//
// bf16 (`trunk_wgmma_kernel`, `head_wgmma_kernel`): one patch is one
// `wgmma` m64 tile, and each consumer warpgroup owns whole patches, so the
// max and the softmax over a patch's rows stay inside it. Every product
// but conv0a (K=3, on the CUDA cores) runs on the tensor cores, one
// 64-deep K-tile at a time with the partials added in f32; each epilogue
// rounds where the plain version rounds and writes the next product's
// swizzled bf16 operand to shared memory; rounding takes column pairs, one
// conversion each. Persistent blocks, one per SM:
//   K4 keeps its 96 KB of weights resident (loaded once per block with
//      bulk copies); three warpgroups work through patches independently;
//      stn conv3's output only feeds the max, taken from the accumulator
//      fragments.
//   K5 (one tile) streams its 216 KB of weights through a ring of four 16 KB slices:
//      a producer warpgroup (one thread copies; the warpgroup gives its
//      registers to the others with setmaxnreg, so no accumulator spills)
//      and two consumer warpgroups, one patch each, so a slice serves two
//      patches. fc_query is a dot product on the CUDA cores in conv3's
//      epilogue; fc_value's epilogue weights each rounded value by the
//      softmax and sums the rows in f32 from the fragments.
//
// f32 (`tf32::trunk_tf32_kernel`, `tf32::head_tf32_kernel`): the same
// products as 3xTF32 on the tensor cores (`wgmma` on tf32 hi and lo
// operands, `gmma.cuh`), which keeps f32 accuracy where one TF32 product
// would miss the f32 limit (1e-4 x scale) that the f32 field is held to.
// See `namespace tf32` below.
#include "common.cuh"
#include "gmma.cuh"

namespace {

using ppsurf::rnd;

constexpr int W = 256;  // widest layer = activation row stride = aff width
constexpr int PMAX = 256;  // the most points a patch the kernels take (four 64-row tiles)

// ---- bf16 on the tensor cores ----
namespace gm = ppsurf::gmma;
using bf16 = __nv_bfloat16;

constexpr int WG_THREADS = 128;
constexpr int TILE = 8192;  // bytes of one swizzled (64 x 64) bf16 operand tile
constexpr unsigned FULL = 0xffffffffu;

// K4: weights w0b, ws1 (one tile each), ws2 (128 x 64: two tiles) and ws3
// (column half h, K-tile k at slot 2h + k, two tiles each), in that order
constexpr int TRUNK_PACK = 12 * TILE;
constexpr int TRUNK_WGS = 3;         // warpgroups, one patch each at a time
constexpr int TRUNK_ACT = 3 * TILE;  // a warpgroup's operands: a (1 tile), b (2)
constexpr size_t TRUNK_SMEM = 1024  // alignment slack
    + TRUNK_PACK + TRUNK_WGS * (TRUNK_ACT + 4 * W * sizeof(float)) + sizeof(uint64_t);

// K5: 14 weight slices in the order they are multiplied: conv1 (64 x 64,
// 8 KB), conv2 (128 x 64), conv3 (half h, K-tile k: slice 2 + 2h + k),
// fc_value (half h, K-tile k: slice 6 + 4h + k); 16 KB each but the first
constexpr int STAGES = 4;
constexpr int SLICE = 2 * TILE;
constexpr int HEAD_SLICES = 14;
constexpr int HEAD_WGS = 2;          // consumer warpgroups, one patch each
constexpr int HEAD_THREADS = (HEAD_WGS + 1) * WG_THREADS;  // + producer warpgroup
// registers a thread: the producer gives up all but 40 so that each
// consumer thread can hold 232 (two 64-float accumulators and more)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(PRODUCER_REGS * WG_THREADS + CONSUMER_REGS * HEAD_WGS * WG_THREADS <= 65536,
              "the register file of an SM");
constexpr int HEAD_ACT = 6 * TILE;   // a warpgroup's operands: x (2 tiles), y (4)
constexpr int HEAD_FLOATS = 64 + 4 * W;  // logits, per-warp column sums
constexpr size_t head_smem_bytes(int floats) {
  return 1024  // alignment slack
         + STAGES * SLICE + HEAD_WGS * (HEAD_ACT + floats * sizeof(float)) +
         2 * STAGES * sizeof(uint64_t);
}

using Ring = gm::Ring<STAGES, SLICE>;

// a pair of values rounded to bf16 with one conversion
__device__ __forceinline__ float2 rnd2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

__device__ __forceinline__ float2 ld2(const float* __restrict__ p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 ld2(const bf16* __restrict__ p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// dense + eval BN (`pointnet_pallas.py:41-53`) of the accumulators of
// columns col, col + 1 (col even): the product rounds to bf16, then its
// sum with the bias; the f32 affine (unfused, as the plain version
// computes it) rounds again. `aff` holds the layer's three rows.
__device__ __forceinline__ float2 bn_out(float acc0, float acc1, const float* __restrict__ aff,
                                         int col) {
  const float2 b = ld2(aff + col), g = ld2(aff + W + col), c = ld2(aff + 2 * W + col);
  float2 y = rnd2(acc0, acc1);
  y = rnd2(y.x + b.x, y.y + b.y);
  return rnd2(__fadd_rn(__fmul_rn(y.x, g.x), c.x), __fadd_rn(__fmul_rn(y.y, g.y), c.y));
}

// fc_value's dense epilogue of columns col, col + 1: the product rounds
// to bf16, then its sum with the bias
__device__ __forceinline__ float2 value_out(float acc0, float acc1, float2 b) {
  const float2 v = rnd2(acc0, acc1);
  return rnd2(v.x + b.x, v.y + b.y);
}

__device__ __forceinline__ float2 relu2(float2 y) {
  return make_float2(fmaxf(y.x, 0.f), fmaxf(y.y, 0.f));
}

// relu(bn_out(acc)) of a (64 x N) accumulator into columns col0.. of the
// swizzled 64-row operand at dst; r0, cl: this thread's fragment row and
// column offset (`gmma.cuh`)
template <int N>
__device__ __forceinline__ void store_bn_relu(const float (&acc)[N / 2],
                                              const float* __restrict__ aff,
                                              unsigned char* dst, int col0, int r0, int cl) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col0 + 8 * j + cl;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 y = relu2(bn_out(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], aff, col));
      *reinterpret_cast<__nv_bfloat162*>(dst + gm::swizzle_offset(r0 + 8 * h, col, 64)) =
          __float22bfloat162_rn(y);
    }
  }
}

// `op` of a pair of column values over the 8 lanes that hold the same
// columns (lane bits 2-4), by shuffles
template <typename Op>
__device__ __forceinline__ float2 lane_reduce(float2 v, Op op) {
#pragma unroll
  for (int off = 4; off <= 16; off <<= 1) {
    v.x = op(v.x, __shfl_xor_sync(FULL, v.x, off));
    v.y = op(v.y, __shfl_xor_sync(FULL, v.y, off));
  }
  return v;
}

__global__ void __launch_bounds__(TRUNK_WGS * WG_THREADS, 1)
trunk_wgmma_kernel(const bf16* __restrict__ patches, const bf16* __restrict__ w0a,
                   const float* __restrict__ aff, const unsigned char* __restrict__ pack,
                   bf16* __restrict__ b_out, bf16* __restrict__ pooled, int c, int p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wts = gm::align1024(smem_raw);
  unsigned char* acts = wts + TRUNK_PACK;
  float* floats = reinterpret_cast<float*>(acts + TRUNK_WGS * TRUNK_ACT);
  uint64_t* bar = reinterpret_cast<uint64_t*>(floats + TRUNK_WGS * 4 * W);
  if (threadIdx.x == 0) {
    gm::mbar_init(bar, 1);
    gm::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    gm::mbar_arrive_expect_tx(bar, TRUNK_PACK);
    for (int i = 0; i < TRUNK_PACK / SLICE; ++i)
      gm::bulk_copy_g2s(wts + i * SLICE, pack + i * SLICE, SLICE, bar);
  }

  // warpgroup `wg`: thread t, warp w, lane l; its patches are wg, wg +
  // TRUNK_WGS, ... of this block's share
  const int wg = threadIdx.x / WG_THREADS;
  const int t = threadIdx.x % WG_THREADS;
  const int w = t >> 5;
  const int l = t & 31;
  unsigned char* act_a = acts + wg * TRUNK_ACT;
  unsigned char* act_b = act_a + TILE;
  const uint32_t a_addr = gm::smem_u32(act_a);
  const uint32_t b_addr = gm::smem_u32(act_b);
  const uint32_t w_addr = gm::smem_u32(wts);
  float* colmax = floats + wg * 4 * W;  // per-warp column maxima
  auto sync = [wg] { gm::named_barrier(1 + wg, WG_THREADS); };
  const int r0 = 16 * w + (l >> 2);  // accumulator rows r0 and r0 + 8
  const int cl = 2 * (l & 3);        // accumulator column offset in an n8 block
  const int r = t >> 1;              // conv0a: thread t computes 32 columns of row t / 2
  const int step = gridDim.x * TRUNK_WGS;
  const int tiles = (p + 63) / 64;

  // row r's point of tile `tile` of this warpgroup's next patch, loaded a
  // tile ahead; rows past p repeat the tile's first point
  int patch = blockIdx.x * TRUNK_WGS + wg;
  bf16 next[3];
  auto load_point = [&](int at, int tile) {
    const int row = 64 * tile + r;
    const bf16* src = patches + (static_cast<int64_t>(at) * p + (row < p ? row : 64 * tile)) * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) next[d] = src[d];
  };
  if (patch < c) load_point(patch, 0);
  gm::mbar_wait(bar, 0);  // the weights are in

#pragma unroll 1
  for (; patch < c; patch += step) {
#pragma unroll 1
    for (int tile = 0; tile < tiles; ++tile) {
      // conv0a (K=3) on the CUDA cores, f32 FMA in the plain product's order
      {
        const float x0 = __bfloat162float(next[0]);
        const float x1 = __bfloat162float(next[1]);
        const float x2 = __bfloat162float(next[2]);
        if (tile + 1 < tiles) load_point(patch, tile + 1);
        else if (patch + step < c) load_point(patch + step, 0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col0 = 32 * (t & 1) + 8 * u;
          uint4 packed;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = col0 + 2 * e;
            const float2 wa = ld2(w0a + col), wb = ld2(w0a + 64 + col), wc = ld2(w0a + 128 + col);
            const float acc0 = fmaf(x2, wc.x, fmaf(x1, wb.x, fmaf(x0, wa.x, 0.f)));
            const float acc1 = fmaf(x2, wc.y, fmaf(x1, wb.y, fmaf(x0, wa.y, 0.f)));
            h[e] = __float22bfloat162_rn(relu2(bn_out(acc0, acc1, aff, col)));
          }
          *reinterpret_cast<uint4*>(act_a + gm::swizzle_offset(r, col0, 64)) = packed;
        }
      }
      gm::fence_proxy_async();
      sync();

      // conv0b 64 -> 64 (a -> b), then b's rows < p to global memory
      {
        float acc[32];
        gm::mma_ktile<64>(acc, a_addr, w_addr);
        store_bn_relu<64>(acc, aff + 3 * W, act_b, 0, r0, cl);
      }
      gm::fence_proxy_async();
      sync();
      uint4* dst = reinterpret_cast<uint4*>(b_out + (static_cast<int64_t>(patch) * p + 64 * tile) * 64);
      for (int i = t; i < min(64, p - 64 * tile) * 8; i += WG_THREADS)
        dst[i] = *reinterpret_cast<const uint4*>(act_b + gm::swizzle_offset(i >> 3, 8 * (i & 7), 64));

      // stn conv1 64 -> 64 (b -> a), conv2 64 -> 128 (a -> b)
      {
        float acc[32];
        gm::mma_ktile<64>(acc, b_addr, w_addr + TILE);
        store_bn_relu<64>(acc, aff + 6 * W, act_a, 0, r0, cl);
      }
      gm::fence_proxy_async();
      sync();
      {
        float acc[64];
        gm::mma_ktile<128>(acc, a_addr, w_addr + 2 * TILE);
        store_bn_relu<128>(acc, aff + 9 * W, act_b, 0, r0, cl);
      }
      gm::fence_proxy_async();
      sync();

      // stn conv3 128 -> 256 (b), +BN+relu, and the max over the tile's 64
      // rows (rows >= p repeat a real row) straight from the fragments, then
      // over the tiles
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        float total[64];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float part[64];
          gm::mma_ktile<128>(part, b_addr + k * TILE, w_addr + (4 + 2 * (2 * half + k)) * TILE);
          gm::add_partial(total, part, k);
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 128 * half + 8 * j + cl;
          const float2 y0 = relu2(bn_out(total[4 * j], total[4 * j + 1], aff + 12 * W, col));
          const float2 y1 = relu2(bn_out(total[4 * j + 2], total[4 * j + 3], aff + 12 * W, col));
          const float2 m = lane_reduce(make_float2(fmaxf(y0.x, y1.x), fmaxf(y0.y, y1.y)),
                                       [](float a, float b) { return fmaxf(a, b); });
          if (l < 4) {
            float2* cm = reinterpret_cast<float2*>(colmax + w * W + col);
            *cm = tile == 0 ? m : make_float2(fmaxf(cm->x, m.x), fmaxf(cm->y, m.y));
          }
        }
      }
    }
    sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = t + WG_THREADS * h;
      const float m = fmaxf(fmaxf(colmax[col], colmax[W + col]),
                            fmaxf(colmax[2 * W + col], colmax[3 * W + col]));
      pooled[static_cast<int64_t>(patch) * W + col] = __float2bfloat16_rn(m);
    }
    sync();
  }
}

__global__ void __launch_bounds__(HEAD_THREADS, 1)
head_wgmma_kernel(const bf16* __restrict__ x2, const bf16* __restrict__ wq,
                  const float* __restrict__ aff, const float* __restrict__ bqv,
                  const unsigned char* __restrict__ pack, bf16* __restrict__ out,
                  int c, int p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = gm::align1024(smem_raw);
  unsigned char* acts = slots + STAGES * SLICE;
  float* floats = reinterpret_cast<float*>(acts + HEAD_WGS * HEAD_ACT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(floats + HEAD_WGS * HEAD_FLOATS);
  Ring ring{slots, bars, bars + STAGES};
  if (threadIdx.x == 0) ring.init(HEAD_WGS * WG_THREADS);
  __syncthreads();
  const int rounds = (c + HEAD_WGS - 1) / HEAD_WGS;
  const int wg = threadIdx.x / WG_THREADS;

  if (wg == HEAD_WGS) {
    // producer: one thread copies the same 14 slices for every round of
    // HEAD_WGS patches
    gm::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == HEAD_WGS * WG_THREADS) {
      for (int round = blockIdx.x; round < rounds; round += gridDim.x) {
        ring.produce(pack, TILE);
        for (int i = 1; i < HEAD_SLICES; ++i) ring.produce(pack + TILE + (i - 1) * SLICE, SLICE);
      }
    }
    return;
  }

  // consumer warpgroup `wg`: thread t, warp w, lane l. Its operands: x2
  // and then conv2's output in act_x, conv1's and then conv3's in act_y.
  gm::setmaxnreg_inc<CONSUMER_REGS>();
  const int t = threadIdx.x % WG_THREADS;
  const int w = t >> 5;
  const int l = t & 31;
  unsigned char* act_x = acts + wg * HEAD_ACT;
  unsigned char* act_y = act_x + 2 * TILE;
  const uint32_t x_addr = gm::smem_u32(act_x);
  const uint32_t y_addr = gm::smem_u32(act_y);
  float* logits = floats + wg * HEAD_FLOATS;
  float* colsum = logits + 64;  // per-warp column sums
  auto sync = [wg] { gm::named_barrier(1 + wg, WG_THREADS); };
  const int r0 = 16 * w + (l >> 2);  // accumulator rows r0 and r0 + 8
  const int cl = 2 * (l & 3);        // accumulator column offset in an n8 block
  const float bq = bqv[0];

#pragma unroll 1
  for (int round = blockIdx.x; round < rounds; round += gridDim.x) {
    // the second patch of an odd last round repeats the last one, unstored
    const int patch = min(HEAD_WGS * round + wg, c - 1);
    const bool store = HEAD_WGS * round + wg < c;

    // x2's rows, rows >= p repeating row 0, into act_x
    for (int i = t; i < 64 * 8; i += WG_THREADS) {
      const int r = i >> 3;
      const int64_t row = static_cast<int64_t>(patch) * p + (r < p ? r : 0);
      *reinterpret_cast<uint4*>(act_x + gm::swizzle_offset(r, 8 * (i & 7), 64)) =
          *reinterpret_cast<const uint4*>(x2 + row * 64 + 8 * (i & 7));
    }
    gm::fence_proxy_async();
    sync();

    // conv1 64 -> 64 (x -> y), conv2 64 -> 128 (y -> x), +BN+relu
    {
      float acc[32];
      gm::mma_ktile<64>(acc, x_addr, ring.wait());
      ring.release();
      store_bn_relu<64>(acc, aff, act_y, 0, r0, cl);
    }
    gm::fence_proxy_async();
    sync();
    {
      float acc[64];
      gm::mma_ktile<128>(acc, y_addr, ring.wait());
      ring.release();
      store_bn_relu<128>(acc, aff + 3 * W, act_x, 0, r0, cl);
    }
    gm::fence_proxy_async();
    sync();

    // conv3 128 -> 256 (x -> y), +BN; fc_query's dot product of rows r0
    // and r0 + 8 over this thread's columns of conv3's bf16 output
    float q0 = 0.f, q1 = 0.f;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float total[64];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float part[64];
        gm::mma_ktile<128>(part, x_addr + k * TILE, ring.wait());
        ring.release();
        gm::add_partial(total, part, k);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * half + 8 * j + cl;
        const float2 wqc = ld2(wq + col);
        const float2 y0 = bn_out(total[4 * j], total[4 * j + 1], aff + 6 * W, col);
        const float2 y1 = bn_out(total[4 * j + 2], total[4 * j + 3], aff + 6 * W, col);
        q0 = fmaf(y0.y, wqc.y, fmaf(y0.x, wqc.x, q0));
        q1 = fmaf(y1.y, wqc.y, fmaf(y1.x, wqc.x, q1));
        *reinterpret_cast<__nv_bfloat162*>(act_y + gm::swizzle_offset(r0, col, 64)) =
            __float22bfloat162_rn(y0);
        *reinterpret_cast<__nv_bfloat162*>(act_y + gm::swizzle_offset(r0 + 8, col, 64)) =
            __float22bfloat162_rn(y1);
      }
    }
    // the four lanes l % 4 of a row hold all its columns
    q0 += __shfl_xor_sync(FULL, q0, 1);
    q0 += __shfl_xor_sync(FULL, q0, 2);
    q1 += __shfl_xor_sync(FULL, q1, 1);
    q1 += __shfl_xor_sync(FULL, q1, 2);
    if ((l & 3) == 0) {
      logits[r0] = rnd<bf16>(rnd<bf16>(q0) + bq);
      logits[r0 + 8] = rnd<bf16>(rnd<bf16>(q1) + bq);
    }
    gm::fence_proxy_async();
    sync();

    // softmax over the p real rows, in every warp: lane l holds rows l and
    // l + 32; every step rounds to bf16, the sum accumulates in f32
    float a0, a1;  // the weights of rows r0 and r0 + 8
    {
      const float ninf = -__int_as_float(0x7f800000);
      const float la = l < p ? logits[l] : ninf;
      const float lb = l + 32 < p ? logits[l + 32] : ninf;
      float m = fmaxf(la, lb);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      const float ea = l < p ? rnd<bf16>(expf(rnd<bf16>(la - m))) : 0.f;
      const float eb = l + 32 < p ? rnd<bf16>(expf(rnd<bf16>(lb - m))) : 0.f;
      float s = ea + eb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      s = rnd<bf16>(s);
      // warps 0-1 hold rows 0-31 (each lane's first row), warps 2-3 rows 32-63
      const float e = w < 2 ? ea : eb;
      const float att = rnd<bf16>(e / s);
      a0 = __shfl_sync(FULL, att, r0 & 31);
      a1 = __shfl_sync(FULL, att, (r0 + 8) & 31);
    }

    // fc_value 256 -> 256 (y), each rounded value weighted by its row's
    // softmax weight and summed over the rows in f32: over rows r0, r0 + 8,
    // then the 8 lanes of a column, then the 4 warps
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float total[64];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float part[64];
        gm::mma_ktile<128>(part, y_addr + k * TILE, ring.wait());
        ring.release();
        gm::add_partial(total, part, k);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * half + 8 * j + cl;
        const float2 b = ld2(bqv + W + col);
        const float2 y0 = value_out(total[4 * j], total[4 * j + 1], b);
        const float2 y1 = value_out(total[4 * j + 2], total[4 * j + 3], b);
        const float2 sum = lane_reduce(
            make_float2(__fadd_rn(__fmul_rn(a0, y0.x), __fmul_rn(a1, y1.x)),
                        __fadd_rn(__fmul_rn(a0, y0.y), __fmul_rn(a1, y1.y))),
            [](float a, float b) { return a + b; });
        if (l < 4) *reinterpret_cast<float2*>(colsum + w * W + col) = sum;
      }
    }
    sync();
    if (store) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = t + WG_THREADS * h;
        const float s = colsum[col] + colsum[W + col] + colsum[2 * W + col] + colsum[3 * W + col];
        out[static_cast<int64_t>(patch) * W + col] = __float2bfloat16_rn(s);
      }
    }
    sync();
  }
}

// K5 for P in (64, 256]: a patch's T = ceil(P / 64) tiles run side by side
// on the T CTAs of a thread-block cluster, CTA t on tile t of both patches
// of a round (one a consumer warpgroup). Each CTA runs conv1-conv3 and
// fc_query of its tile once; conv3's output stays in its shared memory for
// fc_value. Each CTA stores its tile's rounded logits into the shared
// memory of every CTA of the cluster (distributed shared memory); after a
// cluster barrier every CTA takes the max and the sum over the P real rows
// in the same fixed order (lane l: rows l + 32i, then the warp butterfly),
// so all find the same s, and weights its own rows. Each CTA sums its
// weighted values in f32 and stores that column sum into the leader's
// (rank 0) shared memory; after the next round's barrier (or the last
// one) the leader adds the T sums in tile order and stores the output.
// One cluster barrier a round: the arrays it hands over are double
// buffered by round. The leader's producer thread multicasts each weight
// slice to the ring of every CTA (one L2 read serves 2T tiles); the
// consumer warps of every CTA free a slot with a remote arrival on the
// leader's `empty` barrier. The consumers arrive at a round's cluster
// barrier after their logits and wait on it after fc_value's first half of
// products; the producer arrives at once and waits only before its next
// arrival, so neither the products nor the slices stop at the barrier.
constexpr int CLUSTER_FLOATS = 2 * PMAX  // every tile's logits, two rounds
    + 2 * 4 * W                          // the tiles' column sums, two rounds (leader)
    + 4 * W;                             // per-warp column sums
constexpr int CLUSTER_STAGES = 5;
// the ring, each consumer's operands and its next x2 tile, its floats, the barriers
constexpr size_t CLUSTER_SMEM = 1024 + CLUSTER_STAGES * SLICE +
                                HEAD_WGS * (HEAD_ACT + TILE + CLUSTER_FLOATS * sizeof(float)) +
                                2 * CLUSTER_STAGES * sizeof(uint64_t);

__global__ void __launch_bounds__(HEAD_THREADS, 1)
head_cluster_kernel(const bf16* __restrict__ x2, const bf16* __restrict__ wq,
                    const float* __restrict__ aff, const float* __restrict__ bqv,
                    const unsigned char* __restrict__ pack, bf16* __restrict__ out, int c,
                    int p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = gm::align1024(smem_raw);
  unsigned char* acts = slots + CLUSTER_STAGES * SLICE;
  unsigned char* xbufs = acts + HEAD_WGS * HEAD_ACT;
  float* floats = reinterpret_cast<float*>(xbufs + HEAD_WGS * TILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(floats + HEAD_WGS * CLUSTER_FLOATS);
  uint64_t* empty = full + CLUSTER_STAGES;
  const int tiles = (p + 63) / 64;  // the cluster's CTAs
  const uint32_t rank = gm::cluster_ctarank();  // this CTA's tile
  if (threadIdx.x == 0) {
    for (int i = 0; i < CLUSTER_STAGES; ++i) {
      gm::mbar_init(&full[i], 1);
      gm::mbar_init(&empty[i], tiles * HEAD_WGS * 4);  // every consumer warp of the cluster
    }
    gm::mbar_fence_init();
  }
  gm::cluster_sync();  // every CTA's barriers exist before any remote use
  const int rounds = (c + HEAD_WGS - 1) / HEAD_WGS;
  const int first = gm::cluster_id();
  const int step = gm::cluster_count();
  // this cluster's rounds
  const int mine = first < rounds ? (rounds - first + step - 1) / step : 0;
  const int wg = threadIdx.x / WG_THREADS;

  if (wg == HEAD_WGS) {
    // producer: the leader's thread multicasts the same 14 slices for every
    // round of HEAD_WGS patches; every other producer thread leaves
    gm::setmaxnreg_dec<PRODUCER_REGS>();
    if (rank != 0 || threadIdx.x != HEAD_WGS * WG_THREADS) return;
    const uint16_t mask = static_cast<uint16_t>((1u << tiles) - 1);
    const int total = mine * HEAD_SLICES;
    int stage = 0;
    uint32_t phase = 0;
    for (int n = 0, k = 0; k <= mine; ++k) {
      // before round k's barrier: up to its slice 9 (the consumers reach
      // the barrier after slice 5); the rest of the round needs it passed
      if (k < mine) gm::cluster_arrive();
      for (; n < min(HEAD_SLICES * k + 10, total); ++n) {
        const int i = n % HEAD_SLICES;
        const uint32_t bytes = i == 0 ? TILE : SLICE;
        gm::mbar_wait(&empty[stage], phase ^ 1);
        for (int r = 0; r < tiles; ++r)
          gm::mbar_arrive_expect_tx_cluster(gm::map_rank(gm::smem_u32(&full[stage]), r), bytes);
        gm::bulk_copy_g2s_multicast(slots + stage * SLICE,
                                    pack + (i == 0 ? 0 : TILE + (i - 1) * SLICE), bytes,
                                    &full[stage], mask);
        if (++stage == CLUSTER_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (k < mine) gm::cluster_wait();
    }
    gm::cluster_sync();  // the last round's column sums are in
    gm::cluster_sync();  // and read
    return;
  }

  // consumer warpgroup `wg`: thread t, warp w, lane l. Its operands: x2
  // in xbuf (the next round's copied there while this one computes),
  // conv2's output in act_x, conv1's and then conv3's in act_y.
  gm::setmaxnreg_inc<CONSUMER_REGS>();
  const int t = threadIdx.x % WG_THREADS;
  const int w = t >> 5;
  const int l = t & 31;
  unsigned char* act_x = acts + wg * HEAD_ACT;
  unsigned char* act_y = act_x + 2 * TILE;
  unsigned char* xbuf = xbufs + wg * TILE;
  const uint32_t x_addr = gm::smem_u32(act_x);
  const uint32_t y_addr = gm::smem_u32(act_y);
  const uint32_t in_addr = gm::smem_u32(xbuf);
  float* logits = floats + wg * CLUSTER_FLOATS;  // [2 rounds][PMAX rows]
  float* sums = logits + 2 * PMAX;               // [2 rounds][4 tiles][W]
  float* colsum = sums + 2 * 4 * W;              // [4 warps][W]
  auto sync = [wg] { gm::named_barrier(1 + wg, WG_THREADS); };
  const int r0 = 16 * w + (l >> 2);  // accumulator rows r0 and r0 + 8
  const int cl = 2 * (l & 3);        // accumulator column offset in an n8 block
  const float bq = bqv[0];
  const float ninf = -__int_as_float(0x7f800000);
  int stage = 0;  // the weight ring: wait on this CTA's `full`, free on the leader's `empty`
  uint32_t phase = 0;
  const uint32_t empty0 = gm::map_rank(gm::smem_u32(empty), 0);

  // the leader's output of the round before: the tiles' sums in tile order
  auto store_out = [&](int round, int buf) {
    if (rank != 0 || HEAD_WGS * round + wg >= c) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = t + WG_THREADS * h;
      float s = sums[buf * 4 * W + col];
      for (int r = 1; r < tiles; ++r) s += sums[(buf * 4 + r) * W + col];
      out[static_cast<int64_t>(HEAD_WGS * round + wg) * W + col] = __float2bfloat16_rn(s);
    }
  };

  // x2's rows of this CTA's tile of round `round` (the second patch of an
  // odd last round repeats the last one, unstored), rows >= p repeating the
  // tile's first, into xbuf by cp.async
  auto copy_x2 = [&](int round) {
    const int patch = min(HEAD_WGS * round + wg, c - 1);
    for (int i = t; i < 64 * 8; i += WG_THREADS) {
      const int r = 64 * rank + (i >> 3);
      const int64_t row = static_cast<int64_t>(patch) * p + (r < p ? r : 64 * rank);
      gm::cp_async16(xbuf + gm::swizzle_offset(i >> 3, 8 * (i & 7), 64),
                     x2 + row * 64 + 8 * (i & 7));
    }
    gm::cp_async_commit();
  };
  if (mine) copy_x2(first);

#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    const int round = first + k * step;
    const int buf = k & 1;
    gm::cp_async_wait_all();
    gm::fence_proxy_async();
    sync();  // this round's x2 tile is in xbuf

    // one K-tile product on the next weight slice, which is then freed
    auto mma64 = [&](float (&acc)[32], uint32_t a) {
      gm::mbar_wait(&full[stage], phase);
      gm::mma_ktile<64>(acc, a, gm::smem_u32(slots + stage * SLICE));
    };
    auto mma128 = [&](float (&acc)[64], uint32_t a) {
      gm::mbar_wait(&full[stage], phase);
      gm::mma_ktile<128>(acc, a, gm::smem_u32(slots + stage * SLICE));
    };
    auto release = [&]() {
      __syncwarp();
      if (l == 0) gm::mbar_arrive_cluster(empty0 + 8 * stage);
      if (++stage == CLUSTER_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };

    // conv1 64 -> 64 (x -> y), conv2 64 -> 128 (y -> x), +BN+relu
    {
      float acc[32];
      mma64(acc, in_addr);
      release();
      store_bn_relu<64>(acc, aff, act_y, 0, r0, cl);
    }
    gm::fence_proxy_async();
    sync();  // conv1's output is in act_y, and xbuf is read: the next round's x2 may come
    if (k + 1 < mine) copy_x2(round + step);
    {
      float acc[64];
      mma128(acc, y_addr);
      release();
      store_bn_relu<128>(acc, aff + 3 * W, act_x, 0, r0, cl);
    }
    gm::fence_proxy_async();
    sync();

    // conv3 128 -> 256 (x -> y), +BN; fc_query's dot product of rows r0
    // and r0 + 8 over this thread's columns of conv3's bf16 output
    float q0 = 0.f, q1 = 0.f;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float total[64];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        float part[64];
        mma128(part, x_addr + kt * TILE);
        release();
        gm::add_partial(total, part, kt);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * half + 8 * j + cl;
        const float2 wqc = ld2(wq + col);
        const float2 y0 = bn_out(total[4 * j], total[4 * j + 1], aff + 6 * W, col);
        const float2 y1 = bn_out(total[4 * j + 2], total[4 * j + 3], aff + 6 * W, col);
        q0 = fmaf(y0.y, wqc.y, fmaf(y0.x, wqc.x, q0));
        q1 = fmaf(y1.y, wqc.y, fmaf(y1.x, wqc.x, q1));
        *reinterpret_cast<__nv_bfloat162*>(act_y + gm::swizzle_offset(r0, col, 64)) =
            __float22bfloat162_rn(y0);
        *reinterpret_cast<__nv_bfloat162*>(act_y + gm::swizzle_offset(r0 + 8, col, 64)) =
            __float22bfloat162_rn(y1);
      }
    }
    // the four lanes l % 4 of a row hold all its columns; lane l % 4 == 0
    // stores the row's rounded logit into every CTA's array (the tile's
    // sum, at the end of the round, goes to the leader)
    q0 += __shfl_xor_sync(FULL, q0, 1);
    q0 += __shfl_xor_sync(FULL, q0, 2);
    q1 += __shfl_xor_sync(FULL, q1, 1);
    q1 += __shfl_xor_sync(FULL, q1, 2);
    if ((l & 3) == 0) {
      const float v0 = rnd<bf16>(rnd<bf16>(q0) + bq), v1 = rnd<bf16>(rnd<bf16>(q1) + bq);
      const uint32_t at = gm::smem_u32(logits + PMAX * buf + 64 * rank + r0);
      for (int r = 0; r < tiles; ++r) {
        gm::st_cluster(gm::map_rank(at, r), v0);
        gm::st_cluster(gm::map_rank(at + 32, r), v1);
      }
    }
    gm::fence_proxy_async();
    sync();  // conv3's output is in act_y for fc_value
    gm::cluster_arrive();

    // fc_value 256 -> 256 (y), each rounded value weighted by its row's
    // softmax weight and summed over the rows in f32: over rows r0, r0 + 8,
    // then the 8 lanes of a column, then the 4 warps. The first half's
    // products run before the cluster barrier is waited on: the weights
    // enter only its epilogue.
    float a0 = 0.f, a1 = 0.f;  // the softmax weights of this tile's rows r0 and r0 + 8
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      float total[64];
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        float part[64];
        mma128(part, y_addr + kt * TILE);
        release();
        gm::add_partial(total, part, kt);
      }
      if (half == 0) {
        gm::cluster_wait();  // every tile's logits of this round are in, the sums of the last
        if (k) store_out(round - step, buf ^ 1);

        // softmax over the p real rows of all tiles, in every warp: lane
        // l holds rows l + 32i; every step rounds to bf16, the sum
        // accumulates in f32 in that fixed order
        const float* lg = logits + PMAX * buf;
        float e[PMAX / 32];
        float m = ninf;
#pragma unroll
        for (int i = 0; i < PMAX / 32; ++i) {
          e[i] = l + 32 * i < p ? lg[l + 32 * i] : ninf;
          m = fmaxf(m, e[i]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < PMAX / 32; ++i) {
          e[i] = l + 32 * i < p ? rnd<bf16>(expf(rnd<bf16>(e[i] - m))) : 0.f;
          s += e[i];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
        s = rnd<bf16>(s);
        // this tile's rows l and l + 32 are rows l + 32 (2 rank) and
        // l + 32 (2 rank + 1); warps 0-1 hold rows 0-31, warps 2-3 rows 32-63
        float mine_e = 0.f;
#pragma unroll
        for (int i = 0; i < PMAX / 32; ++i)
          if (i == 2 * static_cast<int>(rank) + (w >> 1)) mine_e = e[i];
        const float weight = rnd<bf16>(mine_e / s);
        a0 = __shfl_sync(FULL, weight, r0 & 31);
        a1 = __shfl_sync(FULL, weight, (r0 + 8) & 31);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * half + 8 * j + cl;
        const float2 b = ld2(bqv + W + col);
        const float2 y0 = value_out(total[4 * j], total[4 * j + 1], b);
        const float2 y1 = value_out(total[4 * j + 2], total[4 * j + 3], b);
        const float2 sum = lane_reduce(
            make_float2(__fadd_rn(__fmul_rn(a0, y0.x), __fmul_rn(a1, y1.x)),
                        __fadd_rn(__fmul_rn(a0, y0.y), __fmul_rn(a1, y1.y))),
            [](float a, float b) { return a + b; });
        if (l < 4) *reinterpret_cast<float2*>(colsum + w * W + col) = sum;
      }
    }
    sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = t + WG_THREADS * h;
      gm::st_cluster(gm::map_rank(gm::smem_u32(sums + (buf * 4 + rank) * W + col), 0),
                     colsum[col] + colsum[W + col] + colsum[2 * W + col] + colsum[3 * W + col]);
    }
  }
  gm::cluster_sync();  // the last round's sums are in
  if (mine) store_out(first + (mine - 1) * step, (mine - 1) & 1);
  gm::cluster_sync();  // no CTA leaves while the leader may still take its stores
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

cudaError_t launch_trunk_bf16(const void* patches, const void* w0a, const void* aff,
                              const void* pack, void* b_out, void* pooled, int c, int p,
                              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      trunk_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TRUNK_SMEM));
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const int blocks = min((c + TRUNK_WGS - 1) / TRUNK_WGS, sms);
  trunk_wgmma_kernel<<<blocks, TRUNK_WGS * WG_THREADS, TRUNK_SMEM, stream>>>(
      static_cast<const bf16*>(patches), static_cast<const bf16*>(w0a),
      static_cast<const float*>(aff), static_cast<const unsigned char*>(pack),
      static_cast<bf16*>(b_out), static_cast<bf16*>(pooled), c, p);
  return cudaGetLastError();
}

// `head_cluster_kernel`'s launch for c patches of 64 < p <= 256 points:
// `cluster` = ceil(p / 64) CTAs a cluster, `active` clusters the card
// holds at once, `blocks` in the grid. `cfg` and `attr` are filled for the
// launch.
cudaError_t cluster_grid(int c, int p, int* cluster, int* active, int* blocks,
                         cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const int rounds = (c + HEAD_WGS - 1) / HEAD_WGS;
  const size_t smem = CLUSTER_SMEM;
  cudaError_t err;
  // the attribute and the clusters of each size that fit, once per device
  static int cached_device = -1;
  static int cached_active[PMAX / 64 + 1] = {};
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if (device != cached_device) {
    if ((err = cudaFuncSetAttribute(head_cluster_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
      return err;
    for (int& a : cached_active) a = 0;
    cached_device = device;
  }
  *cluster = (p + 63) / 64;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = *cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(*cluster);
  cfg->blockDim = dim3(HEAD_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  // how many clusters fit at once depends on the card's GPC layout
  if (!cached_active[*cluster] &&
      (err = cudaOccupancyMaxActiveClusters(&cached_active[*cluster],
                                            reinterpret_cast<const void*>(head_cluster_kernel),
                                            cfg)) != cudaSuccess)
    return err;
  *active = cached_active[*cluster];
  if (*active < 1) return cudaErrorInvalidConfiguration;
  *blocks = min(rounds, *active) * *cluster;
  cfg->gridDim = dim3(*blocks);
  return cudaSuccess;
}

cudaError_t launch_head_cluster(const void* x2, const void* wq, const void* aff,
                                const void* bqv, const void* pack, void* out, int c, int p,
                                cudaStream_t stream) {
  int cluster = 0, active = 0, blocks = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_grid(c, p, &cluster, &active, &blocks, &cfg, attr);
  if (err != cudaSuccess) return err;
  cfg.stream = stream;
  if ((err = cudaLaunchKernelEx(&cfg, head_cluster_kernel, static_cast<const bf16*>(x2),
                                static_cast<const bf16*>(wq), static_cast<const float*>(aff),
                                static_cast<const float*>(bqv),
                                static_cast<const unsigned char*>(pack), static_cast<bf16*>(out),
                                c, p)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

cudaError_t launch_head_bf16(const void* x2, const void* wq, const void* aff,
                             const void* bqv, const void* pack, void* out, int c, int p,
                             cudaStream_t stream) {
  if (p > 64) return launch_head_cluster(x2, wq, aff, bqv, pack, out, c, p, stream);
  const size_t smem = head_smem_bytes(HEAD_FLOATS);
  cudaError_t err = cudaFuncSetAttribute(
      head_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const int blocks = min((c + HEAD_WGS - 1) / HEAD_WGS, sms);
  head_wgmma_kernel<<<blocks, HEAD_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x2), static_cast<const bf16*>(wq),
      static_cast<const float*>(aff), static_cast<const float*>(bqv),
      static_cast<const unsigned char*>(pack), static_cast<bf16*>(out), c, p);
  return cudaGetLastError();
}

// ---- K5 in f32 on the tensor cores: 3xTF32, a patch's tiles on a cluster ----
//
// Every P in 1..256: a patch's T = ceil(P / 64) tiles run on the T CTAs of
// a thread-block cluster (T = 1 a cluster of one), CTA t on tile t of both
// patches of a round (one a consumer warpgroup), as `head_cluster_kernel`
// does, so no tile's conv1-conv3 runs twice. Each CTA's thread 0 streams
// its own copy of the weights (`gmma.cuh::FedRing`: no producer warp, so
// 255 registers a thread), split into tf32 hi and lo once per table
// (`ops/pointnet_att.py::pack_head_tf32x3`, 864 KB: 54 slices of the hi and
// lo tiles of 64 output columns x 32 inputs), through a ring of four
// slices with bulk copies and mbarriers: a slice serves the CTA's two
// tiles, 432 KB of L2 reads a tile. Each product is 3xTF32 (`gmma.cuh`:
// A fragments from the f32 activation in shared memory, split in
// registers; `wgmma` m64n64k8 on tf32; a fresh partial a K-chunk of 32
// inputs, added in f32), a column quarter at a time. A warpgroup's one
// 64 KB activation buffer holds
// x2, then each layer's output in place: quarters beyond the layer's input
// width are written at once, the others held in registers to the layer's
// last product (at most two: conv3's quarters 0 and 1). conv3's epilogue takes
// fc_query's dot product and stores the tile's logits into every CTA's
// shared memory; after a cluster barrier each CTA takes the softmax over
// the P real rows in one fixed order, weights its own rows' fc_value and
// sends its column sums to the leader, which adds them in tile order. One
// cluster barrier a round, the arrays it hands over double buffered by
// round.
namespace tf32 {

constexpr int STAGES = 4;
constexpr int SLICE = gm::TF32_SLICE;
// conv1 (1 column quarter x 2 K-chunks), conv2 (2 x 2: quarter 1 first),
// conv3 (4 x 4: quarters 2, 3, 0, 1), fc_value (4 x 8), quarter by quarter
// (`ops/pointnet_att.py::pack_head_tf32x3`)
constexpr int SLICES = 2 + 4 + 16 + 32;
constexpr int WGS = 2;  // warpgroups, one patch each
constexpr int THREADS_TF = WGS * WG_THREADS;  // thread 0 also feeds the ring
// a consumer's floats: activations, every tile's logits (two rounds), the
// tiles' column sums (two rounds; the leader's), per-warp column sums
constexpr int ACT = 64 * W;
constexpr int WG_FLOATS = ACT + 2 * PMAX + 2 * 4 * W + 4 * W;
constexpr size_t SMEM = 1024 + STAGES * SLICE + WGS * WG_FLOATS * sizeof(float) +
                        2 * STAGES * sizeof(uint64_t);

using RingTF = gm::FedRing<STAGES, SLICE>;

// dense + eval BN (`pointnet_pallas.py:41-53`) in f32 of the accumulators
// of columns col, col + 1: the product plus the bias, then the affine
// unfused, as the plain version computes it
__device__ __forceinline__ float2 bn_f32(float acc0, float acc1, const float* __restrict__ aff,
                                         int col) {
  const float2 b = ld2(aff + col), g = ld2(aff + W + col), c = ld2(aff + 2 * W + col);
  return make_float2(__fadd_rn(__fmul_rn(__fadd_rn(acc0, b.x), g.x), c.x),
                     __fadd_rn(__fmul_rn(__fadd_rn(acc1, b.y), g.y), c.y));
}

// bn_f32 (+relu) of column quarter q into act (rows LD floats apart);
// returns the fc_query dot products of rows r0 and r0 + 8 over these
// columns (wq null: none)
template <int LD = 256>
__device__ __forceinline__ float2 store_bn(const float (&total)[32], int q,
                                           const float* __restrict__ aff, bool relu,
                                           const float* __restrict__ wq, float* act, int r0,
                                           int cl) {
  float2 dot = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 64 * q + 8 * j + cl;
    const float2 y0 = bn_f32(total[4 * j], total[4 * j + 1], aff, col);
    const float2 y1 = bn_f32(total[4 * j + 2], total[4 * j + 3], aff, col);
    *reinterpret_cast<float2*>(act + gm::act_offset<LD>(r0, col)) = relu ? relu2(y0) : y0;
    *reinterpret_cast<float2*>(act + gm::act_offset<LD>(r0 + 8, col)) = relu ? relu2(y1) : y1;
    if (wq) {
      const float2 w = ld2(wq + col);
      dot.x = fmaf(y0.y, w.y, fmaf(y0.x, w.x, dot.x));
      dot.y = fmaf(y1.y, w.y, fmaf(y1.x, w.x, dot.y));
    }
  }
  return dot;
}

__global__ void __launch_bounds__(THREADS_TF, 1)
head_tf32_kernel(const float* __restrict__ x2, const float* __restrict__ wq,
                 const float* __restrict__ aff, const float* __restrict__ bqv,
                 const unsigned char* __restrict__ pack, float* __restrict__ out, int c, int p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = gm::align1024(smem_raw);
  float* floats = reinterpret_cast<float*>(slots + STAGES * SLICE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(floats + WGS * WG_FLOATS);
  const int tiles = (p + 63) / 64;  // the cluster's CTAs
  const uint32_t rank = gm::cluster_ctarank();  // this CTA's tile
  const int rounds = (c + WGS - 1) / WGS;
  const int first = gm::cluster_id();
  const int step = gm::cluster_count();
  // this cluster's rounds
  const int mine = first < rounds ? (rounds - first + step - 1) / step : 0;
  // thread 0 feeds the same slices for every round of the CTA
  RingTF ring;
  ring.slots = slots;
  ring.full = bars;
  ring.empty = bars + STAGES;
  ring.src = pack;
  ring.per_round = SLICES;
  ring.total = mine * SLICES;
  ring.producer = threadIdx.x == 0;
  if (threadIdx.x == 0) ring.init(WGS * WG_THREADS);
  gm::cluster_sync();  // every CTA's barriers and arrays exist before any remote use
  ring.start();
  const int wg = threadIdx.x / WG_THREADS;

  // warpgroup `wg`: thread t, warp w, lane l
  const int t = threadIdx.x % WG_THREADS;
  const int w = t >> 5;
  const int l = t & 31;
  float* act = floats + wg * WG_FLOATS;
  float* logits = act + ACT;            // [2 rounds][PMAX rows]
  float* sums = logits + 2 * PMAX;      // [2 rounds][4 tiles][W]
  float* colsum = sums + 2 * 4 * W;     // [4 warps][W]
  auto sync = [wg] { gm::named_barrier(1 + wg, WG_THREADS); };
  const int r0 = 16 * w + (l >> 2);  // fragment rows r0 and r0 + 8
  const int cl = 2 * (l & 3);        // fragment column offset in an n8 block
  const float bq = bqv[0];
  const float ninf = -__int_as_float(0x7f800000);

  // the leader's output of a round: the tiles' column sums in tile order
  auto store_out = [&](int round, int buf) {
    if (rank != 0 || WGS * round + wg >= c) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = t + WG_THREADS * h;
      float s = sums[buf * 4 * W + col];
      for (int r = 1; r < tiles; ++r) s += sums[(buf * 4 + r) * W + col];
      out[static_cast<int64_t>(WGS * round + wg) * W + col] = s;
    }
  };

#pragma unroll 1
  for (int k = 0; k < mine; ++k) {
    const int round = first + k * step;
    const int buf = k & 1;
    // x2's rows of this CTA's tile (the second patch of an odd last round
    // repeats the last one, unstored; rows past p repeat the tile's first)
    {
      const int patch = min(WGS * round + wg, c - 1);
      for (int i = t; i < 64 * 16; i += WG_THREADS) {
        const int r = i >> 4, col = 4 * (i & 15);
        const int row = 64 * static_cast<int>(rank) + r;
        const int64_t src = static_cast<int64_t>(patch) * p + (row < p ? row : 64 * rank);
        gm::cp_async16(act + gm::act_offset(r, col), x2 + src * 64 + col);
      }
      gm::cp_async_commit();
      gm::cp_async_wait_all();
      sync();
    }

    // conv1 64 -> 64, conv2 64 -> 128 (+BN+relu), conv3 128 -> 256 (+BN),
    // in place, a column quarter at a time in the weight stream's order: a
    // quarter whose columns the layer still reads (those below its input
    // width) is held in registers until the layer's last product
    {
      float t0[32];
      gm::mma_quarter_tf32x3<2>(t0, act, ring, r0, cl);
      sync();
      store_bn(t0, 0, aff, true, nullptr, act, r0, cl);
      sync();
    }
    {
      float t1[32];
      gm::mma_quarter_tf32x3<2>(t1, act, ring, r0, cl);
      store_bn(t1, 1, aff + 3 * W, true, nullptr, act, r0, cl);
      gm::mma_quarter_tf32x3<2>(t1, act, ring, r0, cl);
      sync();
      store_bn(t1, 0, aff + 3 * W, true, nullptr, act, r0, cl);
      sync();
    }
    // conv3's epilogue also takes fc_query's dot products of rows r0 and
    // r0 + 8 over this thread's columns
    float2 dot = make_float2(0.f, 0.f);
    {
      float t0[32], t1[32];
#pragma unroll 1
      for (int q = 2; q < 4; ++q) {
        gm::mma_quarter_tf32x3<4>(t0, act, ring, r0, cl);
        const float2 d = store_bn(t0, q, aff + 6 * W, false, wq, act, r0, cl);
        dot = make_float2(dot.x + d.x, dot.y + d.y);
      }
      gm::mma_quarter_tf32x3<4>(t0, act, ring, r0, cl);
      gm::mma_quarter_tf32x3<4>(t1, act, ring, r0, cl);
      sync();
      const float2 d0 = store_bn(t0, 0, aff + 6 * W, false, wq, act, r0, cl);
      const float2 d1 = store_bn(t1, 1, aff + 6 * W, false, wq, act, r0, cl);
      dot = make_float2(dot.x + d0.x + d1.x, dot.y + d0.y + d1.y);
    }
    // the four lanes l % 4 of a row hold all its columns; lane l % 4 == 0
    // stores the row's logit into every CTA's array
    float q0 = dot.x, q1 = dot.y;
    q0 += __shfl_xor_sync(FULL, q0, 1);
    q0 += __shfl_xor_sync(FULL, q0, 2);
    q1 += __shfl_xor_sync(FULL, q1, 1);
    q1 += __shfl_xor_sync(FULL, q1, 2);
    if ((l & 3) == 0) {
      const uint32_t at = gm::smem_u32(logits + PMAX * buf + 64 * rank + r0);
      for (int r = 0; r < tiles; ++r) {
        gm::st_cluster(gm::map_rank(at, r), q0 + bq);
        gm::st_cluster(gm::map_rank(at + 32, r), q1 + bq);
      }
    }
    sync();  // conv3's output is in act for fc_value
    gm::cluster_arrive();

    // fc_value 256 -> 256 (+bias), a column quarter at a time, weighted by
    // the softmax and summed over the rows in f32: rows r0, r0 + 8, the 8
    // lanes of a column, then the 4 warps. The first quarter's products run
    // before the cluster barrier is waited on.
    float a0 = 0.f, a1 = 0.f;  // the softmax weights of this tile's rows r0 and r0 + 8
    auto weigh = [&](const float (&total)[32], int q) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * q + 8 * j + cl;
        const float2 b = ld2(bqv + W + col);
        const float2 sum = lane_reduce(
            make_float2(
                __fadd_rn(__fmul_rn(a0, __fadd_rn(total[4 * j], b.x)),
                          __fmul_rn(a1, __fadd_rn(total[4 * j + 2], b.x))),
                __fadd_rn(__fmul_rn(a0, __fadd_rn(total[4 * j + 1], b.y)),
                          __fmul_rn(a1, __fadd_rn(total[4 * j + 3], b.y)))),
            [](float x, float y) { return x + y; });
        if (l < 4) *reinterpret_cast<float2*>(colsum + w * W + col) = sum;
      }
    };
    float tv[32];
    gm::mma_quarter_tf32x3<8>(tv, act, ring, r0, cl);
    gm::cluster_wait();  // every tile's logits of this round are in, the sums of the last
    if (k) store_out(round - step, buf ^ 1);

    // softmax over the p real rows of all tiles, in every warp: lane l
    // holds rows l + 32i; the sum accumulates in f32 in that fixed order.
    // This tile's rows l and l + 32 are rows l + 32 (2 rank) and l + 32 (2
    // rank + 1): warps 0-1 hold rows 0-31, warps 2-3 rows 32-63.
    {
      const float* lg = logits + PMAX * buf;
      float m = ninf;
#pragma unroll
      for (int i = 0; i < PMAX / 32; ++i)
        if (l + 32 * i < p) m = fmaxf(m, lg[l + 32 * i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PMAX / 32; ++i) s += l + 32 * i < p ? expf(lg[l + 32 * i] - m) : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      const int row = l + 32 * (2 * static_cast<int>(rank) + (w >> 1));
      const float weight = row < p ? expf(lg[row] - m) / s : 0.f;
      a0 = __shfl_sync(FULL, weight, r0 & 31);
      a1 = __shfl_sync(FULL, weight, (r0 + 8) & 31);
    }
    weigh(tv, 0);
#pragma unroll 1
    for (int q = 1; q < 4; ++q) {
      gm::mma_quarter_tf32x3<8>(tv, act, ring, r0, cl);
      weigh(tv, q);
    }
    sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = t + WG_THREADS * h;
      gm::st_cluster(gm::map_rank(gm::smem_u32(sums + (buf * 4 + rank) * W + col), 0),
                     colsum[col] + colsum[W + col] + colsum[2 * W + col] + colsum[3 * W + col]);
    }
  }
  gm::cluster_sync();  // the last round's sums are in
  if (mine) store_out(first + (mine - 1) * step, (mine - 1) & 1);
  gm::cluster_sync();  // no CTA leaves while the leader may still take its stores
}

// the launch for c patches of p points: clusters of ceil(p / 64) CTAs, as
// many at once as fit; `cfg` and `attr` are filled for the launch
cudaError_t grid(int c, int p, int* cluster, int* active, int* blocks, cudaLaunchConfig_t* cfg,
                 cudaLaunchAttribute* attr) {
  cudaError_t err;
  static int cached_device = -1;
  static int cached_active[PMAX / 64 + 1] = {};
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if (device != cached_device) {
    if ((err = cudaFuncSetAttribute(head_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(SMEM))) != cudaSuccess)
      return err;
    for (int& a : cached_active) a = 0;
    cached_device = device;
  }
  *cluster = (p + 63) / 64;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = *cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(*cluster);
  cfg->blockDim = dim3(THREADS_TF);
  cfg->dynamicSmemBytes = SMEM;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  if (!cached_active[*cluster] &&
      (err = cudaOccupancyMaxActiveClusters(&cached_active[*cluster],
                                            reinterpret_cast<const void*>(head_tf32_kernel),
                                            cfg)) != cudaSuccess)
    return err;
  *active = cached_active[*cluster];
  if (*active < 1) return cudaErrorInvalidConfiguration;
  *blocks = min((c + WGS - 1) / WGS, *active) * *cluster;
  cfg->gridDim = dim3(*blocks);
  return cudaSuccess;
}

cudaError_t launch(const void* x2, const void* wq, const void* aff, const void* bqv,
                   const void* pack, void* out, int c, int p, cudaStream_t stream) {
  int cluster = 0, active = 0, blocks = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = grid(c, p, &cluster, &active, &blocks, &cfg, attr);
  if (err != cudaSuccess) return err;
  cfg.stream = stream;
  if ((err = cudaLaunchKernelEx(&cfg, head_tf32_kernel, static_cast<const float*>(x2),
                                static_cast<const float*>(wq), static_cast<const float*>(aff),
                                static_cast<const float*>(bqv),
                                static_cast<const unsigned char*>(pack), static_cast<float*>(out),
                                c, p)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// ---- K4 in f32 on the tensor cores: 3xTF32 ----
//
// Persistent blocks, one per SM, of TRUNK_WGS warpgroups, each on its own
// patches (a round is one patch a warpgroup; the last round's spare
// warpgroups repeat the last patch, unstored). A patch's tiles of 64 rows
// run one after the other in its warpgroup: the max over them needs no
// cluster, its order does not change it. Thread 0 feeds the ring
// (`gmma.cuh::FedRing`) with the same 24 slices for every tile of a round
// (`ops/pointnet_att.py::pack_trunk_tf32x3`, 384 KB: the tf32 hi and lo
// tile of 64 output columns x 32 inputs, conv0b 2, stn conv1 2, stn conv2
// 4 (quarter 1 first), stn conv3 16), so a slice serves the block's
// TRUNK_WGS tiles. conv0a (K=3) runs on the CUDA cores in f32 from the
// patch rows, loaded a tile ahead. conv0b, stn conv1 and stn conv2 run a
// column quarter at a time (`gmma.cuh::mma_quarter_tf32x3`, a fresh
// partial a K-chunk of 32 inputs) on the f32 activation in shared memory
// and write their output over their input; b is copied out after conv0b.
// stn conv3's output is never stored: each quarter's bn + relu is
// max-reduced from the fragments (rows r0 and r0 + 8, the 8 lanes that
// share the columns, then the 4 warps, across the tiles), so the widest
// stored activation is stn conv2's, 128 columns, 32 KB a warpgroup.
constexpr int TRUNK_WGS = 3;
constexpr int TRUNK_THREADS = TRUNK_WGS * WG_THREADS;  // thread 0 also feeds the ring
// conv0b (1 column quarter x 2 K-chunks), stn conv1 (1 x 2), stn conv2 (2
// x 2: quarter 1 first), stn conv3 (4 x 4), quarter by quarter
// (`ops/pointnet_att.py::TRUNK_QUARTERS`)
constexpr int TRUNK_SLICES = 2 + 2 + 4 + 16;
constexpr int TRUNK_LD = 128;  // an activation row: stn conv2's 128 columns
// a warpgroup's floats: activations, per-warp column maxima
constexpr int TRUNK_FLOATS = 64 * TRUNK_LD + 4 * W;
constexpr size_t TRUNK_SMEM = 1024 + STAGES * SLICE + TRUNK_WGS * TRUNK_FLOATS * sizeof(float) +
                              2 * STAGES * sizeof(uint64_t);

__global__ void __launch_bounds__(TRUNK_THREADS, 1)
trunk_tf32_kernel(const float* __restrict__ patches, const float* __restrict__ w0a,
                  const float* __restrict__ aff, const unsigned char* __restrict__ pack,
                  float* __restrict__ b_out, float* __restrict__ pooled, int c, int p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = gm::align1024(smem_raw);
  float* floats = reinterpret_cast<float*>(slots + STAGES * SLICE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(floats + TRUNK_WGS * TRUNK_FLOATS);
  const int tiles = (p + 63) / 64;
  const int rounds = (c + TRUNK_WGS - 1) / TRUNK_WGS;
  // thread 0 feeds the same slices for every tile of the block's rounds
  RingTF ring;
  ring.slots = slots;
  ring.full = bars;
  ring.empty = bars + STAGES;
  ring.src = pack;
  ring.per_round = TRUNK_SLICES;
  ring.total = static_cast<int>(blockIdx.x) < rounds
                   ? (rounds - blockIdx.x + gridDim.x - 1) / gridDim.x * tiles * TRUNK_SLICES
                   : 0;
  ring.producer = threadIdx.x == 0;
  if (threadIdx.x == 0) ring.init(TRUNK_THREADS);
  __syncthreads();
  ring.start();

  // warpgroup `wg`: thread t, warp w, lane l
  const int wg = threadIdx.x / WG_THREADS;
  const int t = threadIdx.x % WG_THREADS;
  const int w = t >> 5;
  const int l = t & 31;
  float* act = floats + wg * TRUNK_FLOATS;
  float* colmax = act + 64 * TRUNK_LD;  // per-warp column maxima
  auto sync = [wg] { gm::named_barrier(1 + wg, WG_THREADS); };
  const int r0 = 16 * w + (l >> 2);  // fragment rows r0 and r0 + 8
  const int cl = 2 * (l & 3);        // fragment column offset in an n8 block
  const int r = t >> 1;              // conv0a: thread t computes 32 columns of row t / 2
  auto patch_of = [&](int round) { return min(TRUNK_WGS * round + wg, c - 1); };

  // row r's point of tile `tile` of a patch, loaded a tile ahead; rows
  // past p repeat the tile's first point
  float next[3];
  auto load_point = [&](int patch, int tile) {
    const int row = 64 * tile + r;
    const float* src = patches + (static_cast<int64_t>(patch) * p + (row < p ? row : 64 * tile)) * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) next[d] = src[d];
  };
  if (static_cast<int>(blockIdx.x) < rounds) load_point(patch_of(blockIdx.x), 0);

#pragma unroll 1
  for (int round = blockIdx.x; round < rounds; round += gridDim.x) {
    const int patch = patch_of(round);
    const bool store = TRUNK_WGS * round + wg < c;
#pragma unroll 1
    for (int tile = 0; tile < tiles; ++tile) {
      // conv0a (K=3) on the CUDA cores, f32 FMA in the plain product's order
      {
        const float x0 = next[0], x1 = next[1], x2 = next[2];
        if (tile + 1 < tiles) load_point(patch, tile + 1);
        else if (round + static_cast<int>(gridDim.x) < rounds)
          load_point(patch_of(round + gridDim.x), 0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col0 = 32 * (t & 1) + 8 * u;
          float y[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = col0 + 2 * e;
            const float2 wa = ld2(w0a + col), wb = ld2(w0a + 64 + col), wc = ld2(w0a + 128 + col);
            const float2 v = relu2(bn_f32(fmaf(x2, wc.x, fmaf(x1, wb.x, fmaf(x0, wa.x, 0.f))),
                                          fmaf(x2, wc.y, fmaf(x1, wb.y, fmaf(x0, wa.y, 0.f))),
                                          aff, col));
            y[2 * e] = v.x;
            y[2 * e + 1] = v.y;
          }
          float4* dst = reinterpret_cast<float4*>(act + gm::act_offset<TRUNK_LD>(r, col0));
          dst[0] = make_float4(y[0], y[1], y[2], y[3]);
          dst[1] = make_float4(y[4], y[5], y[6], y[7]);
        }
      }
      sync();

      // conv0b 64 -> 64 in place, then b's rows below p to global memory
      {
        float t0[32];
        gm::mma_quarter_tf32x3<2, true, TRUNK_LD>(t0, act, ring, r0, cl);
        sync();
        store_bn<TRUNK_LD>(t0, 0, aff + 3 * W, true, nullptr, act, r0, cl);
        sync();
      }
      if (store) {
        float4* dst = reinterpret_cast<float4*>(
            b_out + (static_cast<int64_t>(patch) * p + 64 * tile) * 64);
        for (int i = t; i < min(64, p - 64 * tile) * 16; i += WG_THREADS)
          dst[i] = *reinterpret_cast<const float4*>(
              act + gm::act_offset<TRUNK_LD>(i >> 4, 4 * (i & 15)));
      }

      // stn conv1 64 -> 64, conv2 64 -> 128 (+BN+relu), in place: conv2's
      // quarter 1 (beyond its input width) is written at once
      {
        float t0[32];
        gm::mma_quarter_tf32x3<2, true, TRUNK_LD>(t0, act, ring, r0, cl);
        sync();  // and b is copied out
        store_bn<TRUNK_LD>(t0, 0, aff + 6 * W, true, nullptr, act, r0, cl);
        sync();
      }
      {
        float t1[32];
        gm::mma_quarter_tf32x3<2, true, TRUNK_LD>(t1, act, ring, r0, cl);
        store_bn<TRUNK_LD>(t1, 1, aff + 9 * W, true, nullptr, act, r0, cl);
        gm::mma_quarter_tf32x3<2, true, TRUNK_LD>(t1, act, ring, r0, cl);
        sync();
        store_bn<TRUNK_LD>(t1, 0, aff + 9 * W, true, nullptr, act, r0, cl);
        sync();
      }

      // stn conv3 128 -> 256, +BN+relu, a column quarter at a time, and the
      // max over the tile's 64 rows (rows past p repeat a real row)
      // straight from the fragments, then over the tiles
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        float tq[32];
        gm::mma_quarter_tf32x3<4, true, TRUNK_LD>(tq, act, ring, r0, cl);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * q + 8 * j + cl;
          const float2 y0 = relu2(bn_f32(tq[4 * j], tq[4 * j + 1], aff + 12 * W, col));
          const float2 y1 = relu2(bn_f32(tq[4 * j + 2], tq[4 * j + 3], aff + 12 * W, col));
          const float2 m = lane_reduce(make_float2(fmaxf(y0.x, y1.x), fmaxf(y0.y, y1.y)),
                                       [](float a, float b) { return fmaxf(a, b); });
          if (l < 4) {
            float2* cm = reinterpret_cast<float2*>(colmax + w * W + col);
            *cm = tile == 0 ? m : make_float2(fmaxf(cm->x, m.x), fmaxf(cm->y, m.y));
          }
        }
      }
      sync();  // every read of act and every column maximum of the tile is done
    }
    if (store) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = t + WG_THREADS * h;
        pooled[static_cast<int64_t>(patch) * W + col] =
            fmaxf(fmaxf(colmax[col], colmax[W + col]), fmaxf(colmax[2 * W + col], colmax[3 * W + col]));
      }
    }
  }
}

cudaError_t launch_trunk(const void* patches, const void* w0a, const void* aff, const void* pack,
                         void* b_out, void* pooled, int c, int p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(trunk_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(TRUNK_SMEM));
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const int blocks = min((c + TRUNK_WGS - 1) / TRUNK_WGS, sms);
  trunk_tf32_kernel<<<blocks, TRUNK_THREADS, TRUNK_SMEM, stream>>>(
      static_cast<const float*>(patches), static_cast<const float*>(w0a),
      static_cast<const float*>(aff), static_cast<const unsigned char*>(pack),
      static_cast<float*>(b_out), static_cast<float*>(pooled), c, p);
  return cudaGetLastError();
}

}  // namespace tf32

}  // namespace

extern "C" int ppsurf_pointnet_trunk(const void* patches, const void* w0a,
                                     const void* w0b, const void* ws1,
                                     const void* ws2, const void* ws3,
                                     const void* aff, const void* pack,
                                     void* b_out, void* pooled, int c, int p,
                                     int is_bf16, void* stream) {
  if (p < 1 || p > PMAX || c < 0 || !pack)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_trunk_bf16(patches, w0a, aff, pack, b_out, pooled, c, p, s);
  return tf32::launch_trunk(patches, w0a, aff, pack, b_out, pooled, c, p, s);
}

extern "C" int ppsurf_pointnet_head(const void* x2, const void* wc1,
                                    const void* wc2, const void* wc3,
                                    const void* wq, const void* wv,
                                    const void* aff, const void* bqv,
                                    const void* pack, void* out, int c, int p,
                                    int is_bf16, void* stream) {
  if (p < 1 || p > PMAX || c < 0 || !pack)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_head_bf16(x2, wq, aff, bqv, pack, out, c, p, s);
  return tf32::launch(x2, wq, aff, bqv, pack, out, c, p, s);
}

// the cluster K5's launch for c patches of 64 < p <= 256 points: out[0]
// the CTAs a cluster, out[1] the clusters the card holds at once, out[2]
// the grid's blocks, out[3] the weight bytes a launch streams by design
// (14 slices a round of two patches, multicast to the cluster): a count
// from the constants, not a measurement
extern "C" int ppsurf_pointnet_head_info(int c, int p, long long* out) {
  if (p <= 64 || p > PMAX || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  int cluster = 0, active = 0, blocks = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = cluster_grid(c, p, &cluster, &active, &blocks, &cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = cluster;
  out[1] = active;
  out[2] = blocks;
  out[3] = static_cast<long long>((c + HEAD_WGS - 1) / HEAD_WGS) *
           (TILE + (HEAD_SLICES - 1) * SLICE);
  return 0;
}
