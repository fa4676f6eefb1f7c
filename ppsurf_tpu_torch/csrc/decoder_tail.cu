// K3: the InterpAttention decoder tail, gather included.
//
// Replaces the TPU kernel `_decoder_tail_kernel`
// (ppsurf_tpu/ops/decoder_pallas.py:49). Design and bounds: see
// ppsurf_tpu_torch/ops/decoder_tail.py. Every build gathers the k <= 64
// neighbours' projected latents straight from the (N, L) table, so the
// (C*k, L) gathered tensor never exists, and writes the attention-pooled
// (L,) feature. A query's rows are 64 neighbours: for k < 64 the rows past
// k repeat neighbour 0, count as -inf logits in the per-head softmax and
// get weight 0. The latent-256 builds keep a query's 64 x 256 activations
// in shared memory through fc2, fc3, fc_query and fc_value.
//
// bf16 (`decoder_tail_wgmma_kernel`): the four products run on the tensor
// cores (`wgmma` m64n128k16 / m64n64k16). Persistent blocks, one per SM,
// of two consumer warpgroups (two queries at a time) and one producer warp
// that streams the weights, pre-arranged in the operand layout
// (`ops/decoder_tail.py::pack_wgmma_weights`), through a four-stage ring of
// 16 KB slices with 1-D bulk copies and mbarriers. A 256-wide product runs
// as two 128-column halves; each half adds four 64-deep tensor-core
// partials in f32 on the CUDA cores. Each epilogue rounds where the plain
// version rounds and writes the next product's operand into the other
// shared-memory buffer of the warpgroup, in the swizzled layout.
//
// f32 (`tf32::decoder_tail_tf32_kernel`): the bf16 kernel's shape, every
// product on the tensor cores as 3xTF32 (`wgmma` m64n64k8 on tf32 hi/lo
// operands, `gmma.cuh`), which keeps f32 accuracy; one TF32 product would
// miss the f32 limit (1e-4 x scale) that the f32 field is held to. See
// `namespace tf32` below.
//
// latent 32 (POCO): bf16 (`decoder_tail_narrow_wgmma_kernel`) and f32
// (`decoder_tail_narrow_tf32_kernel`, 3xTF32) on the tensor cores from one
// body, one warpgroup a query, every activation in registers. See
// `namespace narrow_tc` below.
#include <type_traits>

#include "common.cuh"
#include "gmma.cuh"

namespace {

using ppsurf::rnd;

constexpr int K = 64;       // neighbours per query: the 64 rows of a tile
constexpr int LAT = 256;    // latent width
constexpr int HEADS = 64;   // attention heads

// softmax over the first `kn` <= 64 neighbours per head, mean over heads
// -> att (64,): rows past kn count as -inf logits and get weight 0. Every
// step rounds to T, sums accumulate in f32. Threads tid < 64 work; `sync`
// is the barrier of the threads that share the arrays.
template <typename T, typename Sync>
__device__ __forceinline__ void head_attention(const float* logits, float* hmax,
                                               float* hsum, float* att, int tid,
                                               int kn, Sync sync) {
  if (tid < HEADS) {
    float m = logits[tid];
    for (int r = 1; r < kn; ++r) m = fmaxf(m, logits[r * (HEADS + 1) + tid]);
    float s = 0.f;
    for (int r = 0; r < kn; ++r)
      s += rnd<T>(expf(rnd<T>(logits[r * (HEADS + 1) + tid] - m)));
    hmax[tid] = m;
    hsum[tid] = rnd<T>(s);
  }
  sync();
  if (tid < K) {
    float a = 0.f;
    for (int hh = 0; hh < HEADS; ++hh)
      a += rnd<T>(rnd<T>(expf(rnd<T>(logits[tid * (HEADS + 1) + hh] - hmax[hh]))) /
                  hsum[hh]);
    att[tid] = tid < kn ? rnd<T>(a / HEADS) : 0.f;
  }
  sync();
}

// ---- bf16 on the tensor cores ----
namespace gm = ppsurf::gmma;
using bf16 = __nv_bfloat16;

constexpr int STAGES = 4;                    // weight ring depth
constexpr int SLICE = 16384;                 // bytes of one weight slice
// W2, W3, Wv: (2 column halves x 4 K-tiles) each; Wq: 2 slices of 2 K-tiles
constexpr int SLICES = 26;
constexpr int WG_THREADS = 128;
constexpr int CONSUMERS = 2;                 // warpgroups, one query each
constexpr int THREADS_WG = CONSUMERS * WG_THREADS + 32;  // + producer warp
constexpr int ACT_BYTES = K * LAT * 2;       // one bf16 activation operand
// per-warpgroup small arrays, in floats: rel, ids, att, head max, head
// sum, per-warp column sums
constexpr int SMALL_FLOATS = 3 * K + K + K + HEADS + HEADS + 4 * LAT;
constexpr size_t WG_SMEM = 1024  // alignment slack
    + STAGES * SLICE + CONSUMERS * 2 * ACT_BYTES
    + CONSUMERS * SMALL_FLOATS * sizeof(float) + 2 * STAGES * sizeof(uint64_t);
static_assert(K * (HEADS + 1) * sizeof(float) <= ACT_BYTES, "logits alias an operand");

// the dense epilogue's rounding (`decoder_pallas.py:22-26`): the product
// rounds to bf16, then its sum with the bias
__device__ __forceinline__ float dense_out(float acc, float b) {
  return rnd<bf16>(rnd<bf16>(acc) + b);
}

using Ring = gm::Ring<STAGES, SLICE>;

// total (64 x 128) = act (64 x 256) @ W[:, half]: four 16 KB slices, one
// K-tile of the half's 128 columns each, their partials added in f32
__device__ __forceinline__ void mma_half(float (&total)[64], uint32_t act, Ring& ring) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float part[64];
    gm::mma_ktile<128>(part, act + s * 8192, ring.wait());
    ring.release();
    gm::add_partial(total, part, s);
  }
}

// total (64 x 64) = act (64 x 256) @ Wq: two slices of two K-tiles
__device__ __forceinline__ void mma_query(float (&total)[32], uint32_t act, Ring& ring) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t w = ring.wait();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float part[32];
      gm::mma_ktile<64>(part, act + (2 * s + t) * 8192, w + t * 8192);
      gm::add_partial(total, part, 2 * s + t);
    }
    ring.release();
  }
}

__global__ void __launch_bounds__(THREADS_WG, 1)
decoder_tail_wgmma_kernel(const bf16* __restrict__ latents,
                          const float* __restrict__ pts,
                          const float* __restrict__ queries,
                          const int64_t* __restrict__ ids,
                          const bf16* __restrict__ w1,
                          const float* __restrict__ b2,
                          const float* __restrict__ b3,
                          const float* __restrict__ bq,
                          const float* __restrict__ bv,
                          const unsigned char* __restrict__ wpack,
                          bf16* __restrict__ out, int c, int kn) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = gm::align1024(smem_raw);
  unsigned char* acts = slots + STAGES * SLICE;
  float* floats = reinterpret_cast<float*>(acts + CONSUMERS * 2 * ACT_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(floats + CONSUMERS * SMALL_FLOATS);
  Ring ring{slots, bars, bars + STAGES};
  if (threadIdx.x == 0) ring.init(CONSUMERS * WG_THREADS);
  __syncthreads();
  const int pairs = (c + CONSUMERS - 1) / CONSUMERS;
  const int wg = threadIdx.x / WG_THREADS;

  if (wg == CONSUMERS) {
    // producer: the same 26 slices for every pair of queries
    if (threadIdx.x % 32 == 0) {
      for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x)
        for (int i = 0; i < SLICES; ++i) ring.produce(wpack + i * SLICE, SLICE);
    }
    return;
  }

  // consumer warpgroup `wg`: thread t, warp w, lane l. Its two operand
  // buffers: h1 and h3 live in act0, h2 and then the logits in act1.
  const int t = threadIdx.x % WG_THREADS;
  const int w = t >> 5;
  const int l = t & 31;
  unsigned char* act0 = acts + wg * 2 * ACT_BYTES;
  unsigned char* act1 = act0 + ACT_BYTES;
  float* logits = reinterpret_cast<float*>(act1);
  float* rel = floats + wg * SMALL_FLOATS;
  int* nid = reinterpret_cast<int*>(rel + 3 * K);
  float* att = reinterpret_cast<float*>(nid + K);
  float* hmax = att + K;
  float* hsum = hmax + HEADS;
  float* part = hsum + HEADS;
  auto sync = [wg] { gm::named_barrier(1 + wg, WG_THREADS); };
  const int r0 = 16 * w + (l >> 2);  // accumulator rows r0 and r0 + 8
  const int cl = 2 * (l & 3);        // accumulator column offset in an n8 block

#pragma unroll 1
  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    // the second query of an odd last pair repeats the last one, unstored
    const int cq = min(CONSUMERS * pair + wg, c - 1);
    const bool store = CONSUMERS * pair + wg < c;

    // h = relu(x + rnd(rel @ W1)), x the gathered projected latents
    if (t < K) {
      const int j = static_cast<int>(ids[static_cast<int64_t>(cq) * kn + (t < kn ? t : 0)]);
      nid[t] = j;
#pragma unroll
      for (int d = 0; d < 3; ++d)
        rel[t * 3 + d] = rnd<bf16>(__fsub_rn(queries[3 * cq + d], pts[3 * j + d]));
    }
    sync();
    {
      const int col = (t & 31) * 8;  // this thread's 8 columns, every 4th row
      float wa[8], wb[8], wc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        wa[e] = __bfloat162float(w1[col + e]);
        wb[e] = __bfloat162float(w1[LAT + col + e]);
        wc[e] = __bfloat162float(w1[2 * LAT + col + e]);
      }
#pragma unroll 2
      for (int r = t >> 5; r < K; r += 4) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            latents + static_cast<int64_t>(nid[r]) * LAT + col);
        const bf16* x = reinterpret_cast<const bf16*>(&raw);
        const float* rr = rel + r * 3;
        uint4 packed;
        bf16* h = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float rw = rnd<bf16>(fmaf(rr[2], wc[e], fmaf(rr[1], wb[e], rr[0] * wa[e])));
          h[e] = __float2bfloat16_rn(fmaxf(rnd<bf16>(__bfloat162float(x[e]) + rw), 0.f));
        }
        *reinterpret_cast<uint4*>(act0 + gm::swizzle_offset(r, col, K)) = packed;
      }
    }
    gm::fence_proxy_async();
    sync();

    // fc2 (act0 -> act1), fc3 (act1 -> act0), +relu, a column half at a time
#pragma unroll 1
    for (int layer = 0; layer < 2; ++layer) {
      const uint32_t src = gm::smem_u32(layer == 0 ? act0 : act1);
      unsigned char* dst = layer == 0 ? act1 : act0;
      const float* bias = layer == 0 ? b2 : b3;
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        float acc[64];
        mma_half(acc, src, ring);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 128 * half + 8 * j + cl;
          const float bx = bias[col], by = bias[col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float y0 = fmaxf(dense_out(acc[4 * j + 2 * h], bx), 0.f);
            const float y1 = fmaxf(dense_out(acc[4 * j + 2 * h + 1], by), 0.f);
            *reinterpret_cast<__nv_bfloat162*>(
                dst + gm::swizzle_offset(r0 + 8 * h, col, K)) = __floats2bfloat162_rn(y0, y1);
          }
        }
      }
      gm::fence_proxy_async();
      sync();
    }

    // fc_query (act0) -> head logits (rounded like a dense output) in act1
    {
      float accq[32];
      mma_query(accq, gm::smem_u32(act0), ring);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + cl;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          logits[(r0 + 8 * (e >> 1)) * (HEADS + 1) + col + (e & 1)] =
              dense_out(accq[4 * j + e], bq[col + (e & 1)]);
      }
    }
    sync();
    head_attention<bf16>(logits, hmax, hsum, att, t, kn, sync);

    // fc_value (act0), weighted by att and summed over the neighbours in f32
    {
      const float a0 = att[r0], a1 = att[r0 + 8];
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        float acc[64];
        mma_half(acc, gm::smem_u32(act0), ring);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 128 * half + 8 * j + cl;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float b = bv[col + e];
            float s = a0 * dense_out(acc[4 * j + e], b) + a1 * dense_out(acc[4 * j + 2 + e], b);
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            s += __shfl_xor_sync(0xffffffffu, s, 8);
            s += __shfl_xor_sync(0xffffffffu, s, 16);
            if (l < 4) part[w * LAT + col + e] = s;
          }
        }
      }
    }
    sync();
    if (store) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = t + WG_THREADS * h;
        const float s = part[col] + part[LAT + col] + part[2 * LAT + col] + part[3 * LAT + col];
        out[static_cast<int64_t>(cq) * LAT + col] = __float2bfloat16_rn(s);
      }
    }
    sync();
  }
}

// ---- f32 on the tensor cores: 3xTF32 ----
//
// Persistent blocks, one per SM, of two warpgroups (two queries at a time,
// one each); thread 0 also streams the weights through a ring of three
// 16 KB slices with bulk copies and mbarriers (`gmma.cuh::FedRing`: no
// producer warp, so 255 registers a thread). The weights are split into
// tf32 hi and lo once per table (`ops/decoder_tail.py::pack_tf32x3_weights`,
// 1.66 MB): a slice is the hi and the lo tile of 64 output columns x 32
// inputs, in the order the products take them (a layer's column quarters
// in order, each over its K-chunks). A query's f32 activations (64 x 256,
// 64 KB) stay in shared memory; each product runs a column quarter at a
// time (`gmma.cuh::mma_quarter_tf32x3`): per K-chunk of 32 inputs, two
// k8 steps at a time, its A fragments are loaded from there and split into
// hi and lo in registers, and 6 `wgmma` m64n64k8 tf32 products (hi x lo,
// lo x hi, hi x hi of two steps) accumulate into a fresh partial of the
// chunk, added to the quarter's total in f32. fc2 and fc3 overwrite their
// input in place: quarter 0 waits in the logits' space and quarters 1-3 in
// registers until quarter 3 has read the input; quarter 3, computed beside
// two held quarters, accumulates all of K on the tensor cores (no partials:
// its registers would spill). Each slice
// serves the block's two queries: 832 KB of L2 reads a query, about 42 GB
// a 50 048-query call.
namespace tf32 {

constexpr int STAGES = 3;
constexpr int SLICE = gm::TF32_SLICE;
// W2, W3, Wv: 8 K-chunks x 4 column quarters each; Wq: 8 K-chunks
constexpr int SLICES = 3 * 32 + 8;
constexpr int CONSUMERS = 2;
constexpr int THREADS_TF = CONSUMERS * WG_THREADS;  // thread 0 also feeds the ring
// a consumer's floats: activations, logits (before them fc2 / fc3's staged
// quarter, after them per-warp column sums), rel, ids, att, head max, head
// sum
constexpr int ACT = K * LAT;
constexpr int LOGITS = K * (HEADS + 1);
constexpr int WG_FLOATS = ACT + LOGITS + 3 * K + K + K + 2 * HEADS;
// the block's copy of W1's rel rows and the biases b2, b3, bv, bq: read from
// shared memory, they are not hoisted out of the query loop into registers
constexpr int C_W1 = 0, C_B2 = 3 * LAT, C_B3 = C_B2 + LAT, C_BV = C_B3 + LAT, C_BQ = C_BV + LAT,
              CONSTS = C_BQ + HEADS;
constexpr size_t SMEM = 1024 + STAGES * SLICE + (CONSUMERS * WG_FLOATS + CONSTS) * sizeof(float) +
                        2 * STAGES * sizeof(uint64_t);
static_assert(4 * LAT <= LOGITS && 32 * WG_THREADS <= LOGITS,
              "the per-warp column sums and the staged quarter alias the logits");

using RingTF = gm::FedRing<STAGES, SLICE>;

__global__ void __launch_bounds__(THREADS_TF, 1)
decoder_tail_tf32_kernel(const float* __restrict__ latents, const float* __restrict__ pts,
                         const float* __restrict__ queries, const int64_t* __restrict__ ids,
                         const float* __restrict__ w1, const float* __restrict__ b2,
                         const float* __restrict__ b3, const float* __restrict__ bq,
                         const float* __restrict__ bv, const unsigned char* __restrict__ wpack,
                         float* __restrict__ out, int c, int kn) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = gm::align1024(smem_raw);
  float* floats = reinterpret_cast<float*>(slots + STAGES * SLICE);
  float* consts = floats + CONSUMERS * WG_FLOATS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(consts + CONSTS);
  for (int i = threadIdx.x; i < CONSTS; i += THREADS_TF)
    consts[i] = i < C_B2 ? w1[i] : i < C_B3 ? b2[i - C_B2] : i < C_BV ? b3[i - C_B3]
              : i < C_BQ ? bv[i - C_BV] : bq[i - C_BQ];
  const int pairs = (c + CONSUMERS - 1) / CONSUMERS;
  RingTF ring;
  ring.slots = slots;
  ring.full = bars;
  ring.empty = bars + STAGES;
  // thread 0 feeds the same slices for every pair of queries of the block
  ring.src = wpack;
  ring.per_round = SLICES;
  ring.total = static_cast<int>(blockIdx.x) < pairs
                   ? (pairs - blockIdx.x + gridDim.x - 1) / gridDim.x * SLICES : 0;
  ring.producer = threadIdx.x == 0;
  if (threadIdx.x == 0) ring.init(CONSUMERS * WG_THREADS);
  __syncthreads();
  ring.start();
  const int wg = threadIdx.x / WG_THREADS;

  // consumer warpgroup `wg`: thread t, warp w, lane l
  const int t = threadIdx.x % WG_THREADS;
  const int w = t >> 5;
  const int l = t & 31;
  float* act = floats + wg * WG_FLOATS;
  float* logits = act + ACT;
  float* part = logits;  // per-warp column sums, once the logits are read
  float* rel = logits + LOGITS;
  int* nid = reinterpret_cast<int*>(rel + 3 * K);
  float* att = reinterpret_cast<float*>(nid + K);
  float* hmax = att + K;
  float* hsum = hmax + HEADS;
  auto sync = [wg] { gm::named_barrier(1 + wg, WG_THREADS); };
  const int r0 = 16 * w + (l >> 2);  // fragment rows r0 and r0 + 8
  const int cl = 2 * (l & 3);        // fragment column offset in an n8 block

  float* stage = logits;  // the first column quarter of fc2 / fc3, before its store
  // relu(total + bias) of column quarter q into act
  auto store_relu = [&](const float (&total)[32], int q, const float* __restrict__ bias) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * q + 8 * j + cl;
      const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(act + gm::act_offset(r0 + 8 * h, col)) =
            make_float2(fmaxf(total[4 * j + 2 * h] + b.x, 0.f),
                        fmaxf(total[4 * j + 2 * h + 1] + b.y, 0.f));
    }
  };

#pragma unroll 1
  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    // the second query of an odd last pair repeats the last one, unstored
    const int cq = min(CONSUMERS * pair + wg, c - 1);
    const bool store = CONSUMERS * pair + wg < c;

    // h = relu(x + rel @ W1), x the gathered projected latents; rows past
    // kn repeat neighbour 0
    if (t < K) {
      const int j = static_cast<int>(ids[static_cast<int64_t>(cq) * kn + (t < kn ? t : 0)]);
      nid[t] = j;
#pragma unroll
      for (int d = 0; d < 3; ++d) rel[t * 3 + d] = __fsub_rn(queries[3 * cq + d], pts[3 * j + d]);
    }
    sync();
    {
      const int u = t & 31;  // this thread's 32-byte unit (8 columns), every 4th row
      float wa[8], wb[8], wc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        wa[e] = consts[C_W1 + 8 * u + e];
        wb[e] = consts[C_W1 + LAT + 8 * u + e];
        wc[e] = consts[C_W1 + 2 * LAT + 8 * u + e];
      }
#pragma unroll 2
      for (int r = t >> 5; r < K; r += 4) {
        const float4* src =
            reinterpret_cast<const float4*>(latents + static_cast<int64_t>(nid[r]) * LAT + 8 * u);
        const float4 x0 = src[0], x1 = src[1];
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float* rr = rel + r * 3;
        float h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = fmaxf(x[e] + fmaf(rr[2], wc[e], fmaf(rr[1], wb[e], rr[0] * wa[e])), 0.f);
        float4* dst = reinterpret_cast<float4*>(act + gm::act_offset(r, 8 * u));
        dst[0] = make_float4(h[0], h[1], h[2], h[3]);
        dst[1] = make_float4(h[4], h[5], h[6], h[7]);
      }
    }
    sync();

    // fc2, fc3 (+relu), in place: every column quarter reads all of act,
    // so quarter 0 waits in `stage` (thread t's value i at i * 128 + t)
    // and quarters 1-3 in registers until the last has read it
#pragma unroll 1
    for (int layer = 0; layer < 2; ++layer) {
      const float* bias = consts + (layer ? C_B3 : C_B2);
      {
        float t0[32];
        gm::mma_quarter_tf32x3<8>(t0, act, ring, r0, cl);
#pragma unroll
        for (int i = 0; i < 32; ++i) stage[i * WG_THREADS + t] = t0[i];
      }
      float t1[32], t2[32], t3[32];
      gm::mma_quarter_tf32x3<8>(t1, act, ring, r0, cl);
      gm::mma_quarter_tf32x3<8>(t2, act, ring, r0, cl);
      // with two quarters held, no room for this one's partials
      gm::mma_quarter_tf32x3<8, false>(t3, act, ring, r0, cl);
      sync();  // every read of act is done
      store_relu(t1, 1, bias);
      store_relu(t2, 2, bias);
      store_relu(t3, 3, bias);
#pragma unroll
      for (int i = 0; i < 32; ++i) t1[i] = stage[i * WG_THREADS + t];
      store_relu(t1, 0, bias);
      sync();
    }

    // fc_query -> head logits
    {
      float total[32];
      gm::mma_quarter_tf32x3<8>(total, act, ring, r0, cl);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + cl;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          logits[(r0 + 8 * (e >> 1)) * (HEADS + 1) + col + (e & 1)] =
              total[4 * j + e] + consts[C_BQ + col + (e & 1)];
      }
    }
    sync();
    head_attention<float>(logits, hmax, hsum, att, t, kn, sync);

    // fc_value (+bias), a column quarter at a time, weighted by att and
    // summed over the neighbours in f32: rows r0, r0 + 8, the 8 lanes of a
    // column, then the 4 warps
    {
      const float a0 = att[r0], a1 = att[r0 + 8];
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        float total[32];
        gm::mma_quarter_tf32x3<8>(total, act, ring, r0, cl);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * q + 8 * j + cl;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float b = consts[C_BV + col + e];
            float s = a0 * (total[4 * j + e] + b) + a1 * (total[4 * j + 2 + e] + b);
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            s += __shfl_xor_sync(0xffffffffu, s, 8);
            s += __shfl_xor_sync(0xffffffffu, s, 16);
            if (l < 4) part[w * LAT + col + e] = s;
          }
        }
      }
    }
    sync();
    if (store) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = t + WG_THREADS * h;
        out[static_cast<int64_t>(cq) * LAT + col] =
            part[col] + part[LAT + col] + part[2 * LAT + col] + part[3 * LAT + col];
      }
    }
    sync();
  }
}

cudaError_t launch(const void* latents, const void* pts, const void* queries, const void* ids,
                   const void* w1, const void* b2, const void* b3, const void* bq,
                   const void* bv, const void* wpack, void* out, int c, int kn,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(decoder_tail_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  const int pairs = (c + CONSUMERS - 1) / CONSUMERS;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  decoder_tail_tf32_kernel<<<min(pairs, sms), THREADS_TF, SMEM, stream>>>(
      f(latents), f(pts), f(queries), static_cast<const int64_t*>(ids), f(w1), f(b2), f(b3),
      f(bq), f(bv), static_cast<const unsigned char*>(wpack), static_cast<float*>(out), c, kn);
  return cudaGetLastError();
}

}  // namespace tf32

// ---- L = 32 (POCO) on the tensor cores, bf16 and f32 ----
//
// One warpgroup owns one query: its 64 neighbour rows are the m64 tile of
// every product. fc2, fc3 and fc_value are m64n32 products and fc_query
// m64n64, each over K=32 with A in registers (the RS form: a product's
// output fragment, rounded and split where the build needs it, is the
// next one's A operand, `gmma.cuh`), so no activation is stored. The
// weights (the pack, plus W1's rel rows and the biases in f32) are loaded
// once per block and stay in shared memory. h1 = relu(x + rnd(rel @ W1))
// runs on the CUDA cores straight into the A fragment; the next query's 64
// gathered latent rows (4 KB in bf16, 8 KB in f32), their points and the
// query are copied with cp.async into second buffers while the current
// query computes. The per-head softmax runs on the fc_query fragments of
// all 128 threads: each exponential once, column max and sum over the 8
// row lanes by a reduce-scatter of shuffles and over the 4 warps through
// shared memory, each row's mean over heads by a quad shuffle. Persistent
// blocks of WGS warpgroups, as many blocks an SM as fit. One body serves
// both dtypes (`narrow_body`); `Build<T>` holds what differs:
//   bf16 (`decoder_tail_narrow_wgmma_kernel`): the 20 KB pack
//     (`ops/decoder_tail.py::pack_l32_weights`), each weight's transpose
//     with its K of 32 padded to 64 (only the two k16 steps of real inputs
//     are issued); A as bf16 pairs; `wgmma` m64nNk16. 3 blocks an SM at
//     its 80 registers.
//   f32 (`decoder_tail_narrow_tf32_kernel`): every product as 3xTF32
//     (`gmma.cuh::mma_regs_tf32x3`: each A value split into tf32 hi and lo
//     in registers, 12 `wgmma` m64nNk8 tf32 products over the four k8
//     steps into one f32 accumulator); the 40 KB pack
//     (`ops/decoder_tail.py::pack_l32_tf32x3`) holds the tf32 hi and lo
//     tiles of W2, W3, Wv (32 x 32) and Wq (64 x 32), inputs in
//     `TF32_K_ORDER`. The rounding steps are the identity. 2 blocks an SM
//     (shared memory), up to 128 registers.
//
// What bounds it: not its products (5 216 multiply-adds a row, 33 GFLOP
// at C=50 048: 0.034 ms on the bf16 tensor cores, 0.20 ms as 3xTF32) but
// the softmax's 4 096 exponentials and 4 096 divisions a query on the SFU,
// 16 a clock an SM: about 0.1 ms at C=50 048. The bf16 build reads about
// 9x that: the instructions around them (roundings, reductions) and their
// latency at 6 warpgroups an SM.
namespace narrow_tc {

constexpr int LAT = 32;
constexpr int WGS = 2;  // warpgroups a block, each on its own queries
constexpr int THREADS_L32 = WGS * WG_THREADS;
// f32 in shared memory: W1's three rel rows, then b2, b3, bv, bq
constexpr int F_B2 = 3 * LAT, F_B3 = F_B2 + LAT, F_BV = F_B3 + LAT, F_BQ = F_BV + LAT,
              FLOATS = F_BQ + HEADS;

using gm::cp_async16;
using gm::cp_async4;
using gm::cp_async_commit;
using gm::cp_async_wait_all;

template <typename T> struct Build;

template <> struct Build<bf16> {
  // the pack: W2, W3, Wv as (32 x 64) tiles, Wq as one (64 x 64) tile
  static constexpr int W2_AT = 0, W3_AT = 4096, WQ_AT = 8192, WV_AT = 16384, PACK = 20480;
  // the A operand of two k16 steps: a (64 x 32) fragment of values as
  // bf16 pairs
  struct Operand {
    uint32_t a[8];
  };
  static __device__ __forceinline__ void set(Operand& op, const float (&v)[16]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) op.a[i] = gm::pack_bf16x2(v[2 * i], v[2 * i + 1]);
  }
  // d (64 x N) = A (64 x 32, registers) @ the (32 x N) weight tile at b
  template <int N>
  static __device__ __forceinline__ void mma(float (&d)[N / 2], Operand& op, uint32_t b) {
    static_assert(N == 32 || N == 64, "m64n32k16 or m64n64k16");
    gm::fence_operand(d);
    gm::fence_operand(op.a);
    gm::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if constexpr (N == 32)
        gm::wgmma_m64n32k16_rs(d, op.a + 4 * kk, gm::desc_sw128(b + 32 * kk), kk);
      else
        gm::wgmma_m64n64k16_rs(d, op.a + 4 * kk, gm::desc_sw128(b + 32 * kk), kk);
    }
    gm::wgmma_commit();
    gm::wgmma_wait<0>();
    gm::fence_operand(d);
  }
};

template <> struct Build<float> {
  // the pack: the hi tile, then the lo tile, of W2, W3 (32 x 32: 4 KB
  // each), Wq (64 x 32: 8 KB each) and Wv
  static constexpr int W2_AT = 0, W3_AT = 8192, WQ_AT = 16384, WV_AT = 32768, PACK = 40960;
  // the A operand: the f32 values of a (64 x 32) fragment, split into tf32
  // hi and lo by the product
  struct Operand {
    float v[16];
  };
  static __device__ __forceinline__ void set(Operand& op, const float (&v)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) op.v[i] = v[i];
  }
  template <int N>
  static __device__ __forceinline__ void mma(float (&d)[N / 2], Operand& op, uint32_t b) {
    gm::mma_regs_tf32x3<N>(d, op.v, b);
  }
};

// a gathered latent row is stored 16 bytes longer than it is (80 bytes in
// bf16, 144 in f32), so that the 32 lanes' fragment reads (8 rows x 4
// column pairs) take the fewest wavefronts
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return LAT * static_cast<int>(sizeof(T)) + 16;
}
// a warpgroup's: two row buffers, then per-warp column maxima and sums of
// the 64 heads, two queries' per-warp partial outputs, two buffers of the
// rows' points and of the query
template <typename T>
__host__ __device__ constexpr int wg_bytes() {
  return 2 * K * row_bytes<T>() + (2 * 4 * HEADS + 2 * 4 * LAT + 2 * 3 * K + 2 * 4) * 4;
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + Build<T>::PACK + FLOATS * 4 + WGS * wg_bytes<T>();
}

// two neighbouring values as f32
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// a dense layer's epilogue (`decoder_pallas.py:22-26`): the product
// rounds to T, then its sum with the bias
template <typename T>
__device__ __forceinline__ float l32_dense(float x, float bias) {
  return rnd<T>(rnd<T>(x) + bias);
}

template <typename Op>
__device__ __forceinline__ float2 op2(float2 a, float2 b, Op op) {
  return make_float2(op(a.x, b.x), op(a.y, b.y));
}
__device__ __forceinline__ float2 shfl2(float2 v, int off) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, off),
                     __shfl_xor_sync(0xffffffffu, v.y, off));
}
// one step of a reduce-scatter over lane bit `off`: of the 2n column pairs
// v[0..2n), a lane keeps the upper n if its bit is set, the lower n if not,
// and adds its partner's copy of them
template <int N, typename Op>
__device__ __forceinline__ void scatter_step(float2* v, int l, int off, Op op) {
  const bool up = l & off;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float2 sent = up ? v[j] : v[j + N];
    const float2 kept = up ? v[j + N] : v[j];
    v[j] = op2(kept, shfl2(sent, off), op);
  }
}
// `op` over the 8 lanes that hold the same columns of 8 column pairs
// (pair j: columns 8j + cl, + 1): lane l ends with pair l / 4, in 14
// shuffles where a butterfly for each pair takes 48
template <typename Op>
__device__ __forceinline__ float2 rows_scatter8(float2 (&v)[8], int l, Op op) {
  scatter_step<4>(v, l, 16, op);
  scatter_step<2>(v, l, 8, op);
  scatter_step<1>(v, l, 4, op);
  return v[0];
}
// the same over 4 column pairs: lanes l and l ^ 4 end with pair l / 8
template <typename Op>
__device__ __forceinline__ float2 rows_scatter4(float2 (&v)[4], int l, Op op) {
  scatter_step<2>(v, l, 16, op);
  scatter_step<1>(v, l, 8, op);
  return op2(v[0], shfl2(v[0], 4), op);
}

// `op` over the 4 warps' values of a pair of columns ([4][HEADS] floats)
template <typename Op>
__device__ __forceinline__ float2 warps_reduce(const float* at, Op op) {
  float2 v[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) v[w] = *reinterpret_cast<const float2*>(at + w * HEADS);
  return make_float2(op(op(op(v[0].x, v[1].x), v[2].x), v[3].x),
                     op(op(op(v[0].y, v[1].y), v[2].y), v[3].y));
}

template <typename T>
__device__ __forceinline__ void narrow_body(unsigned char* smem_raw, const T* __restrict__ latents,
                                            const float* __restrict__ pts,
                                            const float* __restrict__ queries,
                                            const int64_t* __restrict__ ids,
                                            const T* __restrict__ w1, const float* __restrict__ b2,
                                            const float* __restrict__ b3,
                                            const float* __restrict__ bq,
                                            const float* __restrict__ bv,
                                            const unsigned char* __restrict__ wpack,
                                            T* __restrict__ out, int c, int kn) {
  using B = Build<T>;
  constexpr int ROW_BYTES = row_bytes<T>();
  constexpr int BUF = K * ROW_BYTES;
  unsigned char* wts = gm::align1024(smem_raw);
  float* fw = reinterpret_cast<float*>(wts + B::PACK);
  for (int i = threadIdx.x; i < B::PACK / 16; i += THREADS_L32)
    reinterpret_cast<uint4*>(wts)[i] = reinterpret_cast<const uint4*>(wpack)[i];
  for (int i = threadIdx.x; i < FLOATS; i += THREADS_L32)
    fw[i] = i < F_B2 ? ppsurf::Num<T>::to_f(w1[i])
          : i < F_B3 ? b2[i - F_B2]
          : i < F_BV ? b3[i - F_B3]
          : i < F_BQ ? bv[i - F_BV] : bq[i - F_BQ];
  gm::fence_proxy_async();
  __syncthreads();

  // warpgroup `wg`: thread t, warp w, lane l; its queries are wg, wg + WGS,
  // ... of this block's share
  const int wg = threadIdx.x / WG_THREADS;
  const int t = threadIdx.x % WG_THREADS;
  const int w = t >> 5;
  const int l = t & 31;
  unsigned char* rows = reinterpret_cast<unsigned char*>(fw + FLOATS) + wg * wg_bytes<T>();
  float* colmax = reinterpret_cast<float*>(rows + 2 * BUF);  // [4 warps][64 heads]
  float* colsum = colmax + 4 * HEADS;
  float* outpart = colsum + 4 * HEADS;  // [2 queries][4 warps][32 columns]
  auto sync = [wg] { gm::named_barrier(1 + wg, WG_THREADS); };
  const int r0 = 16 * w + (l >> 2);  // fragment rows r0 and r0 + 8
  const int cl = 2 * (l & 3);        // fragment column offset in an n8 block
  const uint32_t w_addr = gm::smem_u32(wts);
  const int step = gridDim.x * WGS;
  const float ninf = -__int_as_float(0x7f800000);

  // Thread t stages row t / 2 of a query (rows past kn repeat neighbour
  // 0) by cp.async: the half of its gathered latent row from column 16 (t
  // % 2) and (even t) its point; thread 1 the query. The pipeline is three
  // queries deep: the ids of query i + 2 load while query i computes, then
  // give the copies of query i + 1.
  float* ptsb = outpart + 2 * 4 * LAT;  // [2 buffers][64 rows][3]
  float* qb = ptsb + 2 * 3 * K;         // [2 buffers][4]
  const int r = t >> 1;
  constexpr int HALF = LAT / 2 * static_cast<int>(sizeof(T));  // bytes of half a row
  auto row_id = [&](int q) {
    return static_cast<int>(ids[static_cast<int64_t>(q) * kn + (r < kn ? r : 0)]);
  };
  auto copy_row = [&](int j, int q, int buf) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(latents + static_cast<int64_t>(j) * LAT) +
        HALF * (t & 1);
    unsigned char* dst = rows + buf * BUF + r * ROW_BYTES + HALF * (t & 1);
#pragma unroll
    for (int i = 0; i < HALF / 16; ++i) cp_async16(dst + 16 * i, src + 16 * i);
    if (!(t & 1)) {
#pragma unroll
      for (int d = 0; d < 3; ++d) cp_async4(ptsb + buf * 3 * K + 3 * r + d, pts + 3 * j + d);
    } else if (t == 1) {
#pragma unroll
      for (int d = 0; d < 3; ++d) cp_async4(qb + 4 * buf + d, queries + 3 * q + d);
    }
    cp_async_commit();
  };
  // the output of query `at` (none if negative) from its per-warp sums in
  // buffer `buf`
  auto store_out = [&](int at, int buf) {
    if (at >= 0 && t < LAT) {
      const float* o = outpart + buf * 4 * LAT + t;
      out[static_cast<int64_t>(at) * LAT + t] =
          ppsurf::Num<T>::from_f(o[0] + o[LAT] + o[2 * LAT] + o[3 * LAT]);
    }
  };
  int cq = blockIdx.x * WGS + wg;
  int j_next = 0;  // this thread's row id of the next query
  if (cq < c) {
    copy_row(row_id(cq), cq, 0);
    if (cq + step < c) j_next = row_id(cq + step);
  }
#pragma unroll 1
  for (int buf = 0; cq < c; cq += step, buf ^= 1) {
    cp_async_wait_all();
    // this query's rows, points and query are in, the last one's output
    // sums; every read of the other buffers is done
    sync();
    store_out(cq - step, buf ^ 1);
    const int cn = cq + step;
    if (cn < c) copy_row(j_next, cn, buf ^ 1);
    j_next = cn + step < c ? row_id(cn + step) : 0;

    // h1 = relu(x + rnd(rel @ W1)) of rows r0, r0 + 8 (value 4j + 2 rs + e:
    // row r0 + 8 rs, column 8j + cl + e), W1's three rows in f32
    typename B::Operand a;
    const bool real0 = r0 < kn, real1 = r0 + 8 < kn;
    {
      float h[16];
      const unsigned char* xb = rows + buf * BUF;
#pragma unroll
      for (int rs = 0; rs < 2; ++rs) {
        const float* pr = ptsb + buf * 3 * K + 3 * (r0 + 8 * rs);
        float rr[3];  // rel = rnd(query - point)
#pragma unroll
        for (int d = 0; d < 3; ++d) rr[d] = rnd<T>(__fsub_rn(qb[4 * buf + d], pr[d]));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = 8 * jj + cl;
          const float2 x =
              ld_pair(reinterpret_cast<const T*>(xb + (r0 + 8 * rs) * ROW_BYTES) + col);
          const float2 wa = ld_pair(fw + col), wb = ld_pair(fw + LAT + col),
                       wc = ld_pair(fw + 2 * LAT + col);
          const float rw0 = rnd<T>(fmaf(rr[2], wc.x, fmaf(rr[1], wb.x, rr[0] * wa.x)));
          const float rw1 = rnd<T>(fmaf(rr[2], wc.y, fmaf(rr[1], wb.y, rr[0] * wa.y)));
          h[4 * jj + 2 * rs] = fmaxf(rnd<T>(x.x + rw0), 0.f);
          h[4 * jj + 2 * rs + 1] = fmaxf(rnd<T>(x.y + rw1), 0.f);
        }
      }
      B::set(a, h);
    }

    // fc2, fc3 (+relu): each output fragment is the next product's A
#pragma unroll 1
    for (int layer = 0; layer < 2; ++layer) {
      float acc[16];
      B::template mma<32>(acc, a, w_addr + (layer ? B::W3_AT : B::W2_AT));
      const float* bias = fw + (layer ? F_B3 : F_B2);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const float2 b = ld_pair(bias + 8 * (i >> 2) + cl);
        acc[i] = fmaxf(l32_dense<T>(acc[i], b.x), 0.f);
        acc[i + 1] = fmaxf(l32_dense<T>(acc[i + 1], b.y), 0.f);
      }
      B::set(a, acc);
    }

    // fc_query -> the 64 head logits of rows r0, r0 + 8 (value 4j + 2 rs +
    // e: head 8j + cl + e), -inf past kn
    float q[32];
    B::template mma<64>(q, a, w_addr + B::WQ_AT);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const bool real = (i & 2) ? real1 : real0;
      const float2 b = ld_pair(fw + F_BQ + 8 * (i >> 2) + cl);
      q[i] = real ? l32_dense<T>(q[i], b.x) : ninf;
      q[i + 1] = real ? l32_dense<T>(q[i + 1], b.y) : ninf;
    }

    // per-head softmax over the 64 rows: the column max, then each
    // exponential once (kept in q), the column sum; every step rounds to
    // T, the sum accumulates in f32
    auto fmax_ = [](float x, float y) { return fmaxf(x, y); };
    auto add_ = [](float x, float y) { return x + y; };
    {
      float2 m[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        m[j] = make_float2(fmaxf(q[4 * j], q[4 * j + 2]), fmaxf(q[4 * j + 1], q[4 * j + 3]));
      *reinterpret_cast<float2*>(colmax + w * HEADS + 8 * (l >> 2) + cl) =
          rows_scatter8(m, l, fmax_);
    }
    sync();
    {
      float2 sums[8];
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        const float2 m = warps_reduce(colmax + 2 * i + cl, fmax_);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float me = e ? m.y : m.x;
          q[i + e] = real0 ? rnd<T>(expf(rnd<T>(q[i + e] - me))) : 0.f;
          q[i + 2 + e] = real1 ? rnd<T>(expf(rnd<T>(q[i + 2 + e] - me))) : 0.f;
        }
        sums[i / 4] = make_float2(q[i] + q[i + 2], q[i + 1] + q[i + 3]);
      }
      *reinterpret_cast<float2*>(colsum + w * HEADS + 8 * (l >> 2) + cl) =
          rows_scatter8(sums, l, add_);
    }
    sync();

    // each row's mean over the heads of rnd(e / s): this thread's 16
    // heads, then the quad's 64
    float att0 = 0.f, att1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const float2 s = warps_reduce(colsum + 2 * i + cl, add_);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float se = rnd<T>(e ? s.y : s.x);
        att0 += rnd<T>(q[i + e] / se);
        att1 += rnd<T>(q[i + 2 + e] / se);
      }
    }
    att0 += __shfl_xor_sync(0xffffffffu, att0, 1);
    att0 += __shfl_xor_sync(0xffffffffu, att0, 2);
    att1 += __shfl_xor_sync(0xffffffffu, att1, 1);
    att1 += __shfl_xor_sync(0xffffffffu, att1, 2);
    auto head_mean = [](float sum, bool real) {
      return real ? rnd<T>(sum / HEADS) : 0.f;
    };
    const float a0 = head_mean(att0, real0), a1 = head_mean(att1, real1);

    // fc_value (+bias), weighted by att and summed over the rows in f32:
    // rows r0, r0 + 8, the 8 lanes of a column, then (after the next
    // query's first barrier) the 4 warps
    {
      float v[16];
      B::template mma<32>(v, a, w_addr + B::WV_AT);
      float2 s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 b = ld_pair(fw + F_BV + 8 * j + cl);
        s[j].x = __fadd_rn(__fmul_rn(a0, l32_dense<T>(v[4 * j], b.x)),
                           __fmul_rn(a1, l32_dense<T>(v[4 * j + 2], b.x)));
        s[j].y = __fadd_rn(__fmul_rn(a0, l32_dense<T>(v[4 * j + 1], b.y)),
                           __fmul_rn(a1, l32_dense<T>(v[4 * j + 3], b.y)));
      }
      const float2 sum = rows_scatter4(s, l, add_);
      if (!(l & 4))
        *reinterpret_cast<float2*>(outpart + (buf * 4 + w) * LAT + 8 * (l >> 3) + cl) = sum;
    }
  }
  sync();
  store_out(cq - step, (((cq - blockIdx.x * WGS - wg) / step) & 1) ^ 1);
}

__global__ void __launch_bounds__(THREADS_L32, 3)
decoder_tail_narrow_wgmma_kernel(const bf16* __restrict__ latents, const float* __restrict__ pts,
                                 const float* __restrict__ queries,
                                 const int64_t* __restrict__ ids, const bf16* __restrict__ w1,
                                 const float* __restrict__ b2, const float* __restrict__ b3,
                                 const float* __restrict__ bq, const float* __restrict__ bv,
                                 const unsigned char* __restrict__ wpack, bf16* __restrict__ out,
                                 int c, int kn) {
  extern __shared__ unsigned char smem_raw[];
  narrow_body<bf16>(smem_raw, latents, pts, queries, ids, w1, b2, b3, bq, bv, wpack, out, c, kn);
}

__global__ void __launch_bounds__(THREADS_L32, 2)
decoder_tail_narrow_tf32_kernel(const float* __restrict__ latents, const float* __restrict__ pts,
                                const float* __restrict__ queries,
                                const int64_t* __restrict__ ids, const float* __restrict__ w1,
                                const float* __restrict__ b2, const float* __restrict__ b3,
                                const float* __restrict__ bq, const float* __restrict__ bv,
                                const unsigned char* __restrict__ wpack, float* __restrict__ out,
                                int c, int kn) {
  extern __shared__ unsigned char smem_raw[];
  narrow_body<float>(smem_raw, latents, pts, queries, ids, w1, b2, b3, bq, bv, wpack, out, c, kn);
}

template <typename T>
auto kernel_of() {
  if constexpr (std::is_same_v<T, bf16>)
    return decoder_tail_narrow_wgmma_kernel;
  else
    return decoder_tail_narrow_tf32_kernel;
}

// blocks an SM and the grid of a call over c queries; the kernel's
// attributes and occupancy are set and read once per device
template <typename T>
cudaError_t grid(int c, int* per_sm, int* blocks) {
  static int cached_device = -1, cached_per_sm = 0, cached_sms = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != cached_device) {
    if ((err = cudaFuncSetAttribute(kernel_of<T>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem_bytes<T>()))) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &cached_per_sm, kernel_of<T>(), THREADS_L32, smem_bytes<T>())) != cudaSuccess)
      return err;
    cached_device = device;
  }
  *per_sm = cached_per_sm;
  *blocks = min((c + WGS - 1) / WGS, max(cached_per_sm, 1) * cached_sms);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* latents, const void* pts, const void* queries, const void* ids,
                   const void* w1, const void* b2, const void* b3, const void* bq,
                   const void* bv, const void* wpack, void* out, int c, int kn,
                   cudaStream_t stream) {
  int per_sm = 0, blocks = 0;
  cudaError_t err = grid<T>(c, &per_sm, &blocks);
  if (err != cudaSuccess) return err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto kernel = kernel_of<T>();
  kernel<<<blocks, THREADS_L32, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(latents), f(pts), f(queries), static_cast<const int64_t*>(ids),
      static_cast<const T*>(w1), f(b2), f(b3), f(bq), f(bv),
      static_cast<const unsigned char*>(wpack), static_cast<T*>(out), c, kn);
  return cudaGetLastError();
}

// the weight bytes a launch of `blocks` blocks loads by design: every
// block its pack, W1's rel rows and the biases once
template <typename T>
long long weight_bytes(int blocks) {
  return static_cast<long long>(blocks) *
         (Build<T>::PACK + 3 * LAT * static_cast<int>(sizeof(T)) + (FLOATS - F_B2) * 4);
}

}  // namespace narrow_tc

cudaError_t launch_bf16(const void* latents, const void* pts, const void* queries,
                        const void* ids, const void* w1, const void* b2,
                        const void* b3, const void* bq, const void* bv,
                        const void* wpack, void* out, int c, int kn, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decoder_tail_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(WG_SMEM));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  const int pairs = (c + CONSUMERS - 1) / CONSUMERS;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  decoder_tail_wgmma_kernel<<<min(pairs, sms), THREADS_WG, WG_SMEM, stream>>>(
      static_cast<const bf16*>(latents), f(pts), f(queries),
      static_cast<const int64_t*>(ids), static_cast<const bf16*>(w1), f(b2), f(b3),
      f(bq), f(bv), static_cast<const unsigned char*>(wpack), static_cast<bf16*>(out), c, kn);
  return cudaGetLastError();
}

}  // namespace

// latent 256 (PPSurf) or 32 (POCO), 64 heads, 1 <= k <= 64 neighbours a
// query; every call needs the weight pack of its latent and dtype (w2, w3,
// wq and wv are read from it)
extern "C" int ppsurf_decoder_tail(const void* latents, const void* pts,
                                   const void* queries, const void* ids,
                                   const void* w1, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, const void* wq,
                                   const void* bq, const void* wv,
                                   const void* bv, const void* wpack, void* out,
                                   int c, int k, int latent, int heads,
                                   int is_bf16, void* stream) {
  if (k < 1 || k > K || (latent != LAT && latent != narrow_tc::LAT) || heads != HEADS || c < 0 ||
      !wpack)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (latent == narrow_tc::LAT) {
    if (is_bf16)
      return narrow_tc::launch<bf16>(latents, pts, queries, ids, w1, b2, b3, bq, bv, wpack, out,
                                     c, k, s);
    return narrow_tc::launch<float>(latents, pts, queries, ids, w1, b2, b3, bq, bv, wpack, out,
                                    c, k, s);
  }
  if (is_bf16)
    return launch_bf16(latents, pts, queries, ids, w1, b2, b3, bq, bv, wpack, out, c, k, s);
  return tf32::launch(latents, pts, queries, ids, w1, b2, b3, bq, bv, wpack, out, c, k, s);
}

// the latent-32 build's launch for c queries (bf16 or f32): out[0] 1 (no
// cluster), out[1] its blocks an SM, out[2] the grid's blocks, out[3] the
// weight bytes a launch streams by design (every block loads them once): a
// count from the constants, not a measurement
extern "C" int ppsurf_decoder_tail_l32_info(int c, int is_bf16, long long* out) {
  int per_sm = 0, blocks = 0;
  const cudaError_t err = is_bf16 ? narrow_tc::grid<bf16>(c, &per_sm, &blocks)
                                  : narrow_tc::grid<float>(c, &per_sm, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = 1;
  out[1] = per_sm;
  out[2] = blocks;
  out[3] = is_bf16 ? narrow_tc::weight_bytes<bf16>(blocks) : narrow_tc::weight_bytes<float>(blocks);
  return 0;
}
