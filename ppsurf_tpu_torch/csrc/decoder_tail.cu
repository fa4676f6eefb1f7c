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
// f32 (`decoder_tail_kernel<float>`): one block of 256 threads a query,
// every product as f32 FMA on the CUDA cores. It stays there: TF32 tensor
// cores keep 10 mantissa bits and would miss the f32 limit (1e-4 x scale)
// that the f32 field is held to.
//
// latent 32, f32 and bf16 (`decoder_tail_narrow_kernel`, POCO): one thread
// a neighbour row with its activations in registers; see `namespace
// narrow` below.
#include "common.cuh"
#include "gmma.cuh"

namespace {

using ppsurf::block_dense;
using ppsurf::block_matmul;
using ppsurf::Num;
using ppsurf::rnd;
using ppsurf::ROWS;
using ppsurf::THREADS;

constexpr int K = 64;       // neighbours per query (= ROWS)
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

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * ROWS * LAT          // activations
         + sizeof(float) * ROWS * (HEADS + 1)  // head logits (padded)
         + sizeof(float) * 8 * LAT       // row-group partial sums
         + sizeof(float) * (ROWS + 2 * HEADS)  // att, head max, head sum
         + sizeof(float) * ROWS * 3      // rel
         + sizeof(int) * ROWS;           // neighbour ids
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decoder_tail_kernel(const T* __restrict__ latents, const float* __restrict__ pts,
                    const float* __restrict__ queries,
                    const int64_t* __restrict__ ids, const T* __restrict__ w1,
                    const T* __restrict__ w2, const float* __restrict__ b2,
                    const T* __restrict__ w3, const float* __restrict__ b3,
                    const T* __restrict__ wq, const float* __restrict__ bq,
                    const T* __restrict__ wv, const float* __restrict__ bv,
                    T* __restrict__ out, int kn) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* h = reinterpret_cast<T*>(smem);
  float* logits = reinterpret_cast<float*>(h + ROWS * LAT);
  float* part = logits + ROWS * (HEADS + 1);
  float* att = part + 8 * LAT;
  float* hmax = att + ROWS;
  float* hsum = hmax + HEADS;
  float* rel = hsum + HEADS;
  int* nid = reinterpret_cast<int*>(rel + ROWS * 3);

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < K) {
    // rows past kn repeat neighbour 0 and get attention weight 0
    const int j = static_cast<int>(ids[(int64_t)c * kn + (tid < kn ? tid : 0)]);
    nid[tid] = j;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      rel[tid * 3 + d] = rnd<T>(__fsub_rn(queries[3 * c + d], pts[3 * j + d]));
  }
  __syncthreads();

  // h = relu(x + rnd(rel @ W1)), x the gathered projected latents
  {
    const int r0 = (tid >> 5) * 8;
    const int c0 = (tid & 31) * 8;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = c0 + jj;
      const float wa = Num<T>::to_f(w1[col]);
      const float wb = Num<T>::to_f(w1[LAT + col]);
      const float wc = Num<T>::to_f(w1[2 * LAT + col]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + i;
        const float* rr = rel + r * 3;
        const float rw = rnd<T>(fmaf(rr[2], wc, fmaf(rr[1], wb, rr[0] * wa)));
        const float x = Num<T>::to_f(latents[(int64_t)nid[r] * LAT + col]);
        h[r * LAT + col] = Num<T>::from_f(fmaxf(rnd<T>(x + rw), 0.f));
      }
    }
  }
  __syncthreads();

  // fc2, fc3 (+relu), in place; the biases are the aff rows
  block_dense<T, LAT>(h, LAT, LAT, w2, b2, LAT, false, true, h, LAT);
  block_dense<T, LAT>(h, LAT, LAT, w3, b3, LAT, false, true, h, LAT);

  // fc_query -> head logits (rounded like a dense output)
  {
    float acc[8][HEADS / 32];
    block_matmul<T, HEADS>(h, LAT, LAT, wq, acc);
    const int r0 = (tid >> 5) * 8;
    const int c0 = (tid & 31) * (HEADS / 32);
#pragma unroll
    for (int j = 0; j < HEADS / 32; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        logits[(r0 + i) * (HEADS + 1) + c0 + j] =
            rnd<T>(rnd<T>(acc[i][j]) + bq[c0 + j]);
  }
  __syncthreads();

  head_attention<T>(logits, hmax, hsum, att, tid, kn, [] { __syncthreads(); });

  // fc_value, weighted by att and summed over the neighbours in f32
  {
    float acc[8][LAT / 32];
    block_matmul<T, LAT>(h, LAT, LAT, wv, acc);
    const int wg = tid >> 5;
    const int r0 = wg * 8;
    const int c0 = (tid & 31) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = bv[c0 + j];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += att[r0 + i] * rnd<T>(rnd<T>(acc[i][j]) + b);
      part[wg * LAT + c0 + j] = s;
    }
  }
  __syncthreads();
  {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) s += part[g * LAT + tid];
    out[(int64_t)c * LAT + tid] = Num<T>::from_f(s);
  }
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

// ---- L = 32 (POCO): one thread a neighbour row on the CUDA cores ----
//
// Each group of 64 threads takes one query at a time (persistent blocks of
// four groups, a named barrier per group); thread r holds row r's 32
// activations in registers and runs every product of its row as f32 FMA
// with the weights, kept once per block in shared memory as f32, read as
// broadcast float4. fc_query's 64 logits of a row go to shared memory for
// `head_attention`; the attention-weighted values are summed over the rows
// in f32 by one thread a column. Both dtypes share the kernel: in bf16 the
// products are f32 FMA too and each output rounds where the plain version
// rounds.
namespace narrow {

constexpr int LAT = 32;
constexpr int GROUPS = 4;                 // queries in flight a block
constexpr int THREADS_NARROW = GROUPS * K;   // one thread a neighbour row
// f32 weights: w1 (3 x 32), w2, w3 (32 x 32), wq (32 x 64), wv (32 x 32),
// then the biases b2, b3 (32), bq (64), bv (32)
constexpr int W1 = 0, W2 = W1 + 3 * LAT, W3 = W2 + LAT * LAT, WQ = W3 + LAT * LAT,
              WV = WQ + LAT * HEADS, B2 = WV + LAT * LAT, B3 = B2 + LAT, BQ = B3 + LAT,
              BV = BQ + HEADS, WFLOATS = BV + LAT;
// a group's floats: logits (64 x 65, later the weighted values), head
// max, head sum, att
constexpr int GFLOATS = K * (HEADS + 1) + 3 * K;
constexpr size_t SMEM = sizeof(float) * (WFLOATS + GROUPS * GFLOATS);

// out[0:N] = in[0:32] @ W[32][N] (W row-major, f32 in shared memory), each
// output accumulated in f32 over the inputs in order
template <int N>
__device__ __forceinline__ void row_matmul(const float (&in)[LAT], const float* w,
                                           float (&out)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < LAT; ++kk) {
    const float4* row = reinterpret_cast<const float4*>(w + kk * N);
#pragma unroll
    for (int j4 = 0; j4 < N / 4; ++j4) {
      const float4 v = row[j4];
      out[4 * j4] = fmaf(in[kk], v.x, out[4 * j4]);
      out[4 * j4 + 1] = fmaf(in[kk], v.y, out[4 * j4 + 1]);
      out[4 * j4 + 2] = fmaf(in[kk], v.z, out[4 * j4 + 2]);
      out[4 * j4 + 3] = fmaf(in[kk], v.w, out[4 * j4 + 3]);
    }
  }
}

// a dense layer's epilogue (`decoder_pallas.py:22-26`): the product rounds
// to T, then its sum with the bias; relu optional
template <typename T>
__device__ __forceinline__ void dense_epilogue(float (&acc)[LAT], const float* b, bool relu) {
#pragma unroll
  for (int j = 0; j < LAT; ++j) {
    const float y = rnd<T>(rnd<T>(acc[j]) + b[j]);
    acc[j] = relu ? fmaxf(y, 0.f) : y;
  }
}

template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ src, float (&x)[LAT]) {
  constexpr int PER = 16 / sizeof(T);  // elements a 16-byte load
#pragma unroll
  for (int u = 0; u < LAT / PER; ++u) {
    const uint4 raw = reinterpret_cast<const uint4*>(src)[u];
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < PER; ++e) x[u * PER + e] = Num<T>::to_f(v[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS_NARROW)
decoder_tail_narrow_kernel(const T* __restrict__ latents, const float* __restrict__ pts,
                        const float* __restrict__ queries,
                        const int64_t* __restrict__ ids, const T* __restrict__ w1,
                        const T* __restrict__ w2, const float* __restrict__ b2,
                        const T* __restrict__ w3, const float* __restrict__ b3,
                        const T* __restrict__ wq, const float* __restrict__ bq,
                        const T* __restrict__ wv, const float* __restrict__ bv,
                        T* __restrict__ out, int c, int kn) {
  extern __shared__ __align__(16) float fsm[];
  float* w = fsm;
  for (int i = threadIdx.x; i < WFLOATS; i += THREADS_NARROW) {
    float v;
    if (i < W2) v = Num<T>::to_f(w1[i - W1]);
    else if (i < W3) v = Num<T>::to_f(w2[i - W2]);
    else if (i < WQ) v = Num<T>::to_f(w3[i - W3]);
    else if (i < WV) v = Num<T>::to_f(wq[i - WQ]);
    else if (i < B2) v = Num<T>::to_f(wv[i - WV]);
    else if (i < B3) v = b2[i - B2];
    else if (i < BQ) v = b3[i - B3];
    else if (i < BV) v = bq[i - BQ];
    else v = bv[i - BV];
    w[i] = v;
  }
  __syncthreads();

  const int g = threadIdx.x / K;
  const int r = threadIdx.x % K;
  float* logits = fsm + WFLOATS + g * GFLOATS;
  float* hmax = logits + K * (HEADS + 1);
  float* hsum = hmax + K;
  float* att = hsum + K;
  auto sync = [g] { ppsurf::gmma::named_barrier(1 + g, K); };

#pragma unroll 1
  for (int cq = blockIdx.x * GROUPS + g; cq < c; cq += gridDim.x * GROUPS) {
    // h = relu(x + rnd(rel @ W1)); rows past kn repeat neighbour 0
    const int j = static_cast<int>(ids[static_cast<int64_t>(cq) * kn + (r < kn ? r : 0)]);
    float rel[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) rel[d] = rnd<T>(__fsub_rn(queries[3 * cq + d], pts[3 * j + d]));
    float h[LAT];
    load_row<T>(latents + static_cast<int64_t>(j) * LAT, h);
#pragma unroll
    for (int col = 0; col < LAT; ++col) {
      const float rw = rnd<T>(fmaf(rel[2], w[W1 + 2 * LAT + col],
                                   fmaf(rel[1], w[W1 + LAT + col], rel[0] * w[W1 + col])));
      h[col] = fmaxf(rnd<T>(h[col] + rw), 0.f);
    }

    // fc2, fc3 (+relu)
    float y[LAT];
    row_matmul<LAT>(h, w + W2, y);
    dense_epilogue<T>(y, w + B2, true);
    row_matmul<LAT>(y, w + W3, h);
    dense_epilogue<T>(h, w + B3, true);

    // fc_query -> this row's 64 head logits
    {
      float q[HEADS];
      row_matmul<HEADS>(h, w + WQ, q);
#pragma unroll
      for (int hh = 0; hh < HEADS; ++hh)
        logits[r * (HEADS + 1) + hh] = rnd<T>(rnd<T>(q[hh]) + w[BQ + hh]);
    }
    sync();
    head_attention<T>(logits, hmax, hsum, att, r, kn, sync);

    // fc_value, weighted by att; the rows summed in f32 by column
    row_matmul<LAT>(h, w + WV, y);
    dense_epilogue<T>(y, w + BV, false);
    const float a = att[r];
#pragma unroll
    for (int col = 0; col < LAT; ++col) logits[r * (LAT + 1) + col] = a * y[col];
    sync();
    if (r < LAT) {
      float s = 0.f;
      for (int rr = 0; rr < K; ++rr) s += logits[rr * (LAT + 1) + r];
      out[static_cast<int64_t>(cq) * LAT + r] = Num<T>::from_f(s);
    }
    sync();
  }
}

template <typename T>
cudaError_t launch(const void* latents, const void* pts, const void* queries,
                   const void* ids, const void* w1, const void* w2, const void* b2,
                   const void* w3, const void* b3, const void* wq, const void* bq,
                   const void* wv, const void* bv, void* out, int c, int kn,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(decoder_tail_narrow_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, decoder_tail_narrow_kernel<T>, THREADS_NARROW, SMEM)) != cudaSuccess)
    return err;
  const int blocks = min((c + GROUPS - 1) / GROUPS, max(per_sm, 1) * sms);
  auto t = [](const void* p) { return static_cast<const T*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  decoder_tail_narrow_kernel<T><<<blocks, THREADS_NARROW, SMEM, stream>>>(
      t(latents), f(pts), f(queries), static_cast<const int64_t*>(ids), t(w1), t(w2),
      f(b2), t(w3), f(b3), t(wq), f(bq), t(wv), f(bv), static_cast<T*>(out), c, kn);
  return cudaGetLastError();
}

}  // namespace narrow

cudaError_t launch_f32(const void* latents, const void* pts, const void* queries,
                       const void* ids, const void* w1, const void* w2,
                       const void* b2, const void* w3, const void* b3,
                       const void* wq, const void* bq, const void* wv,
                       const void* bv, void* out, int c, int kn, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<float>();
  cudaError_t err = cudaFuncSetAttribute(
      decoder_tail_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  decoder_tail_kernel<float><<<c, THREADS, bytes, stream>>>(
      f(latents), f(pts), f(queries), static_cast<const int64_t*>(ids), f(w1),
      f(w2), f(b2), f(w3), f(b3), f(wq), f(bq), f(wv), f(bv),
      static_cast<float*>(out), kn);
  return cudaGetLastError();
}

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
// query; a bf16 call at latent 256 needs the weight pack
extern "C" int ppsurf_decoder_tail(const void* latents, const void* pts,
                                   const void* queries, const void* ids,
                                   const void* w1, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, const void* wq,
                                   const void* bq, const void* wv,
                                   const void* bv, const void* wpack, void* out,
                                   int c, int k, int latent, int heads,
                                   int is_bf16, void* stream) {
  if (k < 1 || k > K || (latent != LAT && latent != narrow::LAT) || heads != HEADS || c < 0 ||
      (is_bf16 && latent == LAT && !wpack))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (latent == narrow::LAT) {
    if (is_bf16)
      return narrow::launch<bf16>(latents, pts, queries, ids, w1, w2, b2, w3, b3, wq, bq, wv,
                               bv, out, c, k, s);
    return narrow::launch<float>(latents, pts, queries, ids, w1, w2, b2, w3, b3, wq, bq, wv, bv,
                              out, c, k, s);
  }
  if (is_bf16)
    return launch_bf16(latents, pts, queries, ids, w1, b2, b3, bq, bv, wpack, out, c, k, s);
  return launch_f32(latents, pts, queries, ids, w1, w2, b2, w3, b3, wq, bq, wv, bv,
                    out, c, k, s);
}
