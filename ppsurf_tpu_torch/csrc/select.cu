// K2: positions of the k smallest of kc candidate distances per query, and
// T1: the selection-pass microbenchmark built on the same warp layout.
//
// K2 replaces the TPU kernel `_topk_rows_kernel`
// (ppsurf_tpu/ops/knn_pallas.py:269); T1 replaces the `make_kernel`
// variants of tools/microbench_extract.py:30. Design and bounds: see
// ppsurf_tpu_torch/ops/topk_rows.py and
// ppsurf_tpu_torch/tools/microbench_extract.py.
//
// One warp per query row. Lane l holds the entries at positions l, l+32,
// l+64, ... in registers, each packed with its position into one 64-bit key
// whose unsigned order is torch.sort's order on (value, position). A round
// takes the lane's smallest key, reduces it across the warp with a
// __shfl_xor_sync butterfly (every lane ends with the winner), and the lane
// that holds the winner marks that key taken (all ones, which no
// (value, position) key can equal), so no value range is reserved.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;  // query rows per block of 256 threads
constexpr uint64_t TAKEN = ~0ull;

// (value, position) -> key. The value's bits are mapped to an unsigned
// order in the high word: negatives flipped, positives offset, -0 as +0,
// every NaN last (torch.sort's order); the position breaks ties.
__device__ __forceinline__ uint64_t pack(float v, int pos) {
  uint32_t u = __float_as_uint(v);
  if (v != v)
    u = 0xffffffffu;
  else if (v == 0.f)
    u = 0x80000000u;
  else
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(pos);
}

__device__ __forceinline__ uint64_t warp_min(uint64_t x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const uint64_t y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// One selection round over a lane's keys: the warp's smallest key, taken
// out of the lane that held it.
template <int PER>
__device__ __forceinline__ uint64_t pick(uint64_t (&key)[PER]) {
  uint64_t best = key[0];
#pragma unroll
  for (int j = 1; j < PER; ++j) best = key[j] < best ? key[j] : best;
  best = warp_min(best);
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (key[j] == best) key[j] = TAKEN;
  return best;
}

template <int PER>
__device__ __forceinline__ void load_keys(const float* __restrict__ row, int n,
                                          uint64_t (&key)[PER]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int pos = lane + 32 * j;
    key[j] = pos < n ? pack(row[pos], pos) : TAKEN;
  }
}

template <int PER>
__global__ void __launch_bounds__(32 * WARPS)
topk_rows_kernel(const float* __restrict__ d2, int64_t* __restrict__ out,
                 int c, int kc, int k) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= c) return;  // uniform over the warp
  uint64_t key[PER];
  load_keys<PER>(d2 + static_cast<int64_t>(row) * kc, kc, key);
  int64_t* o = out + static_cast<int64_t>(row) * k;
  for (int i = 0; i < k; ++i) {
    const uint64_t best = pick<PER>(key);
    if ((threadIdx.x & 31) == 0) o[i] = static_cast<uint32_t>(best);
  }
}

template <int PER>
cudaError_t launch_topk(const float* d2, int64_t* out, int c, int kc, int k,
                        cudaStream_t stream) {
  const int blocks = (c + WARPS - 1) / WARPS;
  topk_rows_kernel<PER><<<blocks, 32 * WARPS, 0, stream>>>(d2, out, c, kc, k);
  return cudaGetLastError();
}

// ---- T1: k passes of stripped-down selection bodies over a (q, ncand)
// slab held in registers, 48 entries a lane (ncand <= 1536). Each variant
// keeps part of K2's pass; lane 0 writes out[row, i] at pass i.
enum Variant { NOOP, ELEMENTWISE, SUM_ONLY, MIN_ONLY, MIN_ARGMIN, MIN_MASK, FULL };
constexpr int EXTRACT_PER = 48;
constexpr float BIG = 4e12f;  // the TPU tool's mask value

// An empty asm that claims to change x: each pass's work is redone
// instead of hoisted out of the loop.
__device__ __forceinline__ void touch(float& x) { asm volatile("" : "+f"(x)); }

template <int V>
__global__ void __launch_bounds__(32 * WARPS, 1)
extract_kernel(const float* __restrict__ cand, float* __restrict__ out, int q,
               int ncand, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= q) return;
  const float* r = cand + static_cast<int64_t>(row) * ncand;
  float* o = out + static_cast<int64_t>(row) * k;
  if constexpr (V == FULL) {
    uint64_t key[EXTRACT_PER];
    load_keys<EXTRACT_PER>(r, ncand, key);
    for (int i = 0; i < k; ++i) {
      const uint64_t best = pick<EXTRACT_PER>(key);
      if (lane == 0) o[i] = static_cast<float>(static_cast<uint32_t>(best));
    }
  } else {
    const int per = (ncand + 31) / 32;  // entries a lane holds
    // padding: +inf sorts after every finite entry, 0 adds nothing
    const float pad = V == SUM_ONLY ? 0.f : __int_as_float(0x7f800000);
    float x[EXTRACT_PER];
#pragma unroll
    for (int j = 0; j < EXTRACT_PER; ++j) {
      const int pos = lane + 32 * j;
      x[j] = pos < ncand ? r[pos] : pad;
    }
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int j = 0; j < EXTRACT_PER; ++j) touch(x[j]);
      float val = 0.f;
      if constexpr (V == ELEMENTWISE) {
        val = x[0];
#pragma unroll
        for (int j = 0; j < EXTRACT_PER; ++j) x[j] = x[j] + 1.f;
      } else if constexpr (V == SUM_ONLY) {
        // lane sum in position order, then the butterfly (the plain
        // version repeats this order)
        float s = x[0];
#pragma unroll
        for (int j = 1; j < EXTRACT_PER; ++j)
          if (j < per) s = s + x[j];
#pragma unroll
        for (int off = 16; off; off >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, off);
        val = s;
      } else if constexpr (V == MIN_ONLY || V == MIN_ARGMIN || V == MIN_MASK) {
        float m = x[0];
#pragma unroll
        for (int j = 1; j < EXTRACT_PER; ++j) m = fminf(m, x[j]);
#pragma unroll
        for (int off = 16; off; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
        val = m;
        if constexpr (V == MIN_ARGMIN) {
          int pos = ncand;
#pragma unroll
          for (int j = EXTRACT_PER - 1; j >= 0; --j)
            if (x[j] <= m) pos = lane + 32 * j;
          pos = pos < ncand ? pos : ncand;
#pragma unroll
          for (int off = 16; off; off >>= 1) pos = min(pos, __shfl_xor_sync(0xffffffffu, pos, off));
          val = static_cast<float>(pos);
        } else if constexpr (V == MIN_MASK) {
#pragma unroll
          for (int j = 0; j < EXTRACT_PER; ++j) x[j] = x[j] <= m ? BIG : x[j];
        }
      }
      if (lane == 0) o[i] = val;
    }
    // A store the data cannot trigger (a sum's NaN is always 0x7fffffff):
    // it keeps every entry, and what each pass did to it, live where no
    // output reads it (noop, elementwise).
    float keep = 0.f;
#pragma unroll
    for (int j = 0; j < EXTRACT_PER; ++j) keep = keep + x[j];
    if (__float_as_uint(keep) == 0xffffffffu) o[0] = keep;
  }
}

template <int V>
cudaError_t launch_extract(const float* cand, float* out, int q, int ncand,
                           int k, cudaStream_t stream) {
  const int blocks = (q + WARPS - 1) / WARPS;
  extract_kernel<V><<<blocks, 32 * WARPS, 0, stream>>>(cand, out, q, ncand, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ppsurf_topk_rows(const void* d2, void* out, int c, int kc, int k,
                                void* stream) {
  auto x = static_cast<const float*>(d2);
  auto o = static_cast<int64_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kc || kc > 256) return static_cast<int>(cudaErrorInvalidValue);
  switch ((kc + 31) / 32) {
    case 1: return launch_topk<1>(x, o, c, kc, k, s);
    case 2: return launch_topk<2>(x, o, c, kc, k, s);
    case 3: return launch_topk<3>(x, o, c, kc, k, s);
    case 4: return launch_topk<4>(x, o, c, kc, k, s);
    case 5: return launch_topk<5>(x, o, c, kc, k, s);
    case 6: return launch_topk<6>(x, o, c, kc, k, s);
    case 7: return launch_topk<7>(x, o, c, kc, k, s);
    default: return launch_topk<8>(x, o, c, kc, k, s);
  }
}

extern "C" int ppsurf_extract(const void* cand, void* out, int q, int ncand,
                              int k, int variant, void* stream) {
  auto x = static_cast<const float*>(cand);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (k < 1 || ncand < 1 || ncand > 32 * EXTRACT_PER || (variant == FULL && k > ncand))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case NOOP: return launch_extract<NOOP>(x, o, q, ncand, k, s);
    case ELEMENTWISE: return launch_extract<ELEMENTWISE>(x, o, q, ncand, k, s);
    case SUM_ONLY: return launch_extract<SUM_ONLY>(x, o, q, ncand, k, s);
    case MIN_ONLY: return launch_extract<MIN_ONLY>(x, o, q, ncand, k, s);
    case MIN_ARGMIN: return launch_extract<MIN_ARGMIN>(x, o, q, ncand, k, s);
    case MIN_MASK: return launch_extract<MIN_MASK>(x, o, q, ncand, k, s);
    case FULL: return launch_extract<FULL>(x, o, q, ncand, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
