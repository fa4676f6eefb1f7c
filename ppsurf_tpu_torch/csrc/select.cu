// K2: positions of the k smallest of kc candidate distances per query, and
// T1: the selection-pass microbenchmark built on the same warp layout.
//
// K2 replaces the TPU kernel `_topk_rows_kernel`
// (ppsurf_tpu/ops/knn_pallas.py:269); T1 replaces the `make_kernel`
// variants of tools/microbench_extract.py:30. Design and bounds: see
// ppsurf_tpu_torch/ops/topk_rows.py and
// ppsurf_tpu_torch/tools/microbench_extract.py.
//
// One warp per row. Lane l holds the entries at positions l, l+32, l+64,
// ... in registers as order-preserving 32-bit words (torch.sort's order:
// -0 == +0, NaN last); a position follows from where its word sits. The
// k smallest (word, position) keys are selected without k rounds:
//   1. W, the word of the k-th key: a warp binary search between the
//      row's least and greatest word, counting the words at or below the
//      midpoint with one redux.sync a step, stopping early where the
//      count is exactly k;
//   2. ties at W: of the words equal to W, the first (k - #words below W)
//      in position order are kept (a ballot prefix, positions ascending);
//   3. the k kept keys are compacted into the warp's shared buffer in
//      ballot (position) order;
//   4. each kept key's rank is the number of kept keys below it, and its
//      position is written to output slot rank.
// No value is reserved: padding past the row is the all-ones word at a
// position above every entry, so it sorts after every key, NaN included.
#include "common.cuh"
#include "gmma.cuh"

namespace {

namespace gm = ppsurf::gmma;

constexpr int WARPS = 8;       // rows (K2) or persistent warps (T1) a block
constexpr int K_MAX = 256;     // kept keys a warp buffers: K2's kc, T1 full's k
constexpr uint32_t PAD = ~0u;  // the word of a position past the row
constexpr unsigned FULL_MASK = 0xffffffffu;

// Order-preserving word of a float: negatives flipped, positives offset,
// -0 as +0 and every NaN last, so unsigned order is torch.sort's order.
__device__ __forceinline__ uint32_t order_word(float v) {
  const uint32_t u = __float_as_uint(v);
  if (v != v) return PAD;
  if (v == 0.f) return 0x80000000u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float of a word (the inverse of order_word on every non-NaN value
// but -0, which comes back as +0).
__device__ __forceinline__ float word_float(uint32_t w) {
  return __uint_as_float((w & 0x80000000u) ? (w & 0x7fffffffu) : ~w);
}

template <bool MAX>
__device__ __forceinline__ uint32_t pick2(uint32_t a, uint32_t b) {
  return MAX ? max(a, b) : min(a, b);
}
template <bool MAX>
__device__ __forceinline__ uint32_t pick3(uint32_t a, uint32_t b, uint32_t c) {
  return MAX ? __vimax3_u32(a, b, c) : __vimin3_u32(a, b, c);
}

// The least / greatest of a lane's N words: A independent chains of
// three-input min / max (Hopper's DPX instructions), each starting from a
// seed, the identity XOR z, then one chain over the A partial results.
// z is 0; T1 passes a zero the compiler cannot see, so that no pass is
// loop-invariant, at the cost of one instruction.
template <int N, bool MAX>
__device__ __forceinline__ uint32_t lane_extreme(const uint32_t (&u)[N], uint32_t z = 0) {
  constexpr int A = N < 16 ? (N + 1) / 2 : 8;
  const uint32_t seed = (MAX ? 0u : ~0u) ^ z;
  uint32_t m[A];
#pragma unroll
  for (int e = 0; e < A; ++e)
    m[e] = e + A < N ? pick3<MAX>(seed, u[e], u[e + A]) : pick2<MAX>(seed, u[e]);
#pragma unroll
  for (int j = 2 * A; j < N; j += 2 * A)
#pragma unroll
    for (int e = 0; e < A; ++e) {
      if (j + A + e < N) m[e] = pick3<MAX>(m[e], u[j + e], u[j + A + e]);
      else if (j + e < N) m[e] = pick2<MAX>(m[e], u[j + e]);
    }
  uint32_t r = m[0];
#pragma unroll
  for (int e = 1; e + 1 < A; e += 2) r = pick3<MAX>(r, m[e], m[e + 1]);
  if constexpr (A % 2 == 0) r = pick2<MAX>(r, m[A - 1]);
  return r;
}

// Steps 1-4 above for one warp's row: w[j] is the word of position
// lane + 32 j (PAD past the row), 1 <= k <= min(row length, K_MAX); `buf`
// holds K_MAX keys; out[rank] = position for rank < k.
template <int PER, typename T>
__device__ __forceinline__ void select_k(const uint32_t (&w)[PER], int k, uint64_t* buf,
                                         T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const unsigned lower_lanes = (1u << lane) - 1u;

  // 1. the least word W with at least k words at or below it
  uint32_t lo = __reduce_min_sync(FULL_MASK, lane_extreme<PER, false>(w));
  uint32_t hi = __reduce_max_sync(FULL_MASK, lane_extreme<PER, true>(w));
  while (lo < hi) {  // uniform over the warp
    const uint32_t mid = lo + ((hi - lo) >> 1);
    int n = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j) n += w[j] <= mid;
    n = __reduce_add_sync(FULL_MASK, n);
    if (n == k) {  // the words at or below mid are exactly the k kept
      lo = mid;
      break;
    }
    if (n > k) hi = mid;
    else lo = mid + 1;
  }

  // 2-3. keep the words below W and the first `need` words at W in
  // position order; compact them in ballot order
  int below = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) below += w[j] < lo;
  int need = k - __reduce_add_sync(FULL_MASK, below);
  int base = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const bool at = w[j] == lo;
    const unsigned tied = __ballot_sync(FULL_MASK, at);
    const bool keep = w[j] < lo || (at && __popc(tied & lower_lanes) < need);
    need -= __popc(tied);
    const unsigned kept = __ballot_sync(FULL_MASK, keep);
    if (keep)
      buf[base + __popc(kept & lower_lanes)] =
          (static_cast<uint64_t>(w[j]) << 32) | static_cast<uint32_t>(lane + 32 * j);
    base += __popc(kept);
  }
  __syncwarp();

  // 4. rank the k kept keys (distinct: their positions differ)
  for (int i0 = 0; i0 < k; i0 += 32) {  // uniform over the warp
    const int i = i0 + lane;
    const uint64_t key = i < k ? buf[i] : ~0ull;
    int r = 0;
#pragma unroll 4
    for (int j = 0; j < k; ++j) r += buf[j] < key;
    if (i < k) out[r] = static_cast<T>(static_cast<uint32_t>(key));
  }
  __syncwarp();  // every lane has read the buffer before it is refilled
}

// ---- K2. Rows of kc <= 256 floats (768 bytes at kc = 192) are read by
// coalesced 128-byte warp loads; a block of 8 warps holds 16 KB of key
// buffers and few registers, so many warps stay resident and the next
// rows' loads overlap the current rows' selection.
template <int PER>
__global__ void __launch_bounds__(32 * WARPS)
topk_rows_kernel(const float* __restrict__ d2, int64_t* __restrict__ out, int c, int kc,
                 int k) {
  __shared__ uint64_t keys[WARPS][K_MAX];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= c) return;  // uniform over the warp
  const float* r = d2 + static_cast<int64_t>(row) * kc;
  uint32_t w[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int pos = lane + 32 * j;
    w[j] = pos < kc ? order_word(r[pos]) : PAD;
  }
  select_k<PER, int64_t>(w, k, keys[threadIdx.x >> 5],
                         out + static_cast<int64_t>(row) * k);
}

template <int PER>
cudaError_t launch_topk(const float* d2, int64_t* out, int c, int kc, int k,
                        cudaStream_t stream) {
  const int blocks = (c + WARPS - 1) / WARPS;
  topk_rows_kernel<PER><<<blocks, 32 * WARPS, 0, stream>>>(d2, out, c, kc, k);
  return cudaGetLastError();
}

// ---- T1: k passes of stripped-down selection bodies over a (q, ncand)
// slab, 48 entries a lane (ncand <= 1536), each variant keeping part of
// the pass; lane 0 writes out[row, i] at pass i. Persistent warps, each
// with its own shared row buffer and mbarrier: a warp copies its row from
// the buffer into registers, then one lane starts the 1-D bulk copy of
// its next row into the buffer, so that copy runs while the warp's passes
// run on the registers. `full` runs K2's selection once over the row
// instead of k passes.
enum Variant { NOOP, ELEMENTWISE, SUM_ONLY, MIN_ONLY, MIN_ARGMIN, MIN_MASK, FULL };
constexpr int EXTRACT_PER = 48;
constexpr float BIG = 4e12f;  // the TPU tool's mask value

// bytes a warp's slice of shared memory holds: its row, and for `full` its
// key buffer; the block's WARPS mbarriers come first
__host__ __device__ constexpr int extract_warp_bytes(int ld, int v) {
  return ld * 4 + (v == FULL ? K_MAX * 8 : 0);
}
constexpr int EXTRACT_BARS = 16 * ((WARPS * 8 + 15) / 16);

// k passes of variant V over the row in x (floats) / u (words). `zero` is
// 0, but the compiler cannot know it: z = i & zero enters the first
// operations of every pass whose inputs do not change from pass to pass
// (sum_only, min_only, min_argmin), so that no pass is hoisted out of the
// loop; elementwise and min_mask change their entries every pass.
template <int V>
__device__ __forceinline__ void passes(float (&x)[EXTRACT_PER], uint32_t (&u)[EXTRACT_PER],
                                       int ncand, uint32_t zero, int k,
                                       float* __restrict__ o) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int i = 0; i < k; ++i) {
    const uint32_t z = static_cast<uint32_t>(i) & zero;
    float val = 0.f;
    if constexpr (V == ELEMENTWISE) {
      val = x[0];
#pragma unroll
      for (int j = 0; j < EXTRACT_PER; ++j) x[j] = x[j] + 1.f;
    } else if constexpr (V == SUM_ONLY) {
      // four lane sums over all 48 entries (0 past the row), of j = 0, 1,
      // 2, 3 (mod 4) taken in turn, added in pairs, then the butterfly
      // (the plain version repeats this order)
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = __uint_as_float(__float_as_uint(x[e]) ^ z);
#pragma unroll
      for (int j = 4; j < EXTRACT_PER; ++j) s[j % 4] = s[j % 4] + x[j];
      float t = (s[0] + s[1]) + (s[2] + s[3]);
#pragma unroll
      for (int off = 16; off; off >>= 1) t = t + __shfl_xor_sync(FULL_MASK, t, off);
      val = t;
    } else if constexpr (V >= MIN_ONLY) {
      const uint32_t m = __reduce_min_sync(
          FULL_MASK, lane_extreme<EXTRACT_PER, false>(u, V == MIN_MASK ? 0u : z));
      val = word_float(m);
      if constexpr (V == MIN_ARGMIN) {
        // one scan for the lane's lowest j at the minimum, one reduction
        // for the warp's lowest position
        int jm = EXTRACT_PER;
#pragma unroll
        for (int j = EXTRACT_PER - 1; j >= 0; --j)
          if (u[j] == m) jm = j;
        val = static_cast<float>(__reduce_min_sync(FULL_MASK, lane + 32 * jm));
      } else if constexpr (V == MIN_MASK) {
        const uint32_t big = order_word(BIG);
#pragma unroll
        for (int j = 0; j < EXTRACT_PER; ++j) u[j] = u[j] <= m ? big : u[j];
      }
    }
    if (lane == 0) o[i] = val;
  }
  if constexpr (V == NOOP || V == ELEMENTWISE) {
    // A store the data cannot trigger (a sum's NaN is always 0x7fffffff):
    // it keeps every entry, and what each pass did to it, live where no
    // output reads it.
    float keep = 0.f;
#pragma unroll
    for (int j = 0; j < EXTRACT_PER; ++j) keep = keep + x[j];
    if (__float_as_uint(keep) == 0xffffffffu) o[0] = keep;
  }
}

template <int V>
__global__ void __launch_bounds__(32 * WARPS)
extract_kernel(const float* __restrict__ cand, float* __restrict__ out, int q,
               int ncand, int ld, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = gridDim.x * WARPS;
  int row = blockIdx.x * WARPS + warp;
  if (row >= q) return;  // uniform over the warp; no block barrier follows
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + warp;
  float* buf = reinterpret_cast<float*>(smem + EXTRACT_BARS +
                                        warp * extract_warp_bytes(ld, V));
  const uint32_t bytes = ld * 4;
  if (lane == 0) {
    gm::mbar_init(bar, 1);
    gm::mbar_fence_init();
    gm::mbar_arrive_expect_tx(bar, bytes);
    gm::bulk_copy_g2s(buf, cand + static_cast<int64_t>(row) * ld, bytes, bar);
  }
  __syncwarp();
  const uint32_t zero = static_cast<uint32_t>(ncand) >> 16;  // ncand <= 1536
  // padding past the row: 0 adds nothing to a sum; the words take PAD
  const float pad = V == SUM_ONLY ? 0.f : __int_as_float(0x7f800000);
  uint32_t phase = 0;
  for (; row < q; row += nwarps) {
    gm::mbar_wait(bar, phase);
    phase ^= 1;
    float x[EXTRACT_PER];
    uint32_t u[EXTRACT_PER];  // the words, for the min variants and `full`
#pragma unroll
    for (int j = 0; j < EXTRACT_PER; ++j) {
      const int pos = lane + 32 * j;
      x[j] = pos < ncand ? buf[pos] : pad;
      if constexpr (V >= MIN_ONLY) u[j] = pos < ncand ? order_word(x[j]) : PAD;
    }
    __syncwarp();  // every lane has read the buffer
    const int next = row + nwarps;
    if (lane == 0 && next < q) {
      gm::fence_proxy_async();
      gm::mbar_arrive_expect_tx(bar, bytes);
      gm::bulk_copy_g2s(buf, cand + static_cast<int64_t>(next) * ld, bytes, bar);
    }
    float* o = out + static_cast<int64_t>(row) * k;
    if constexpr (V == FULL)
      select_k<EXTRACT_PER, float>(u, k, reinterpret_cast<uint64_t*>(buf + ld), o);
    else
      passes<V>(x, u, ncand, zero, k, o);
  }
}

template <int V>
cudaError_t launch_extract(const float* cand, float* out, int q, int ncand, int ld,
                           int k, cudaStream_t stream) {
  // the shared memory and grid of the last launch on this device, kept so
  // that a launch of the same shape makes no further runtime queries
  static int set_device = -1, set_bytes = 0, resident = 0;
  const int bytes = EXTRACT_BARS + WARPS * extract_warp_bytes(ld, V);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != set_device || bytes != set_bytes) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(extract_kernel<V>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, extract_kernel<V>,
                                                             32 * WARPS, bytes)) !=
            cudaSuccess)
      return err;
    set_device = device;
    set_bytes = bytes;
    resident = (per_sm > 1 ? per_sm : 1) * sms;
  }
  const int blocks = (q + WARPS - 1) / WARPS < resident ? (q + WARPS - 1) / WARPS : resident;
  extract_kernel<V><<<blocks, 32 * WARPS, bytes, stream>>>(cand, out, q, ncand, ld, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ppsurf_topk_rows(const void* d2, void* out, int c, int kc, int k,
                                void* stream) {
  auto x = static_cast<const float*>(d2);
  auto o = static_cast<int64_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kc || kc > K_MAX) return static_cast<int>(cudaErrorInvalidValue);
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

// cand: q rows of ncand floats, each row padded to ld = ncand rounded up to
// a multiple of 4 floats, 16-byte aligned (the bulk copy's rule)
extern "C" int ppsurf_extract(const void* cand, void* out, int q, int ncand,
                              int k, int variant, void* stream) {
  auto x = static_cast<const float*>(cand);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int ld = (ncand + 3) / 4 * 4;
  if (k < 1 || ncand < 1 || ncand > 32 * EXTRACT_PER ||
      (variant == FULL && (k > ncand || k > K_MAX)) ||
      reinterpret_cast<uintptr_t>(cand) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case NOOP: return launch_extract<NOOP>(x, o, q, ncand, ld, k, s);
    case ELEMENTWISE: return launch_extract<ELEMENTWISE>(x, o, q, ncand, ld, k, s);
    case SUM_ONLY: return launch_extract<SUM_ONLY>(x, o, q, ncand, ld, k, s);
    case MIN_ONLY: return launch_extract<MIN_ONLY>(x, o, q, ncand, ld, k, s);
    case MIN_ARGMIN: return launch_extract<MIN_ARGMIN>(x, o, q, ncand, ld, k, s);
    case MIN_MASK: return launch_extract<MIN_MASK>(x, o, q, ncand, ld, k, s);
    case FULL: return launch_extract<FULL>(x, o, q, ncand, ld, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
