// K1: exact k-nearest-neighbour ids, nearest first.
//
// Replaces the TPU kernel `_knn_kernel` (ppsurf_tpu/ops/knn_pallas.py:48).
// Design and bounds: see ppsurf_tpu_torch/ops/knn.py. The wrapper hands in
// the cloud in Morton blocks of B points (x, y, z, original id) and each
// block's box. One warp per query:
//   1. seed: take blocks in increasing box lower bound until they hold k
//      points; the k-th smallest (distance, id) key among them is tau;
//   2. filter: visit, outward from the first seed block in Morton order,
//      only the blocks whose lower bound is not above tau's distance;
//      lanes test 32 points at a time and append keys below tau to the
//      warp's buffer in shared memory (ballot + popc);
//   3. a full buffer is cut to its k smallest keys, found by a warp binary
//      search for the k-th key (tau tightens to it); the final k keys are
//      ranked: key i goes to output slot rank(i).
// A key is (distance bits << 32 | id): distances are >= 0, so the unsigned
// order is the order of (distance, id), a stable sort of the distances.
#include "common.cuh"

namespace {

constexpr int B = 64;       // points per Morton block (= KNN_BLOCK in knn.py)
constexpr int WARPS = 4;    // queries per block of threads
constexpr uint64_t NONE = ~0ull;
// keys below this have a finite distance; invalid points carry NaN
// coordinates, whose distance bits (>= 0x7fc00000) lie above it
constexpr uint64_t INF_KEY = 0x7f800000ull << 32;

__device__ __forceinline__ float dist2(float px, float py, float pz, float qx,
                                       float qy, float qz) {
  // rounded, non-fused operations: the plain version's exact arithmetic
  const float dx = __fsub_rn(px, qx);
  const float dy = __fsub_rn(py, qy);
  const float dz = __fsub_rn(pz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The least d2 of any point in the box [lo, hi]: the query clamped into the
// box, in dist2's arithmetic. Rounding is monotone, so it never exceeds a
// contained point's dist2; an empty box (lo = +inf, hi = -inf) gives +inf.
__device__ __forceinline__ float box_lb(const float4* __restrict__ boxes, int b,
                                        float qx, float qy, float qz) {
  const float4 lo = boxes[2 * b];
  const float4 hi = boxes[2 * b + 1];
  return dist2(fminf(fmaxf(qx, lo.x), hi.x), fminf(fmaxf(qy, lo.y), hi.y),
               fminf(fmaxf(qz, lo.z), hi.z), qx, qy, qz);
}

__device__ __forceinline__ uint64_t warp_min(uint64_t x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const uint64_t y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// rank[i] = number of buffered keys below key[i], key[i] = buf[lane + 32 i]
// (NONE, of rank >= count, past count). Keys are distinct, so ranks are too.
template <int PER>
__device__ __forceinline__ void rank_keys(const uint64_t* buf, int count,
                                          uint64_t (&key)[PER], int (&rank)[PER]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    key[i] = lane + 32 * i < count ? buf[lane + 32 * i] : NONE;
    rank[i] = count;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (32 * i < count) {  // uniform over the warp
      int r = 0;
#pragma unroll 4
      for (int j = 0; j < count; ++j) r += buf[j] < key[i] ? 1 : 0;
      rank[i] = r;
    }
  }
}

template <int KMAX>
struct Query {
  static constexpr int CAP = 2 * KMAX + B;  // buffered keys a warp holds
  static constexpr int PER = CAP / 32;

  uint64_t* buf;
  int count;
  uint64_t tau;  // keys below tau are candidates
  float qx, qy, qz;
  int k;

  // Keep the k smallest keys, unsorted (count >= k on entry); tau becomes
  // the k-th: the least distance word D with k keys at or below it, then,
  // among the keys at D, the id that completes k.
  __device__ __forceinline__ void cut() {
    const int lane = threadIdx.x & 31;
    uint64_t key[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) key[i] = lane + 32 * i < count ? buf[lane + 32 * i] : NONE;
    uint32_t lo = 0, hi = static_cast<uint32_t>(tau >> 32);  // every key lies below tau
    while (lo < hi) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      int n = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i) n += static_cast<uint32_t>(key[i] >> 32) <= mid;
      if (__reduce_add_sync(0xffffffffu, n) >= k) hi = mid;
      else lo = mid + 1;
    }
    int below = 0, at = 0;
    uint32_t top = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const uint32_t d = static_cast<uint32_t>(key[i] >> 32);
      below += d < lo;
      at += d == lo;
      if (d == lo) top = max(top, static_cast<uint32_t>(key[i]));
    }
    below = __reduce_add_sync(0xffffffffu, below);
    at = __reduce_add_sync(0xffffffffu, at);
    uint32_t id = __reduce_max_sync(0xffffffffu, top);
    if (below + at > k) {  // ties at D: the (k - below)-th smallest id among them
      uint32_t ilo = 0;
      while (ilo < id) {
        const uint32_t mid = ilo + ((id - ilo) >> 1);
        int n = 0;
#pragma unroll
        for (int i = 0; i < PER; ++i)
          n += static_cast<uint32_t>(key[i] >> 32) == lo && static_cast<uint32_t>(key[i]) <= mid;
        if (below + __reduce_add_sync(0xffffffffu, n) >= k) id = mid;
        else ilo = mid + 1;
      }
    }
    const uint64_t kth = (static_cast<uint64_t>(lo) << 32) | id;
    __syncwarp();  // every lane has read the buffer
    int base = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const bool keep = key[i] <= kth;
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) buf[base + __popc(m & ((1u << lane) - 1u))] = key[i];
      base += __popc(m);
    }
    __syncwarp();
    count = k;
    tau = kth;
  }

  // Append the candidates of every block of [start, start + 32) whose lower
  // bound is not above tau's distance, nearest to the seed block first.
  __device__ __forceinline__ void visit_group(const float4* __restrict__ pts,
                                              const float4* __restrict__ boxes,
                                              int nb, int start, bool down,
                                              uint64_t floor_key) {
    const int lane = threadIdx.x & 31;
    const int b = start + lane;
    float lb = 0.f;
    bool visit = false;
    if (b >= 0 && b < nb) {
      lb = box_lb(boxes, b, qx, qy, qz);
      const uint64_t key = (static_cast<uint64_t>(__float_as_uint(lb)) << 32) | b;
      visit = key >= floor_key && lb < __int_as_float(0x7f800000) &&
              lb <= __uint_as_float(static_cast<uint32_t>(tau >> 32));
    }
    unsigned m = __ballot_sync(0xffffffffu, visit);
    while (m) {
      const int src = down ? 31 - __clz(m) : __ffs(m) - 1;
      m &= ~(1u << src);
      const float lbb = __shfl_sync(0xffffffffu, lb, src);
      // tau may have tightened since the ballot
      if (lbb <= __uint_as_float(static_cast<uint32_t>(tau >> 32)))
        append_block(pts, start + src);
    }
  }

  __device__ __forceinline__ void append_block(const float4* __restrict__ pts,
                                               int b) {
    if (count + B > CAP) cut();  // count > 2 KMAX >= k here
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int h = 0; h < B / 32; ++h) {
      const float4 p = pts[b * B + 32 * h + lane];
      const float d = dist2(p.x, p.y, p.z, qx, qy, qz);
      const uint64_t key = (static_cast<uint64_t>(__float_as_uint(d)) << 32) |
                           static_cast<uint32_t>(__float_as_int(p.w));
      const bool take = key < tau;
      const unsigned m = __ballot_sync(0xffffffffu, take);
      if (take) buf[count + __popc(m & ((1u << lane) - 1u))] = key;
      count += __popc(m);
    }
    __syncwarp();
  }
};

template <int KMAX>
__global__ void __launch_bounds__(32 * WARPS, 4)
knn_kernel(const float4* __restrict__ pts, const float4* __restrict__ boxes,
           const float* __restrict__ q, int64_t* __restrict__ out, int nb,
           int nq, int k) {
  using Qy = Query<KMAX>;
  __shared__ uint64_t buffers[WARPS][Qy::CAP];
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (qi >= nq) return;  // uniform over the warp
  Qy s;
  s.buf = buffers[threadIdx.x >> 5];
  s.count = 0;
  s.tau = INF_KEY;
  s.qx = q[3 * qi];
  s.qy = q[3 * qi + 1];
  s.qz = q[3 * qi + 2];
  s.k = k;
  const float inf = __int_as_float(0x7f800000);

  // 1. seed: blocks by increasing (lower bound, block) key until they
  // hold k candidates; blocks with keys below `floor_key` are done
  uint64_t floor_key = 0;
  int first = -1;  // the seed's nearest block
  while (s.count < k) {
    uint64_t best = NONE;
    for (int b = lane; b < nb; b += 32) {
      const float lb = box_lb(boxes, b, s.qx, s.qy, s.qz);
      const uint64_t key = (static_cast<uint64_t>(__float_as_uint(lb)) << 32) | b;
      if (lb < inf && key >= floor_key && key < best) best = key;
    }
    best = warp_min(best);
    if (best == NONE) break;  // every point is buffered
    floor_key = best + 1;
    const int b = static_cast<int>(static_cast<uint32_t>(best));
    if (first < 0) first = b;
    s.append_block(pts, b);
  }
  if (s.count >= k) s.cut();  // tau is the k-th key

  // 2. filter: every other block whose lower bound is not above tau's
  // distance (an equal distance with a lower id can still win), in groups
  // of 32 outward from the first seed block, so tau tightens early
  if (first >= 0) {
    for (int j = 0; first + 32 * j < nb || first - 32 * j > 0; ++j) {
      s.visit_group(pts, boxes, nb, first + 32 * j, false, floor_key);
      s.visit_group(pts, boxes, nb, first - 32 * (j + 1), true, floor_key);
    }
  }
  if (s.count > k) s.cut();

  // 3. rank the k (or fewer) keys: the key of rank r is output slot r
  constexpr int PER_K = KMAX / 32;  // count <= k <= KMAX here
  uint64_t key[PER_K];
  int rank[PER_K];
  rank_keys<PER_K>(s.buf, s.count, key, rank);
  int64_t* o = out + static_cast<int64_t>(qi) * k;
#pragma unroll
  for (int i = 0; i < PER_K; ++i)
    if (rank[i] < k) o[rank[i]] = static_cast<int32_t>(static_cast<uint32_t>(key[i]));
  for (int r = s.count + lane; r < k; r += 32) o[r] = -1;
}

template <int KMAX>
cudaError_t launch(const float4* pts, const float4* boxes, const float* q,
                   int64_t* out, int nb, int nq, int k, cudaStream_t stream) {
  const int blocks = (nq + WARPS - 1) / WARPS;
  knn_kernel<KMAX><<<blocks, 32 * WARPS, 0, stream>>>(pts, boxes, q, out, nb, nq, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ppsurf_knn(const void* pts, const void* boxes, const void* q,
                          void* out, int nb, int nq, int k, int block,
                          void* stream) {
  auto p = static_cast<const float4*>(pts);
  auto bx = static_cast<const float4*>(boxes);
  auto qq = static_cast<const float*>(q);
  auto o = static_cast<int64_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 256 || nb < 1 || block != B)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 32) return launch<32>(p, bx, qq, o, nb, nq, k, s);
  if (k <= 64) return launch<64>(p, bx, qq, o, nb, nq, k, s);
  if (k <= 128) return launch<128>(p, bx, qq, o, nb, nq, k, s);
  return launch<256>(p, bx, qq, o, nb, nq, k, s);
}

extern "C" const char* ppsurf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
