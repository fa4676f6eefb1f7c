// W1: generalized winding numbers of Q queries against F triangles.
//
// For query q and triangle (A, B, C), with a = A - q, b = B - q, c = C - q,
// the triangle's solid angle is (Van Oosterom-Strackee)
//   omega = 2 atan2(a . (b x c), |a||b||c| + (a.b)|c| + (b.c)|a| + (c.a)|b|)
// and the winding number is sum(omega) / (4 pi): about 1 inside a closed
// surface and 0 outside. The JAX package computes it as a jitted XLA
// reduction (`ppsurf_tpu/metrics/winding.py:23-80`); this is its CUDA form.
//
// One thread per query. A block of W_THREADS queries walks a contiguous
// range of the faces (grid.y splits the face axis, so that small query
// counts still fill the card), staging W_TILE faces at a time in shared
// memory, where every lane of a warp reads the same face (a broadcast).
// A thread sums the solid angles of a staged tile in f32, then adds that
// tile sum to its running f32 total; the split's total goes to
// partial[split][query]. A second kernel adds the splits in split order
// and divides by 4 pi. No atomics: the result depends only on the inputs
// and the split count. Full-precision sqrtf and atan2f (no fast math):
// a degenerate triangle or a query on a vertex gives atan2(+-0, +0) = 0.
#include "common.cuh"

namespace {

constexpr int W_THREADS = 128;
constexpr int W_TILE = 256;  // faces in shared memory at a time

// A face packed as 3 float4: (ax ay az bx) (by bz cx cy) (cz 0 0 0)
__global__ void __launch_bounds__(W_THREADS)
winding_kernel(const float* __restrict__ q, const float* __restrict__ ta,
               const float* __restrict__ tb, const float* __restrict__ tc,
               float* __restrict__ partial, int nq, int nf, int per_split) {
  __shared__ float4 tile[W_TILE * 3];
  float* flat = reinterpret_cast<float*>(tile);
  const int qi = blockIdx.x * W_THREADS + threadIdx.x;
  const int f0 = blockIdx.y * per_split;
  const int f1 = min(nf, f0 + per_split);
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < nq) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  float total = 0.f;
  for (int base = f0; base < f1; base += W_TILE) {
    const int n = min(W_TILE, f1 - base);
    __syncthreads();  // the previous tile is read by every thread
    for (int i = threadIdx.x; i < n * 9; i += W_THREADS) {
      const int f = i / 9, c = i - 9 * (i / 9);
      const float* src = c < 3 ? ta : (c < 6 ? tb : tc);
      flat[f * 12 + c] = src[3 * (base + f) + c % 3];
    }
    __syncthreads();
    float sum = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 p0 = tile[3 * j], p1 = tile[3 * j + 1], p2 = tile[3 * j + 2];
      const float ax = p0.x - qx, ay = p0.y - qy, az = p0.z - qz;
      const float bx = p0.w - qx, by = p1.x - qy, bz = p1.y - qz;
      const float cx = p1.z - qx, cy = p1.w - qy, cz = p2.x - qz;
      const float la = sqrtf(ax * ax + ay * ay + az * az);
      const float lb = sqrtf(bx * bx + by * by + bz * bz);
      const float lc = sqrtf(cx * cx + cy * cy + cz * cz);
      const float crx = by * cz - bz * cy;
      const float cry = bz * cx - bx * cz;
      const float crz = bx * cy - by * cx;
      const float num = ax * crx + ay * cry + az * crz;
      const float den = la * lb * lc + (ax * bx + ay * by + az * bz) * lc +
                        (bx * cx + by * cy + bz * cz) * la +
                        (cx * ax + cy * ay + cz * az) * lb;
      sum += atan2f(num, den);
    }
    total += 2.f * sum;
  }
  if (qi < nq) partial[static_cast<size_t>(blockIdx.y) * nq + qi] = total;
}

__global__ void winding_sum_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int nq, int splits) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[static_cast<size_t>(s) * nq + qi];
  out[qi] = acc / 12.566370614359172f;  // 4 pi, rounded to f32
}

}  // namespace

// queries (nq, 3), tri_a/b/c (nf, 3) f32; partial (splits, nq) f32
// workspace; out (nq,) f32. The faces are cut into `splits` ranges of
// whole W_TILE tiles.
extern "C" int ppsurf_winding(const void* queries, const void* tri_a, const void* tri_b,
                              const void* tri_c, void* partial, void* out, int nq, int nf,
                              int splits, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (nq < 0 || nf < 0 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  const int tiles = (nf + W_TILE - 1) / W_TILE;
  if (splits > (tiles > 0 ? tiles : 1)) return static_cast<int>(cudaErrorInvalidValue);
  const int per_split = (tiles + splits - 1) / splits * W_TILE;
  const dim3 grid((nq + W_THREADS - 1) / W_THREADS, splits);
  winding_kernel<<<grid, W_THREADS, 0, s>>>(
      static_cast<const float*>(queries), static_cast<const float*>(tri_a),
      static_cast<const float*>(tri_b), static_cast<const float*>(tri_c),
      static_cast<float*>(partial), nq, nf, per_split);
  winding_sum_kernel<<<(nq + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                       static_cast<float*>(out), nq, splits);
  return static_cast<int>(cudaGetLastError());
}
