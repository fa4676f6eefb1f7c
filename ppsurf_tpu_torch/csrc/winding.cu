// W1: generalized winding numbers of Q queries against F triangles.
//
// For query q and triangle (A, B, C), with a = A - q, b = B - q, c = C - q
// and the face normal N = (B - A) x (C - A), the triangle's solid angle is
// (Van Oosterom-Strackee)
//   omega = 2 atan2(a . N, |a||b||c| + (a.b)|c| + (b.c)|a| + (c.a)|b|)
// (a . N = a . (b x c) exactly in real arithmetic: the signed volume about
// q), and the winding number is sum(omega) / (4 pi): about 1 inside a closed
// surface and 0 outside. The JAX package computes it as a jitted XLA
// reduction (`ppsurf_tpu/metrics/winding.py:23-80`); this is its CUDA form.
//
// What bounds it on an H100: issued instructions. The bytes are a few MB;
// each (query, face) pair is a chain of f32 operations, three square roots
// and an arctangent, 6.5e10 pairs at the metrics' shape. The design cuts
// what a pair issues:
// - the faces come packed by the wrapper (`ops/winding.py::pack_faces`),
//   three float4 a face, (A, Nx) (B, Ny) (C, Nz), N rounded once from
//   float64, zero-padded to whole tiles: the numerator is three FMAs with
//   no cross product, and a
//   padding face adds exactly 0 (N = 0 gives a numerator of +-0 over a
//   positive denominator, or +-0 over +0 for a query at the origin);
// - the numerator is v . N with v the difference vector of the face vertex
//   nearest the query (a . N = b . N = c . N in real arithmetic): v . N
//   rounds by about eps |v||N|, which shrinks as the query nears that
//   vertex, as the true numerator does (a . N alone lost the quadrant a
//   1e-4 edge from B or C). The three numerators are formed and the
//   nearest vertex's kept: scalar selects cost less than selecting the
//   vector. A query on a vertex takes that vertex's zero vector, so its
//   numerator is exactly +-0 over a denominator of +0, as the plain
//   version's a . (b x c) is, and the pair adds 0;
// - two kinds of pair next to a face lose accuracy in f32: within f32
//   rounding of its plane, inside it, where the numerator's sign alone
//   picks +pi or -pi (a wrong sign costs a whole turn), and near an edge,
//   where numerator and denominator both cancel. The general path takes
//   them in float64 (`repair_terms`); the fast path's vote keeps them out
//   of the fast path at two FMULs (|a||b||c|) and one FFMA a pair;
// - a block of W_THREADS threads, W_QUERIES queries each, walks a
//   contiguous range of face tiles (grid.y splits the face axis), staged
//   W_TILE faces at a time into a W_STAGES-deep shared-memory ring by 1-D
//   bulk copies on mbarriers, so neither the copy's address arithmetic nor
//   its latency sits in the pair loop; every lane of a warp reads the same
//   face (broadcast), and each face read serves W_QUERIES pairs;
// - the lengths are `sqrt.approx` (one MUFU.SQRT each: sqrt(0) = 0, so a
//   query on a vertex needs no guard there), the arctangent an approximate
//   reciprocal and a minimax polynomial (`atan_poly`, relative error bounded
//   down to 0, not absolute: W1 sums up to a million terms);
// - the pair's differences a, b, c stay in the loop: expanding |a|^2, the
//   dot products or a . N into products of query and face terms would
//   cancel near the surface, where the inside test matters most.
// The arctangent has two paths. A face for which every pair of the warp has
// |num| + W1_EDGE |a||b||c| < den (a solid angle under pi/2 and no edge
// close: all but faces next to a query)
// takes atan(num / den) = r P(r^2) directly, fused into the tile sum; any
// other face takes the full quadrant logic (`add_atan2`) for the whole
// warp. The branch is warp-uniform, and where both apply they give the same
// bits, so a query's result does not depend on the queries beside it.
//
// A thread sums a tile's arctangents in f32, then adds that tile sum to its
// running total; the split's total goes to partial[split][query]. A second
// kernel adds the splits in split order in f64 and divides by 2 pi (the sum
// holds omega / 2). No atomics: the result depends only on the inputs and
// the split count.
#include "common.cuh"
#include "gmma.cuh"

namespace {

namespace gm = ppsurf::gmma;

constexpr int W_THREADS = 128;
constexpr int W_QUERIES = 4;   // queries a thread
constexpr int W_TILE = 128;    // faces a ring stage
constexpr int W_STAGES = 4;
constexpr uint32_t W_TILE_BYTES = W_TILE * 3 * sizeof(float4);
constexpr float W_FLT_MIN = 1.17549435e-38f;
constexpr float W_HALF_PI = 1.57079637f;
constexpr float W_PI = 3.14159274f;

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// within 1 ulp; x below FLT_MIN counts as 0 (.ftz)
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// atan(r) / r for |r| <= 1 as a polynomial in s = r^2: minimax in the
// relative error with the leading coefficient fixed at 1. Evaluated in f32
// with FMAs, r P(r^2) is within 3.0e-7 of atan(r) relative (4.5e-7 with the
// reciprocal 1 ulp off, as far as `rcp.approx` may be); `add_atan2` holds
// that bound in every quadrant. Mirrored in `ops/winding.py::ATAN_COEFFS`, which the
// CPU tests hold to this text and to the bound.
__device__ __forceinline__ float atan_poly(float s) {
  // BEGIN W1 ATAN COEFFS
  constexpr float c[] = {
      1.0f, -0.33332393f, 0.19974214f, -0.14041328f, 0.09968473f, -0.06020313f,
      0.024734065f,
      -0.004822535f,
  };
  // END W1 ATAN COEFFS
  constexpr int n = sizeof(c) / sizeof(c[0]);
  float p = c[n - 1];
#pragma unroll
  for (int i = n - 2; i >= 0; --i) p = fmaf(p, s, c[i]);
  return p;
}

// sum + atan2(n, d) for finite n, d with |n|, |d| < 2^126. The smaller of
// |n|, |d| over the larger is r in [0, 1]; the quadrant turns t = r P(r^2)
// into t, pi / 2 -+ t or pi - t, and n gives the sign: the result is
// fma(s r', P, sum + s base) with s the sign of n, so that where |n| < d
// (base 0) it is the fast path's fma(n / d, P, sum) to the bit. At
// sum = -0 it is atan2(n, d) within the bound above, with IEEE's signed
// zeros: atan2(+-0, +0) = +-0, atan2(+-0, -0 or -x) = +-pi,
// atan2(n, +-0) = +-pi / 2.
__device__ __forceinline__ float add_atan2(float sum, float n, float d) {
  const float an = fabsf(n), ad = fabsf(d);
  const bool swap = an > ad;
  // the vertex guard: a query on a vertex gives n = d = 0, and 0 / 0
  // would be NaN; hi >= FLT_MIN makes r = 0 there
  const float hi = fmaxf(fmaxf(an, ad), W_FLT_MIN);
  const float r = fminf(an, ad) * rcp_approx(hi);
  const float p = atan_poly(r * r);
  const bool neg = signbit(d);
  const float sr = swap != neg ? -r : r;
  const float base = swap ? W_HALF_PI : (neg ? W_PI : 0.f);
  const uint32_t sign = __float_as_uint(n) & 0x80000000u;
  return fmaf(__uint_as_float(__float_as_uint(sr) ^ sign), p,
              sum + __uint_as_float(__float_as_uint(base) ^ sign));
}

// The general path's float64 repairs. Two kinds of pair lose accuracy in
// f32, and both lie next to the face, where the fast path never goes:
// - Near the face's plane, inside the face, d < 0 and the sign of n alone
//   picks +pi or -pi. With N rounded once from its float64 value
//   (`pack_faces`: |N_i - N*_i| <= u |N*_i|, u = eps / 2 = 2^-24, N* the
//   exact normal of the f32 vertices), v_i = fl(P_i - q_i) within u |v*_i|
//   and the three FMAs of v . N adding at most 3 roundings, the numerator
//   against n* = (A - q) . ((B - q) x (C - q)) of the f32 inputs is
//     |n - n*| <= (gamma_3 + gamma_2 (1 + 2u)) sum |v_i||N_i|
//              <= 2.5 eps (1 + 6u) |v||N|
//   (gamma_k = k u / (1 - k u); Cauchy-Schwarz for the last step). |v| is
//   within (1 + u)(1 + 2 delta) of the nearest vertex's exact distance
//   |v*|, delta the approximate root's relative error (`pair_terms` picks
//   the vertex by approximate lengths), and the float64 normal's own error
//   (below 2^-51 |B - A||C - A|) is under 0.1 eps |N| unless the face's
//   f32 vertices are collinear to 1e-8. So |n - n*| <= W1_NUM_ERR_EPS eps
//   |v*||N| with W1_NUM_ERR_EPS = 3, the 0.5 above 2.5 covering those
//   factors. Where d < 0 and |n| is within that bound, n may have the wrong
//   sign, and the numerator is taken again in float64.
// - Near an edge, n and d both cancel: the rounding of a, b and c alone
//   moves the edge by eps |b| against q, and the angle errs by up to about
//   3.5 eps / c in f32 (measured on the CPU model of this arithmetic), with
//   c = |(n, d)| / (|a||b||c|). Where max(|n|, |d|) <= W1_EDGE |a||b||c|
//   (c below 2^-6 to within sqrt 2, a pair within about 1/64 of an edge's
//   length of that edge) both are taken in float64, so the angle errs by
//   at most about 3.5 eps / W1_EDGE = 2.7e-5 rad where f32 is kept.
// The fast path's vote keeps such pairs out of it: it needs
// |n| + W1_EDGE |a||b||c| < d, so a pair it passes has d > W1_EDGE |a||b||c|
// and is never repaired, and the two paths still give the same bits.
// Mirrored in `ops/winding.py` (`NUM_ERR_EPS`, `EDGE`), which the CPU
// tests hold to this text, the first to a sweep of near-plane pairs.
// BEGIN W1 REPAIR BOUNDS
constexpr float W1_NUM_ERR_EPS = 3.0f;
constexpr float W1_EDGE = 0.015625f;
// END W1 REPAIR BOUNDS
constexpr double W1_NUM_ERR = W1_NUM_ERR_EPS * 1.1920928955078125e-7;

// The repairs of one pair in float64 from the f32 inputs: (n, d), or
// (n*, d*) where `edge`, or (n*, d) where d < 0 and |n| is within the
// bound. n* = v* . ((B - A) x (C - A)), v* the exact difference vector of
// the vertex nearest q: in real arithmetic (A - q) . ((B - q) x (C - q)),
// the float64 reference's formula, but exactly +-0 for a query on a vertex
// (v* = 0) and for a face with a repeated vertex (an edge vector 0), as
// the f32 v . N is. The differences are exact in float64 and the edge
// products nearly so; n* errs by about 2^-51 |v*||B - A||C - A|, d* by
// about 2^-50 |a||b||c|. An f32 query within f32 rounding of the plane but
// not on it lies typically 2^-25 |q| off it, so float64 decides its sign
// with some 20 bits to spare; a query on the plane to float64's precision
// is left, and there the winding number steps by one anyway. So no exact
// (orient3d-style) expansion is taken.
__device__ __forceinline__ float2 repair_terms(float qx, float qy, float qz, float4 pa,
                                               float4 pb, float4 pc, bool edge, float n, float d) {
  const double ax = double(pa.x) - qx, ay = double(pa.y) - qy, az = double(pa.z) - qz;
  const double bx = double(pb.x) - qx, by = double(pb.y) - qy, bz = double(pb.z) - qz;
  const double cx = double(pc.x) - qx, cy = double(pc.y) - qy, cz = double(pc.z) - qz;
  const double aa = ax * ax + ay * ay + az * az, bb = bx * bx + by * by + bz * bz,
               cc = cx * cx + cy * cy + cz * cz;
  // |n| > W1_NUM_ERR |v*||N| (squared): f32 has the sign
  const double nn = double(pa.w) * pa.w + double(pb.w) * pb.w + double(pc.w) * pc.w;
  if (!edge && double(n) * n > W1_NUM_ERR * W1_NUM_ERR * fmin(aa, fmin(bb, cc)) * nn)
    return make_float2(n, d);
  double vx = ax, vy = ay, vz = az, vv = aa;
  if (bb < vv) { vx = bx; vy = by; vz = bz; vv = bb; }
  if (cc < vv) { vx = cx; vy = cy; vz = cz; }
  const double ux = double(pb.x) - pa.x, uy = double(pb.y) - pa.y, uz = double(pb.z) - pa.z;
  const double wx = double(pc.x) - pa.x, wy = double(pc.y) - pa.y, wz = double(pc.z) - pa.z;
  n = static_cast<float>(vx * (uy * wz - uz * wy) + vy * (uz * wx - ux * wz) +
                         vz * (ux * wy - uy * wx));
  if (edge) {
    const double la = sqrt(aa), lb = sqrt(bb), lc = sqrt(cc);
    d = static_cast<float>(la * lb * lc + (ax * bx + ay * by + az * bz) * lc +
                           (bx * cx + by * cy + bz * cz) * la + (cx * ax + cy * ay + cz * az) * lb);
  }
  return make_float2(n, d);
}

// numerator v . N (v of the vertex nearest q, ties to A, then B),
// denominator and |a||b||c| of one (query, face) pair
__device__ __forceinline__ void pair_terms(float qx, float qy, float qz, float4 pa, float4 pb,
                                           float4 pc, float& n, float& d, float& l3) {
  const float ax = pa.x - qx, ay = pa.y - qy, az = pa.z - qz;
  const float bx = pb.x - qx, by = pb.y - qy, bz = pb.z - qz;
  const float cx = pc.x - qx, cy = pc.y - qy, cz = pc.z - qz;
  const float la = sqrt_approx(fmaf(az, az, fmaf(ay, ay, ax * ax)));
  const float lb = sqrt_approx(fmaf(bz, bz, fmaf(by, by, bx * bx)));
  const float lc = sqrt_approx(fmaf(cz, cz, fmaf(cy, cy, cx * cx)));
  const float na = fmaf(az, pc.w, fmaf(ay, pb.w, ax * pa.w));
  const float nb = fmaf(bz, pc.w, fmaf(by, pb.w, bx * pa.w));
  const float nc = fmaf(cz, pc.w, fmaf(cy, pb.w, cx * pa.w));
  n = lb < la ? nb : na;
  n = lc < fminf(la, lb) ? nc : n;
  const float ab = fmaf(az, bz, fmaf(ay, by, ax * bx));
  const float bc = fmaf(bz, cz, fmaf(by, cy, bx * cx));
  const float ca = fmaf(cz, az, fmaf(cy, ay, cx * ax));
  // |a||b||c| + (a.b)|c| + (b.c)|a| + (c.a)|b|: a query on a vertex gives
  // |a||b||c| = +0 and then +0 (as the plain version's sum does), never -0
  l3 = la * lb * lc;
  d = fmaf(ca, lb, fmaf(bc, la, fmaf(ab, lc, l3)));
}

// every pair of the warp has |n| + W1_EDGE |a||b||c| < d, with d below
// FLT_MIN counted as 0 (.ftz): then 0 < d, r = n / d lies in (-1, 1), and
// the pair is not near an edge
__device__ __forceinline__ bool warp_all_inner(const float (&n)[W_QUERIES],
                                               const float (&d)[W_QUERIES],
                                               const float (&l3)[W_QUERIES]) {
  static_assert(W_QUERIES == 4, "the vote below compares four pairs");
  uint32_t all;
  asm volatile("{\n"
      ".reg .pred p;\n"
      "setp.lt.ftz.f32 p, %1, %2;\n"
      "setp.lt.and.ftz.f32 p, %3, %4, p;\n"
      "setp.lt.and.ftz.f32 p, %5, %6, p;\n"
      "setp.lt.and.ftz.f32 p, %7, %8, p;\n"
      "vote.sync.all.pred p, p, 0xffffffff;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(all)
      : "f"(fmaf(l3[0], W1_EDGE, fabsf(n[0]))), "f"(d[0]),
        "f"(fmaf(l3[1], W1_EDGE, fabsf(n[1]))), "f"(d[1]),
        "f"(fmaf(l3[2], W1_EDGE, fabsf(n[2]))), "f"(d[2]),
        "f"(fmaf(l3[3], W1_EDGE, fabsf(n[3]))), "f"(d[3]));
  return all != 0;
}

__global__ void __launch_bounds__(W_THREADS)
winding_kernel(const float* __restrict__ q, const float4* __restrict__ faces,
               float* __restrict__ partial, int nq, int tiles, int per_split) {
  __shared__ __align__(128) float4 ring[W_STAGES][W_TILE * 3];
  __shared__ __align__(8) uint64_t full[W_STAGES];
  const int t0 = blockIdx.y * per_split;
  const int nt = max(0, min(tiles, t0 + per_split) - t0);  // this split's tiles
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) gm::mbar_init(&full[s], 1);
    gm::mbar_fence_init();
    for (int s = 0; s < W_STAGES && s < nt; ++s) {
      gm::mbar_arrive_expect_tx(&full[s], W_TILE_BYTES);
      gm::bulk_copy_g2s(ring[s], faces + static_cast<size_t>(t0 + s) * W_TILE * 3,
                        W_TILE_BYTES, &full[s]);
    }
  }
  // query j of this thread: block's first + threadIdx.x + j * W_THREADS
  // (coalesced); past nq a copy of the last query, computed and not written
  const int q0 = blockIdx.x * W_THREADS * W_QUERIES + threadIdx.x;
  float qx[W_QUERIES], qy[W_QUERIES], qz[W_QUERIES], total[W_QUERIES];
#pragma unroll
  for (int j = 0; j < W_QUERIES; ++j) {
    const int qi = min(q0 + j * W_THREADS, nq - 1);
    qx[j] = q[3 * qi];
    qy[j] = q[3 * qi + 1];
    qz[j] = q[3 * qi + 2];
    total[j] = 0.f;
  }
  __syncthreads();  // the barriers are initialised before anyone waits
  for (int i = 0; i < nt; ++i) {
    const int s = i % W_STAGES;
    gm::mbar_wait(&full[s], (i / W_STAGES) & 1);
    const float4* tile = ring[s];
    float sum[W_QUERIES];
#pragma unroll
    for (int j = 0; j < W_QUERIES; ++j) sum[j] = 0.f;
#pragma unroll 2
    for (int f = 0; f < W_TILE; ++f) {
      const float4 pa = tile[3 * f], pb = tile[3 * f + 1], pc = tile[3 * f + 2];
      float n[W_QUERIES], d[W_QUERIES], l3[W_QUERIES];
#pragma unroll
      for (int j = 0; j < W_QUERIES; ++j)
        pair_terms(qx[j], qy[j], qz[j], pa, pb, pc, n[j], d[j], l3[j]);
      if (warp_all_inner(n, d, l3)) {
#pragma unroll
        for (int j = 0; j < W_QUERIES; ++j) {
          const float r = n[j] * rcp_approx(d[j]);
          sum[j] = fmaf(r, atan_poly(r * r), sum[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < W_QUERIES; ++j) {
          // not taken by a pair the vote passed: max(|n|, |d|) >= d > W1_EDGE l3
          const bool edge = fmaxf(fabsf(n[j]), fabsf(d[j])) <= W1_EDGE * l3[j];
          float2 t = make_float2(n[j], d[j]);
          if (edge || d[j] < 0.f) t = repair_terms(qx[j], qy[j], qz[j], pa, pb, pc, edge, t.x, t.y);
          sum[j] = add_atan2(sum[j], t.x, t.y);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < W_QUERIES; ++j) total[j] += sum[j];
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && i + W_STAGES < nt) {
      gm::fence_proxy_async();
      gm::mbar_arrive_expect_tx(&full[s], W_TILE_BYTES);
      gm::bulk_copy_g2s(ring[s], faces + static_cast<size_t>(t0 + i + W_STAGES) * W_TILE * 3,
                        W_TILE_BYTES, &full[s]);
    }
  }
#pragma unroll
  for (int j = 0; j < W_QUERIES; ++j) {
    const int qi = q0 + j * W_THREADS;
    if (qi < nq) partial[static_cast<size_t>(blockIdx.y) * nq + qi] = total[j];
  }
}

// the splits' totals added in split order in f64: the running sum of up to
// a few hundred of them reaches the query's winding number (hundreds of
// turns inside a soup of large triangles), and adding them in f32 read up
// to 3x the plain version's error there
__global__ void winding_sum_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int nq, int splits) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  double acc = 0.0;
  for (int s = 0; s < splits; ++s) acc += partial[static_cast<size_t>(s) * nq + qi];
  out[qi] = static_cast<float>(acc / 6.283185307179586);  // the sum holds omega / 2
}

}  // namespace

// queries (nq, 3) f32; faces (tiles * W_TILE, 12) f32 packed as
// `ops/winding.py::pack_faces` packs them (16-byte aligned); partial
// (splits, nq) f32 workspace; out (nq,) f32. The tiles are cut into
// `splits` contiguous ranges.
extern "C" int ppsurf_winding(const void* queries, const void* faces, void* partial, void* out,
                              int nq, int tiles, int splits, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (nq < 0 || tiles < 0 || splits < 1 || splits > (tiles > 0 ? tiles : 1) ||
      reinterpret_cast<uintptr_t>(faces) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  const int per_split = (tiles + splits - 1) / splits;
  const dim3 grid((nq + W_THREADS * W_QUERIES - 1) / (W_THREADS * W_QUERIES), splits);
  winding_kernel<<<grid, W_THREADS, 0, s>>>(
      static_cast<const float*>(queries), static_cast<const float4*>(faces),
      static_cast<float*>(partial), nq, tiles, per_split);
  winding_sum_kernel<<<(nq + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                       static_cast<float*>(out), nq, splits);
  return static_cast<int>(cudaGetLastError());
}
