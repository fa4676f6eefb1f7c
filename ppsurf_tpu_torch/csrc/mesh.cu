// The reconstruction's meshing on the card: marching cubes over the grown
// volume, the vertex merge, the degenerate and duplicate face removal and
// the small-component filter (recon/engine.py::reconstruct_mesh's `mesh`
// and `clean` phases; wrappers, plain versions and the steps between the
// launches in ppsurf_tpu_torch/ops/mesh.py).
//
// These kernels replace no TPU kernel: the JAX package meshes on the host
// too, in the C++ of native/ppsurf_native.cpp (`mc_extract`,
// `unique_rows_f64`, `dedup_faces`, `face_components`), which the port's
// host route still runs. They exist because those host passes left the
// card idle for 1.3-1.9 s of every object.
//
// What bounds them on an H100: bytes. Extraction reads the (R+2)^3 float64
// volume (139 MB at res 257, 0.041 ms at 3.35 TB/s) about three times
// (classify, edges, and the cut edges' endpoints) and writes and reads a
// few bytes a grid point of per-cell and per-point arrays (cube index,
// triangle count, edge mask and count, two scans: about 20 bytes a point,
// 0.35 GB at res 257); the rest works on rows of the mesh (about a
// million), a few MB. The host's copy of the volume to the card (the
// H2D link, not the card) is the floor of the whole phase.
//
// Design:
// - every pass over the grid is one thread a grid point (grid-stride),
//   neighbouring threads on neighbouring z, so each warp reads contiguous
//   doubles; per-cell arrays are indexed by the cell's origin point;
// - a cell's faces go to an offset from an exclusive scan of the triangle
//   counts in cell-linear order, the host's face order;
// - a cut grid edge that some valid active cell references gets one
//   vertex id from flags and a scan over the grid points' three owned
//   edges (no hash map); faces look the id up from the edge's point;
// - each vertex records the first position at which the face list
//   references it (atomicMin), which orders the vertices as the host
//   numbers them (first appearance);
// - interpolation repeats mc_extract's float64 arithmetic with the
//   rounding intrinsics, so no contraction changes a bit;
// - components: union-find over faces that share an edge, hooking the
//   larger root to the smaller with atomicCAS (a root is its component's
//   smallest face, whatever order the atomics run in);
// - offsets into the grid, the face list and the vertex list are 64-bit
//   (a grid of 2^31 points or more, as at res 1290, meshes like a small
//   one); the kernels over mesh rows index them in int, so a mesh holds
//   fewer than 2^31 faces and vertices (ops/mesh.py checks);
// - the sorts between the passes are torch.sort on the card.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 32;  // grid-stride: 32 blocks of 256 an SM
constexpr long long KEY_NONE = 0x7fffffffffffffffLL;  // the key of a removed face or edge

// the table block `ops/mesh.py::tables` uploads (int8):
// TRI[cfg * 16 + j] the cube's triangles as local edges, -1 padded;
// COUNTS[cfg] its triangle count; EDGE[e * 4 + 0..3] edge e's base corner
// offset (dx, dy, dz) and axis; CORNER[i * 3 + 0..2] corner i's offset
constexpr int TRI = 0, COUNTS = 4096, EDGE = 4352, CORNER = 4400;

inline int blocks_for(long long n) {
  long long b = (n + THREADS - 1) / THREADS;
  return static_cast<int>(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

// Cube index and triangle count of every cell (at its origin point; 0 at
// the points that start no cell, and where a corner is NaN), and each
// block's least and greatest finite value of the volume.
__global__ void __launch_bounds__(THREADS) classify_kernel(
    const double* __restrict__ vol, int nx, int ny, int nz, double level,
    const int8_t* __restrict__ tab, uint8_t* __restrict__ cfg, int* __restrict__ ntri,
    double* __restrict__ partial) {
  const long long nyz = static_cast<long long>(ny) * nz, n = nx * nyz;
  double lo = INFINITY, hi = -INFINITY;
  for (long long p = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; p < n;
       p += static_cast<long long>(gridDim.x) * THREADS) {
    const double v = vol[p];
    if (isfinite(v)) {
      lo = fmin(lo, v);
      hi = fmax(hi, v);
    }
    const int z = static_cast<int>(p % nz), y = static_cast<int>((p / nz) % ny),
              x = static_cast<int>(p / nyz);
    int c = 0, nt = 0;
    if (x + 1 < nx && y + 1 < ny && z + 1 < nz) {
      bool valid = true;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const double w = vol[p + tab[CORNER + 3 * i] * nyz + tab[CORNER + 3 * i + 1] * nz +
                             tab[CORNER + 3 * i + 2]];
        valid &= !isnan(w);
        c |= (w < level) << i;
      }
      nt = valid ? tab[COUNTS + c] : 0;
    }
    cfg[p] = static_cast<uint8_t>(c);
    ntri[p] = nt;
  }
  __shared__ double s_lo[THREADS / 32], s_hi[THREADS / 32];
  for (int o = 16; o; o >>= 1) {
    lo = fmin(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    s_lo[threadIdx.x / 32] = lo;
    s_hi[threadIdx.x / 32] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      lo = fmin(lo, s_lo[w]);
      hi = fmax(hi, s_hi[w]);
    }
    partial[2 * blockIdx.x] = lo;
    partial[2 * blockIdx.x + 1] = hi;
  }
}

// Which of the three edges a point owns (towards +x, +y, +z) carry a
// vertex: cut by the level and inside a cell with triangles (such a cell
// is valid, and every edge of it that the level cuts is in its triangles).
__global__ void __launch_bounds__(THREADS) edges_kernel(
    const double* __restrict__ vol, const int* __restrict__ ntri, int nx, int ny, int nz,
    double level, uint8_t* __restrict__ emask, int* __restrict__ ecount) {
  const long long nyz = static_cast<long long>(ny) * nz, n = nx * nyz;
  for (long long p = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; p < n;
       p += static_cast<long long>(gridDim.x) * THREADS) {
    const int z = static_cast<int>(p % nz), y = static_cast<int>((p / nz) % ny),
              x = static_cast<int>(p / nyz);
    const bool in0 = vol[p] < level;
    int m = 0;
    if (x + 1 < nx && (vol[p + nyz] < level) != in0) {
      // the cells (x, y - dy, z - dz)
      m |= (ntri[p] > 0 || (y && ntri[p - nz] > 0) || (z && ntri[p - 1] > 0) ||
            (y && z && ntri[p - nz - 1] > 0));
    }
    if (y + 1 < ny && (vol[p + nz] < level) != in0) {
      m |= (ntri[p] > 0 || (x && ntri[p - nyz] > 0) || (z && ntri[p - 1] > 0) ||
            (x && z && ntri[p - nyz - 1] > 0)) << 1;
    }
    if (z + 1 < nz && (vol[p + 1] < level) != in0) {
      m |= (ntri[p] > 0 || (x && ntri[p - nyz] > 0) || (y && ntri[p - nz] > 0) ||
            (x && y && ntri[p - nyz - nz] > 0)) << 2;
    }
    emask[p] = static_cast<uint8_t>(m);
    ecount[p] = __popc(m);
  }
}

// The vertex of every marked edge, at vbase (an inclusive scan of the
// edge counts) less the point's own count, plus the edges of lower axis:
// mc_extract's float64 interpolation, rounded once to float32.
__global__ void __launch_bounds__(THREADS) vertices_kernel(
    const double* __restrict__ vol, const uint8_t* __restrict__ emask,
    const long long* __restrict__ vbase, int nx, int ny, int nz, double level,
    float* __restrict__ verts) {
  const long long nyz = static_cast<long long>(ny) * nz, n = nx * nyz;
  for (long long p = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; p < n;
       p += static_cast<long long>(gridDim.x) * THREADS) {
    const int m = emask[p];
    if (!m) continue;
    const int c[3] = {static_cast<int>(p / nyz), static_cast<int>((p / nz) % ny),
                      static_cast<int>(p % nz)};
    const long long stride[3] = {nyz, nz, 1};
    const double v0 = vol[p];
    long long id = vbase[p] - __popc(m);
    for (int a = 0; a < 3; ++a) {
      if (!((m >> a) & 1)) continue;
      const double denom = __dsub_rn(vol[p + stride[a]], v0);
      double t = fabs(denom) > 1e-300 ? __ddiv_rn(__dsub_rn(level, v0), denom) : 0.5;
      t = 0.0 < t ? t : 0.0;  // std::max(0.0, t), NaN to 0
      t = t < 1.0 ? t : 1.0;  // std::min(1.0, t)
      for (int k = 0; k < 3; ++k)
        verts[3LL * id + k] = k == a ? __double2float_rn(__dadd_rn(static_cast<double>(c[k]), t))
                                     : static_cast<float>(c[k]);
      ++id;
    }
  }
}

// Every cell's triangles at foff (an inclusive scan of the counts) less
// its own count, as vertex ids, and each vertex's first position in the
// face list (fp, set to INT64_MAX before).
__global__ void __launch_bounds__(THREADS) faces_kernel(
    const uint8_t* __restrict__ cfg, const int* __restrict__ ntri,
    const long long* __restrict__ foff, const uint8_t* __restrict__ emask,
    const long long* __restrict__ vbase, int nx, int ny, int nz, const int8_t* __restrict__ tab,
    long long* __restrict__ faces, long long* __restrict__ fp) {
  const long long nyz = static_cast<long long>(ny) * nz, n = nx * nyz;
  for (long long p = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; p < n;
       p += static_cast<long long>(gridDim.x) * THREADS) {
    const int nt = ntri[p];
    if (!nt) continue;
    const int c = cfg[p];
    const long long pos0 = 3 * (foff[p] - nt);
    for (int j = 0; j < 3 * nt; ++j) {
      const int e = tab[TRI + 16 * c + j];
      const long long q = p + tab[EDGE + 4 * e] * nyz + tab[EDGE + 4 * e + 1] * nz +
                          tab[EDGE + 4 * e + 2];
      const int a = tab[EDGE + 4 * e + 3];
      const int m = emask[q];
      const long long id = vbase[q] - __popc(m) + __popc(m & ((1 << a) - 1));
      faces[pos0 + j] = id;
      atomicMin(fp + id, pos0 + j);
    }
  }
}

// np.round(float64(v), 10) as numpy computes it (multiply by 1e10, round
// half to even, divide by 1e10), with -0 made +0 so that equal keys sort
// together.
__global__ void __launch_bounds__(THREADS) round_keys_kernel(
    const float* __restrict__ v, long long n, double* __restrict__ key) {
  for (long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * THREADS) {
    const double y = rint(__dmul_rn(static_cast<double>(v[i]), 1e10));
    key[i] = __dadd_rn(__ddiv_rn(y, 1e10), 0.0);
  }
}

// 1 where sorted row j starts a run of equal keys (key rows perm[j]).
__global__ void __launch_bounds__(THREADS) runs_kernel(const double* __restrict__ key,
                                                       const long long* __restrict__ perm,
                                                       int n, int* __restrict__ start) {
  for (int j = blockIdx.x * THREADS + threadIdx.x; j < n; j += gridDim.x * THREADS) {
    int s = 1;
    if (j) {
      const double* a = key + 3 * perm[j];
      const double* b = key + 3 * perm[j - 1];
      s = a[0] != b[0] || a[1] != b[1] || a[2] != b[2];
    }
    start[j] = s;
  }
}

// Each row's group (gid, an inclusive scan of the run starts, less one)
// and each group's leader, the row that starts its run.
__global__ void __launch_bounds__(THREADS) groups_kernel(
    const long long* __restrict__ perm, const int* __restrict__ start,
    const int* __restrict__ gid, int n, long long* __restrict__ inverse,
    long long* __restrict__ leader) {
  for (int j = blockIdx.x * THREADS + threadIdx.x; j < n; j += gridDim.x * THREADS) {
    const int g = gid[j] - 1;
    inverse[perm[j]] = g;
    if (start[j]) leader[g] = perm[j];
  }
}

// Faces through the merge (mf = inverse[faces]) and the keys of their
// sorted vertex triples: one key (lo * nv + mid) * nv + hi, or with two
// keys lo * nv + mid and hi; KEY_NONE for a face with a repeated vertex.
__global__ void __launch_bounds__(THREADS) face_keys_kernel(
    const long long* __restrict__ faces, const long long* __restrict__ inverse, int nf,
    long long nv, int two, long long* __restrict__ mf, long long* __restrict__ k1,
    long long* __restrict__ k2) {
  for (int f = blockIdx.x * THREADS + threadIdx.x; f < nf; f += gridDim.x * THREADS) {
    const long long a = inverse[faces[3LL * f]], b = inverse[faces[3LL * f + 1]],
                    c = inverse[faces[3LL * f + 2]];
    mf[3LL * f] = a;
    mf[3LL * f + 1] = b;
    mf[3LL * f + 2] = c;
    const long long lo = min(a, min(b, c)), hi = max(a, max(b, c)), mid = a + b + c - lo - hi;
    const bool degenerate = a == b || b == c || a == c;
    if (two) {
      k1[f] = degenerate ? KEY_NONE : lo * nv + mid;
      k2[f] = degenerate ? KEY_NONE : hi;
    } else {
      k1[f] = degenerate ? KEY_NONE : (lo * nv + mid) * nv + hi;
    }
  }
}

// A face lives where it has no repeated vertex and is the first (lowest
// index) of its vertex triple: the first of its run in the stable order p.
__global__ void __launch_bounds__(THREADS) dedup_kernel(
    const long long* __restrict__ k1, const long long* __restrict__ k2,
    const long long* __restrict__ p, int nf, uint8_t* __restrict__ alive) {
  for (int j = blockIdx.x * THREADS + threadIdx.x; j < nf; j += gridDim.x * THREADS) {
    const long long f = p[j];
    bool first = j == 0 || k1[p[j - 1]] != k1[f] || (k2 && k2[p[j - 1]] != k2[f]);
    alive[f] = k1[f] != KEY_NONE && first;
  }
}

// The three edges of every living face as lo * nv + hi; KEY_NONE for the
// edges of a removed face.
__global__ void __launch_bounds__(THREADS) edge_keys_kernel(
    const long long* __restrict__ mf, const uint8_t* __restrict__ alive, int nf, long long nv,
    long long* __restrict__ ekey) {
  for (long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; i < 3LL * nf;
       i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long f = i / 3, e = i % 3;
    const long long a = mf[3 * f + e], b = mf[3 * f + (e + 1) % 3];
    ekey[i] = alive[f] ? min(a, b) * nv + max(a, b) : KEY_NONE;
  }
}

// The root of x; with HALVE, halving the path (any write stores an
// ancestor, so concurrent finds stay right). Reads bypass L1, which other
// SMs' writes do not reach.
template <bool HALVE>
__device__ __forceinline__ int find_root(volatile int* parent, int x) {
  int cur = parent[x];
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = parent[cur])) {
      if (HALVE) parent[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// Join the faces of every pair of equal neighbouring sorted edge keys:
// the larger root is hooked to the smaller with atomicCAS, retried where
// another thread hooked it first.
__global__ void __launch_bounds__(THREADS) union_kernel(
    const long long* __restrict__ ekey, const long long* __restrict__ eidx, long long ne,
    int* parent) {
  for (long long j = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x + 1; j < ne;
       j += static_cast<long long>(gridDim.x) * THREADS) {
    if (ekey[j] != ekey[j - 1] || ekey[j] == KEY_NONE) continue;
    int a = find_root<true>(parent, static_cast<int>(eidx[j] / 3));
    int b = find_root<true>(parent, static_cast<int>(eidx[j - 1] / 3));
    while (a != b) {
      const int lo = min(a, b), hi = max(a, b);
      const int old = atomicCAS(parent + hi, hi, lo);
      if (old == hi) break;
      // hi was hooked meanwhile: go on from its new parent
      a = find_root<true>(parent, old);
      b = lo;
    }
  }
}

// Every face's root written as its parent, and the living faces counted
// at their roots. The finds here write nothing else: a halving write could
// land on a face after its own thread stored the root there.
__global__ void __launch_bounds__(THREADS) roots_kernel(int* parent,
                                                        const uint8_t* __restrict__ alive, int nf,
                                                        int* __restrict__ count) {
  for (int f = blockIdx.x * THREADS + threadIdx.x; f < nf; f += gridDim.x * THREADS) {
    const int r = find_root<false>(parent, f);
    parent[f] = r;
    if (alive[f]) atomicAdd(count + r, 1);
  }
}

// A face is kept where it lives and its component has more than
// min_faces living faces; its vertices are then used.
__global__ void __launch_bounds__(THREADS) keep_kernel(
    const long long* __restrict__ mf, const int* __restrict__ root,
    const int* __restrict__ count, const uint8_t* __restrict__ alive, int nf, int min_faces,
    int* __restrict__ keep, int* __restrict__ used) {
  for (int f = blockIdx.x * THREADS + threadIdx.x; f < nf; f += gridDim.x * THREADS) {
    const int k = alive[f] && count[root[f]] > min_faces;
    keep[f] = k;
    if (k) {
      used[mf[3LL * f]] = 1;
      used[mf[3LL * f + 1]] = 1;
      used[mf[3LL * f + 2]] = 1;
    }
  }
}

// Kept faces at fpos - 1 with their vertices renumbered to vpos - 1
// (inclusive scans of keep and used).
__global__ void __launch_bounds__(THREADS) compact_faces_kernel(
    const long long* __restrict__ mf, const int* __restrict__ keep,
    const int* __restrict__ fpos, const int* __restrict__ vpos, int nf,
    long long* __restrict__ out) {
  for (int f = blockIdx.x * THREADS + threadIdx.x; f < nf; f += gridDim.x * THREADS) {
    if (!keep[f]) continue;
    const long long row = fpos[f] - 1;
    for (int k = 0; k < 3; ++k) out[3 * row + k] = vpos[mf[3LL * f + k]] - 1;
  }
}

// Used groups' leaders' coordinates at vpos - 1.
__global__ void __launch_bounds__(THREADS) compact_vertices_kernel(
    const float* __restrict__ verts, const long long* __restrict__ leader,
    const int* __restrict__ used, const int* __restrict__ vpos, int ng,
    float* __restrict__ out) {
  for (int g = blockIdx.x * THREADS + threadIdx.x; g < ng; g += gridDim.x * THREADS) {
    if (!used[g]) continue;
    const long long row = vpos[g] - 1, src = leader[g];
    for (int k = 0; k < 3; ++k) out[3 * row + k] = verts[3 * src + k];
  }
}

inline int done() { return static_cast<int>(cudaGetLastError()); }

inline bool grid_ok(int nx, int ny, int nz) { return nx >= 1 && ny >= 1 && nz >= 1; }

}  // namespace

// volume (nx, ny, nz) f64; tables: the int8 block of ops/mesh.py; out:
// cfg (u8) and ntri (i32) a point, partial: (least, greatest) finite value
// of each block, 2 * MAX_BLOCKS f64 (+inf, -inf before, for the blocks a
// smaller grid leaves out)
extern "C" int ppsurf_mesh_classify(const void* volume, int nx, int ny, int nz, double level,
                                    const void* tables, void* cfg, void* ntri, void* partial,
                                    void* stream) {
  if (!grid_ok(nx, ny, nz)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(nx) * ny * nz;
  classify_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(volume), nx, ny, nz, level, static_cast<const int8_t*>(tables),
      static_cast<uint8_t*>(cfg), static_cast<int*>(ntri), static_cast<double*>(partial));
  return done();
}

extern "C" int ppsurf_mesh_edges(const void* volume, const void* ntri, int nx, int ny, int nz,
                                 double level, void* emask, void* ecount, void* stream) {
  if (!grid_ok(nx, ny, nz)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(nx) * ny * nz;
  edges_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(volume), static_cast<const int*>(ntri), nx, ny, nz, level,
      static_cast<uint8_t*>(emask), static_cast<int*>(ecount));
  return done();
}

// foff, vbase: inclusive scans (i64) of ntri and of the edge counts; out:
// verts (V, 3) f32, faces (F, 3) i64, fp (V,) i64 set to INT64_MAX before
extern "C" int ppsurf_mesh_emit(const void* volume, const void* cfg, const void* ntri,
                                const void* foff, const void* emask, const void* vbase, int nx,
                                int ny, int nz, double level, const void* tables, void* verts,
                                void* faces, void* fp, void* stream) {
  if (!grid_ok(nx, ny, nz)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(nx) * ny * nz;
  auto s = static_cast<cudaStream_t>(stream);
  vertices_kernel<<<blocks_for(n), THREADS, 0, s>>>(
      static_cast<const double*>(volume), static_cast<const uint8_t*>(emask),
      static_cast<const long long*>(vbase), nx, ny, nz, level, static_cast<float*>(verts));
  faces_kernel<<<blocks_for(n), THREADS, 0, s>>>(
      static_cast<const uint8_t*>(cfg), static_cast<const int*>(ntri),
      static_cast<const long long*>(foff), static_cast<const uint8_t*>(emask),
      static_cast<const long long*>(vbase), nx, ny, nz, static_cast<const int8_t*>(tables),
      static_cast<long long*>(faces), static_cast<long long*>(fp));
  return done();
}

// verts (n / 3, 3) f32 -> keys f64
extern "C" int ppsurf_mesh_round_keys(const void* verts, long long n, void* keys, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  round_keys_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(verts), n, static_cast<double*>(keys));
  return done();
}

extern "C" int ppsurf_mesh_runs(const void* keys, const void* perm, int n, void* start,
                                void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  runs_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(keys), static_cast<const long long*>(perm), n,
      static_cast<int*>(start));
  return done();
}

extern "C" int ppsurf_mesh_groups(const void* perm, const void* start, const void* gid, int n,
                                  void* inverse, void* leader, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  groups_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(perm), static_cast<const int*>(start),
      static_cast<const int*>(gid), n, static_cast<long long*>(inverse),
      static_cast<long long*>(leader));
  return done();
}

// k2 is written (and read by ppsurf_mesh_dedup) only where two != 0
extern "C" int ppsurf_mesh_face_keys(const void* faces, const void* inverse, int nf,
                                     long long nv, int two, void* mf, void* k1, void* k2,
                                     void* stream) {
  if (nf < 0 || nv < 1 || (two && !k2)) return static_cast<int>(cudaErrorInvalidValue);
  if (nf == 0) return 0;
  face_keys_kernel<<<blocks_for(nf), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(faces), static_cast<const long long*>(inverse), nf, nv, two,
      static_cast<long long*>(mf), static_cast<long long*>(k1), static_cast<long long*>(k2));
  return done();
}

// p: the faces in the stable order of their keys; out: alive (u8 a face)
// and the edge keys (3 a face)
extern "C" int ppsurf_mesh_dedup(const void* k1, const void* k2, const void* p, const void* mf,
                                 int nf, long long nv, void* alive, void* ekey, void* stream) {
  if (nf < 0 || nv < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nf == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  dedup_kernel<<<blocks_for(nf), THREADS, 0, s>>>(
      static_cast<const long long*>(k1), static_cast<const long long*>(k2),
      static_cast<const long long*>(p), nf, static_cast<uint8_t*>(alive));
  edge_keys_kernel<<<blocks_for(3LL * nf), THREADS, 0, s>>>(
      static_cast<const long long*>(mf), static_cast<const uint8_t*>(alive), nf, nv,
      static_cast<long long*>(ekey));
  return done();
}

// ekey, eidx: the edge keys sorted and their positions (3 f + e); parent:
// (nf,) i32 set to 0..nf-1 before, each face's root after; count (nf,)
// and used (vertices,) i32 zero before; out keep (nf,) i32
extern "C" int ppsurf_mesh_components(const void* ekey, const void* eidx, const void* mf,
                                      const void* alive, int nf, int min_faces, void* parent,
                                      void* count, void* keep, void* used, void* stream) {
  if (nf < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nf == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const long long ne = 3LL * nf;
  union_kernel<<<blocks_for(ne), THREADS, 0, s>>>(static_cast<const long long*>(ekey),
                                                  static_cast<const long long*>(eidx), ne,
                                                  static_cast<int*>(parent));
  roots_kernel<<<blocks_for(nf), THREADS, 0, s>>>(
      static_cast<int*>(parent), static_cast<const uint8_t*>(alive), nf, static_cast<int*>(count));
  keep_kernel<<<blocks_for(nf), THREADS, 0, s>>>(
      static_cast<const long long*>(mf), static_cast<const int*>(parent),
      static_cast<const int*>(count), static_cast<const uint8_t*>(alive), nf, min_faces,
      static_cast<int*>(keep), static_cast<int*>(used));
  return done();
}

// fpos, vpos: inclusive scans of keep and used; out faces (kept, 3) i64,
// out verts (used, 3) f32
extern "C" int ppsurf_mesh_compact(const void* mf, const void* keep, const void* fpos,
                                   const void* vpos, int nf, const void* verts,
                                   const void* leader, const void* used, int ng,
                                   void* faces_out, void* verts_out, void* stream) {
  if (nf < 0 || ng < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (nf)
    compact_faces_kernel<<<blocks_for(nf), THREADS, 0, s>>>(
        static_cast<const long long*>(mf), static_cast<const int*>(keep),
        static_cast<const int*>(fpos), static_cast<const int*>(vpos), nf,
        static_cast<long long*>(faces_out));
  if (ng)
    compact_vertices_kernel<<<blocks_for(ng), THREADS, 0, s>>>(
        static_cast<const float*>(verts), static_cast<const long long*>(leader),
        static_cast<const int*>(used), static_cast<const int*>(vpos), ng,
        static_cast<float*>(verts_out));
  return done();
}
