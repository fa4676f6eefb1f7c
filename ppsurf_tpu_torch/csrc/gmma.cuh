// Hopper building blocks of the port's tensor-core kernels (sm_90a, K3-K5):
// warpgroup matrix multiplies (`wgmma`) on bf16 operands in shared memory,
// one 64-deep K-tile at a time with f32 partial sums, mbarriers, 1-D bulk
// copies (TMA without a tensor map), a producer/consumer ring of weight
// slices and named barriers.
//
// Since the latent-32 K3 and the cluster K5: products with A in registers
// (the RS form), and the cluster primitives (rank, barrier, distributed
// shared memory, remote mbarrier arrivals, multicast bulk copies). Since
// the f32 K3-K5: f32 products as 3xTF32 (`wgmma` on tf32 operands,
// A in registers, below), with A loaded from an f32 activation in shared
// memory or, for the f32 latent-32 K3, fed from the last product's
// accumulator fragment.
//
// Shared-memory operand layout (the one `wgmma` reads with 128-byte
// swizzling, K-major): a (rows x 64) bf16 tile stores row r's 128 bytes at
// r * 128, with its 16-byte unit u at unit u ^ (r % 8); 8-row atoms are
// 1024 bytes apart and every tile starts 1024-byte aligned. A K of 256 is
// four such tiles side by side. `swizzle_offset` gives the byte offset of
// element (r, c) of a (rows x 256) operand stored that way.
//
// Accumulator fragment of m64nNk16 (f32), thread t of the warpgroup, warp
// w = t / 32, lane l: d[4j + e] holds row 16w + l/4 + 8 (e / 2), column
// 8j + 2 (l % 4) + (e % 2), for j < N / 8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ppsurf {
namespace gmma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte-aligned address at or after p in shared memory, where
// the swizzled operands start (dynamic shared memory is less aligned)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// byte offset of element (r, c) of a (rows x 256) bf16 K-major operand
// stored as four swizzled (rows x 64) tiles of `rows` * 128 bytes
__device__ __forceinline__ uint32_t swizzle_offset(int r, int c, int rows) {
  const int tile = c >> 6;
  const int unit = ((c >> 3) & 7) ^ (r & 7);
  return tile * rows * 128 + r * 128 + unit * 16 + (c & 7) * 2;
}

// Matrix descriptor of a 128-byte-swizzled K-major tile at shared address
// `addr` (1024-byte aligned atoms; a K step inside the 128-byte row adds
// its byte offset to addr): stride between 8-row atoms 1024 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3ffff) >> 4);
  d |= static_cast<uint64_t>(1) << 16;            // leading offset (unused)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;    // stride offset
  d |= static_cast<uint64_t>(1) << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers while a wgmma that
// writes them may still run (between its start and the wait)
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// all threads of a warpgroup set their register count (a multiple of 8):
// a producer warpgroup gives registers up so its consumers can take more
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// generic-proxy shared-memory writes -> visible to wgmma / bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the `count` threads that call it with the same id wait for each other
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
// wait until the barrier's phase differs from `parity` (labels are local
// to the braces, so every inlined copy has its own)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory; completion counts on `bar`'s transaction bytes
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

// D (64 x 128, f32, fragment layout above) (+)= A (64 x 16) B (16 x 128),
// bf16, both operands K-major in shared memory; `accumulate` 0 overwrites.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,"
      "%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,"
      "%62,%63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32, fragment layout above) (+)= A (64 x 16) B (16 x 64),
// bf16, both operands K-major in shared memory; `accumulate` 0 overwrites.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x N, f32, fragment layout above) = A (64 x 64) B (64 x N) over one
// 64-deep K-tile: A and B are swizzled K-major tiles at shared addresses a
// and b (B: N rows of 128 bytes). Overwrites d and waits for the result.
template <int N>
__device__ __forceinline__ void mma_ktile(float (&d)[N / 2], uint32_t a, uint32_t b) {
  static_assert(N == 64 || N == 128, "m64n64k16 or m64n128k16");
  fence_operand(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (N == 128)
      wgmma_m64n128k16(d, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32), kk);
    else
      wgmma_m64n64k16(d, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32), kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(d);
}

// total = sum over 64-deep K-tiles of a fresh tensor-core partial, added
// on the CUDA cores in f32 (round to nearest): `tile` 0 starts the sum.
// Tensor-core accumulation over all of K=256 (bf16 torch.matmul, the
// smoke's K3 control) reads about twice as far from the plain versions'
// f32 products (PERF.md, Findings).
template <int M>
__device__ __forceinline__ void add_partial(float (&total)[M], const float (&part)[M],
                                            int tile) {
#pragma unroll
  for (int i = 0; i < M; ++i) total[i] = tile ? total[i] + part[i] : part[i];
}

// 16 bytes from global to shared memory (both 16-byte aligned) by the
// calling thread, asynchronously: commit, then wait before reading
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
// 4 bytes (both 4-byte aligned), asynchronously, as cp_async16
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A ring of STAGES shared-memory slots of SLICE bytes that one producer
// thread fills with bulk copies and the consumer warpgroups read in the
// same order. Every consumer thread waits for a slot and releases it (the
// `empty` barriers count all of them); producer and consumers each keep
// their own copy of the position.
template <int STAGES, int SLICE>
struct Ring {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  int stage = 0;
  uint32_t phase = 0;

  // one thread, before the ring is used
  __device__ __forceinline__ void init(int consumer_threads) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], consumer_threads);
    }
    mbar_fence_init();
  }
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  // producer: wait until the next slot is free, then copy `bytes` into it
  __device__ __forceinline__ void produce(const void* src, uint32_t bytes) {
    mbar_wait(&empty[stage], phase ^ 1);
    mbar_arrive_expect_tx(&full[stage], bytes);
    bulk_copy_g2s(slots + stage * SLICE, src, bytes, &full[stage]);
    advance();
  }
  // consumer: the shared address of the next filled slot
  __device__ __forceinline__ uint32_t wait() {
    mbar_wait(&full[stage], phase);
    return smem_u32(slots + stage * SLICE);
  }
  __device__ __forceinline__ void release() {
    mbar_arrive(&empty[stage]);
    advance();
  }
};

// A ring fed by one of its consumer threads (`producer`): that thread fills
// the first STAGES slots at `start` and, after each of its releases, waits
// until every consumer has released the slot and refills it with the slice
// STAGES further on; the slices at `src` repeat every `per_round`, `total`
// in all. No warp of the block is a producer only, so a block of two
// warpgroups keeps 256 threads' share of the register file (255 a thread),
// where one producer warp more leaves it 168: a block of `wgmma`
// warpgroups is counted in whole warpgroups.
template <int STAGES, int SLICE>
struct FedRing : Ring<STAGES, SLICE> {
  const unsigned char* src = nullptr;
  int per_round = 0, total = 0, next = 0, pstage = 0;
  uint32_t pphase = 0;
  bool producer = false;

  __device__ __forceinline__ void feed() {
    mbar_wait(&this->empty[pstage], pphase ^ 1);
    mbar_arrive_expect_tx(&this->full[pstage], SLICE);
    bulk_copy_g2s(this->slots + pstage * SLICE, src + (next % per_round) * SLICE, SLICE,
                  &this->full[pstage]);
    if (++pstage == STAGES) {
      pstage = 0;
      pphase ^= 1;
    }
    ++next;
  }
  // once the barriers exist
  __device__ __forceinline__ void start() {
    if (producer)
      while (next < total && next < STAGES) feed();
  }
  __device__ __forceinline__ void release() {
    Ring<STAGES, SLICE>::release();
    if (producer && next < total) feed();
  }
};

// ---- A from registers (the RS form) ----
//
// Register fragment of a (64 x 16) bf16 A operand, thread t of the
// warpgroup, warp w, lane l: a[i] holds two bf16 (the lower column in the
// low half) of row 16w + l/4 + 8 (i % 2), columns 2 (l % 4) + 8 (i / 2)
// and one more. Columns 16kk..16kk+15 of an m64nN accumulator fragment
// (above) are therefore d[8kk..8kk+7] packed in pairs: the output of one
// product is the A operand of the next without shared memory.

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// D (64 x 32, f32) (+)= A (64 x 16, registers) B (16 x 32, K-major in
// shared memory); `accumulate` 0 overwrites.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t* a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32) (+)= A (64 x 16, registers) B (16 x 64, K-major in
// shared memory); `accumulate` 0 overwrites.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// ---- f32 products on the tensor cores as 3xTF32 ----
//
// An f32 operand x is split as hi = tf32(x), rounded to nearest with ties
// away from zero (`cvt.rna.tf32.f32`), and lo = tf32(x - hi) (x - hi is
// exact in f32). The tensor cores ignore the low 13 bits of a tf32
// operand, so both are rounded explicitly and those bits cleared. A
// product x w is then hi_x hi_w + hi_x lo_w + lo_x hi_w, each term exact
// on the tensor cores; lo_x lo_w and the roundings of lo, left out, are
// about 2^-22 of |x w|, the order of an f32 rounding (one TF32 product
// misses by about 2^-11). The weights are split once per table on the
// host (`ops/wgmma_layout.py::tf32_split`, the same rounding), the
// activations in registers from their f32 copy in shared memory.
//
// Register fragment of a (64 x 8) tf32 A operand, thread t of the
// warpgroup, warp w, lane l: a[i] holds row 16w + l/4 + 8 (i % 2),
// logical column (l % 4) + 4 (i / 2). The kernels load a[0], a[2] (a[1],
// a[3]) as one float2, inputs 2 (l % 4) and 2 (l % 4) + 1 of an 8-input
// group, so every weight tile holds the inputs of each group of 8 in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (`ops/wgmma_layout.py::TF32_K_ORDER`). The
// same float2 is what an accumulator fragment holds (columns 8j + 2 (l %
// 4), + 1 of rows r0, r0 + 8), so epilogues store it as it is.
//
// Weight tiles: (64 x 32) f32, K-major, one 128-byte row an output column
// with the 128-byte swizzle of the bf16 tiles (16-byte unit u of row r at
// u ^ (r % 8)), 8 KB; a ring slice is a tile's hi image, then its lo
// image. A k8 step is 32 bytes of the row, so `desc_sw128(tile + 32 kk)`
// addresses step kk as it addresses a bf16 k16 step.
//
// Activations: (64 x LD) f32 row-major in shared memory (LD 256, or 128
// for K4, whose widest stored layer has 128 columns), the 32-byte unit u
// of row r stored at unit u ^ (r % 8), so the fragment loads and stores
// (8 rows x 4 float2 a warp) take two wavefronts.

constexpr int TF32_TILE = 8192;              // one (64 x 32) f32 weight tile
constexpr int TF32_SLICE = 2 * TF32_TILE;    // its hi and lo images

template <int LD = 256>
__device__ __forceinline__ int act_offset(int r, int c) {
  return r * LD + (((c >> 3) ^ (r & 7)) << 3) + (c & 7);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x -> (hi, lo) tf32 bit patterns, hi + lo = x within 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// the hi and lo A fragments of k8 step g (inputs 8g..8g+7) of the f32
// activation at `act`; r0, cl: the thread's fragment row and column offset
template <int LD = 256>
__device__ __forceinline__ void load_a_tf32(const float* act, int g, int r0, int cl,
                                            uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(act + act_offset<LD>(r0, 8 * g + cl));
  const float2 x1 = *reinterpret_cast<const float2*>(act + act_offset<LD>(r0 + 8, 8 * g + cl));
  split_tf32(x0.x, hi[0], lo[0]);
  split_tf32(x1.x, hi[1], lo[1]);
  split_tf32(x0.y, hi[2], lo[2]);
  split_tf32(x1.y, hi[3], lo[3]);
}

// D (64 x 64, f32) (+)= A (64 x 8 tf32, registers) B (8 x 64 tf32, K-major
// in shared memory); `accumulate` 0 overwrites.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t* a,
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,"
      "%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 32, f32) (+)= A (64 x 8 tf32, registers) B (8 x 32 tf32, K-major
// in shared memory); `accumulate` 0 overwrites.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16], const uint32_t* a,
                                                       uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, {%16,%17,%18,%19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) (+)= A (64 x 16) W (16 x 64) as 3xTF32 over two k8 steps:
// ah / al the steps' A fragments, the weights' hi tile at shared address b
// (the steps' first 32 bytes of each 128-byte row) and the lo tile
// TF32_TILE after it; `accumulate` 0 overwrites d. The correction terms
// run first, the hi x hi terms last. Waits for the result, so the
// fragments' registers are free again.
__device__ __forceinline__ void mma_steps_tf32x3(float (&d)[32], uint32_t (&ah)[2][4],
                                                 uint32_t (&al)[2][4], uint32_t b,
                                                 int accumulate) {
  fence_operand(d);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    fence_operand(ah[kk]);
    fence_operand(al[kk]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    wgmma_m64n64k8_tf32_rs(d, ah[kk], desc_sw128(b + TF32_TILE + 32 * kk), accumulate | kk);  // hi x lo
    wgmma_m64n64k8_tf32_rs(d, al[kk], desc_sw128(b + 32 * kk), 1);  // lo x hi
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_m64n64k8_tf32_rs(d, ah[kk], desc_sw128(b + 32 * kk), 1);  // hi x hi
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(d);
}

// total (64 x 64: one column quarter of a layer) = act (64 x 32 CHUNKS) @
// W[:, quarter] as 3xTF32: its K-chunks of 32 inputs in order, each on the
// next slice of the ring, two k8 steps at a time, the steps' A fragments
// loaded from the f32 activation and split in registers. With PARTIALS
// each chunk is a fresh partial added to the total in f32 on the CUDA
// cores (round to nearest); without, the tensor cores accumulate all of K,
// which saves the partial's 32 registers: K3 with every product so read
// about 10x as far from the plain version (the tensor cores cut each sum
// at the accumulator's exponent; PERF.md). Only the quarter's accumulators, the partial and two
// steps' fragments are live, so a layer holds at most the quarters it
// cannot yet write.
template <int CHUNKS, bool PARTIALS = true, int LD = 256, typename RingT>
__device__ __forceinline__ void mma_quarter_tf32x3(float (&total)[32], const float* act,
                                                   RingT& ring, int r0, int cl) {
  auto steps = [&](float (&d)[32], int kc, uint32_t b, int accumulate) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        load_a_tf32<LD>(act, 4 * kc + 2 * h + kk, r0, cl, ah[kk], al[kk]);
      mma_steps_tf32x3(d, ah, al, b + 64 * h, accumulate | h);
    }
  };
  // defined before the loop: an accumulator first read by `wgmma` (or a
  // select) would be live, undefined, from the kernel's entry on
#pragma unroll
  for (int i = 0; i < 32; ++i) total[i] = 0.f;
#pragma unroll 1
  for (int kc = 0; kc < CHUNKS; ++kc) {
    const uint32_t b = ring.wait();
    if constexpr (PARTIALS) {
      float part[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.f;
      steps(part, kc, b, 0);
      ring.release();
#pragma unroll
      for (int i = 0; i < 32; ++i) total[i] += part[i];
    } else {
      steps(total, kc, b, kc > 0);
      ring.release();
    }
  }
}

// the m64nNk8 tf32 product (N = 32 or 64) with A in registers, B at shared
// address b
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t* a, uint32_t b,
                                              int accumulate) {
  if constexpr (N == 32)
    wgmma_m64n32k8_tf32_rs(d, a, desc_sw128(b), accumulate);
  else
    wgmma_m64n64k8_tf32_rs(d, a, desc_sw128(b), accumulate);
}

// d (64 x N, N = 32 or 64) = A (64 x 32) W (32 x N) as 3xTF32, A fed from
// registers: v is the f32 accumulator fragment of a (64 x 32) product (or
// values in its layout), whose columns are A's inputs. With the weights'
// inputs in `TF32_K_ORDER`, k8 step g's A fragment is {v[4g], v[4g + 2],
// v[4g + 1], v[4g + 3]} (rows r0 and r0 + 8 of inputs 8g + cl, then of
// 8g + cl + 1), split into hi and lo here: a layer's output feeds the next
// layer with no shuffle and no shared memory. W's hi tile (N rows of 128
// bytes, inputs 0-31) is at shared address b and its lo tile N * 128
// bytes after it. All 12 products (4 steps x hi x lo, lo x hi, then hi x
// hi) accumulate on the tensor cores: K is one 32-input chunk. Waits for
// the result.
template <int N>
__device__ __forceinline__ void mma_regs_tf32x3(float (&d)[N / 2], const float (&v)[16],
                                                uint32_t b) {
  static_assert(N == 32 || N == 64, "m64n32k8 or m64n64k8");
  auto mma = [&](const uint32_t* a, uint32_t at, int accumulate) {
    wgmma_tf32_rs<N>(d, a, at, accumulate);
  };
  // defined before the first product reads it (`+f`): an undefined
  // accumulator would be live from the kernel's entry
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    split_tf32(v[4 * g], ah[g][0], al[g][0]);
    split_tf32(v[4 * g + 2], ah[g][1], al[g][1]);
    split_tf32(v[4 * g + 1], ah[g][2], al[g][2]);
    split_tf32(v[4 * g + 3], ah[g][3], al[g][3]);
  }
  fence_operand(d);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    fence_operand(ah[g]);
    fence_operand(al[g]);
  }
  wgmma_fence();
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    mma(ah[g], b + N * 128 + 32 * g, g);  // hi x lo
    mma(al[g], b + 32 * g, 1);  // lo x hi
  }
#pragma unroll
  for (int g = 0; g < 4; ++g)
    mma(ah[g], b + 32 * g, 1);  // hi x hi
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(d);
}

// ---- thread-block clusters ----

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
// every non-exited thread of the cluster arrives (release) and waits
// (acquire): shared-memory writes before it are visible to all CTAs after.
// A thread may arrive early and wait later, but must wait before it
// arrives again.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// the address in CTA `rank`'s shared memory of local shared address `addr`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t cluster_addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(cluster_addr), "f"(v) : "memory");
}
// arrive on an mbarrier of any CTA of the cluster (a `map_rank` address).
// The default .release.cta semantics: these arrivals order no data of the
// arriving thread (a consumer frees a slot that its completed `wgmma` read;
// the producer announces bytes), and .release.cluster would fence every one.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t cluster_addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(cluster_addr)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx_cluster(uint32_t cluster_addr,
                                                              uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cluster.b64 _, [%0], %1;\n" ::"r"(
                   cluster_addr), "r"(bytes) : "memory");
}
// `bytes` from global memory to the same shared offset `dst` of every CTA
// in `mask`; each CTA's mbarrier at the offset of `bar` counts them
__device__ __forceinline__ void bulk_copy_g2s_multicast(void* dst, const void* src,
                                                        uint32_t bytes, uint64_t* bar,
                                                        uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)), "h"(mask) : "memory");
}

}  // namespace gmma
}  // namespace ppsurf
