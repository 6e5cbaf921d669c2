// Hopper's asynchronous machinery for the bf16 attention kernels
// (csrc/flash_attention_bf16.cu, the forward; csrc/flash_attention_bwd_bf16.cu,
// dQ and dK/dV) and the bf16 conv GEMM (csrc/conv_bn_relu_mm_bf16.cu): TMA
// tile loads into shared memory completed on mbarriers, warpgroup products
// (wgmma) on bf16 operands read from those tiles, and the forward's dropout
// draws. The attention reads 3-D tensor maps ([heads, rows, D]); the GEMM
// 2-D ones ([rows, cols] with a row stride), whose MN-major operand spans
// several 64-column panels in one product (desc_mn).
//
// Tiles. A [rows, D] bf16 tile of a [heads, L, D] tensor is loaded by one
// TMA copy per 64-column panel (D = 128 is two panels, D = 64 one, D = 32 one
// of 32 columns), each panel [rows][64] with the 128-byte swizzle (rows of 32
// with the 64-byte one). The tensor map is 3-D, so rows past a head's L read
// as zeros and never as the next head's first rows.
//
// Products. wgmma reads B, and A unless A is a register fragment, from such
// a panel through a descriptor: the panel's address, the swizzle, and the 8
// rows x row bytes between 8-row groups. For a tile taken with its D values
// as the product's k (q k^T: both operands K-major) a k16 step is the next 32
// bytes of the rows; for a tile taken with its rows as k (P v: B MN-major,
// imm-trans-b = 1) it is the next 16 rows. An MN-major product here never
// spans two panels (N <= 64 a wgmma), so the descriptor's leading byte offset
// is never read.
//
// Accumulators. The m64nN f32 accumulator gives warp w of the warpgroup rows
// 16w + g and 16w + g + 8 (lane = 4g + t) at columns 8n + 2t and 8n + 2t + 1
// in d[4n .. 4n + 3], as mma.m16n8's C fragment does for every 8 columns. So
// the scores of columns [16kk, 16kk + 16), rounded to bf16 and packed in
// pairs, are the A fragment of the next product's k16 step kk as they lie,
// and the f32 forward's Philox lane exchange applies unchanged.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes from cudaGetDriverEntryPoint, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConsumers = 2;                      // consumer warpgroups, 64 rows each
constexpr int kBlockRows = 64 * kConsumers;        // rows a block owns
constexpr int kThreads = 128 * (kConsumers + 1);   // and one producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65536
constexpr float kNegInf = -1e30f;                  // the TPU kernels' causal fill value
constexpr float kLog2e = 1.4426950408889634f;

// the panels of a [rows, D] tile
template <int D>
struct Panels {
  static constexpr int kW = D < 64 ? D : 64;  // columns a panel
  static constexpr int kN = D / kW;           // panels a tile
  static constexpr int kRowBytes = 2 * kW;    // 128: 128-byte swizzle; 64: 64-byte
  static_assert(D == 32 || D == 64 || D == 128, "head dims 32, 64 and 128");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// the inits visible to every thread and to the TMA unit (then __syncthreads)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more from copies before the phase completes
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ----------------------------------------------------------------------------

// box (c0, c1, c2) of a 3-D tensor map into dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// box (c0, c1) of a 2-D tensor map into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// src into box (c0, c1) of a 2-D tensor map, in this thread's bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// this thread's writes to shared memory visible to the TMA unit's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [r0, r0 + R) of head bh, every panel, into tile ([kN][R][kW])
template <int D, int R>
__device__ __forceinline__ void tma_tile(bf16* tile, const CUtensorMap* map, uint64_t* bar, int r0,
                                         int bh) {
#pragma unroll
  for (int p = 0; p < Panels<D>::kN; ++p)
    tma_load(tile + p * R * Panels<D>::kW, map, bar, p * Panels<D>::kW, r0, bh);
}

// -- wgmma ----------------------------------------------------------------------------

// the descriptor of a swizzled panel of kRowBytes-byte rows starting at p
// (1024-byte aligned tile base, plus whole rows or 32-byte k16 steps)
template <int kRowBytes>
__device__ __forceinline__ uint64_t desc(const bf16* p) {
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // 128-byte or 64-byte swizzle
  constexpr uint64_t kSbo = 8 * kRowBytes;                // bytes between 8-row groups
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((kSbo >> 4) << 32) |
         (kLayout << 62);
}

// the descriptor of an MN-major operand of 64-column panels ([k][64]
// bf16, 128-byte swizzle) lying panel_bytes apart from p (a k16 step is
// the next 16 rows): the leading byte offset steps from one 64-column
// panel to the next, so one product spans them all; 8-row groups sit 1024
// bytes apart
__device__ __forceinline__ uint64_t desc_mn(const bf16* p, uint32_t panel_bytes) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((panel_bytes >> 4) & 0x3FFF) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers an asynchronous
// product owns across the issue or the wait
template <int R>
__device__ __forceinline__ void reg_fence(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// m64n32k16: d = A B (+ d when accumulate), A from shared memory
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

// m64n64k16: d = A B (+ d when accumulate), A from shared memory
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

// m64n128k16: d = A B (+ d when accumulate), A from shared memory
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

// m64n32k16: d = A B (+ d when accumulate), A a register fragment
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
}

// m64n64k16: d = A B (+ d when accumulate), A a register fragment
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
}

// S (+)= A B^T over the D values of two K-major tiles: A this warpgroup's 64
// rows of a tile of RA rows, B all N rows of a tile (S's columns)
template <int D, int RA, int N>
__device__ __forceinline__ void product_rows(float (&s)[N / 2], const bf16* a, const bf16* b) {
  using P = Panels<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / P::kW, c = kk * 16 % P::kW;
    const uint64_t da = desc<P::kRowBytes>(a + p * RA * P::kW + c);
    const uint64_t db = desc<P::kRowBytes>(b + p * N * P::kW + c);
    if constexpr (N == 128) {
      wgmma_ss_n128<0>(s, da, db, kk > 0);
    } else if constexpr (N == 64) {
      wgmma_ss_n64<0>(s, da, db, kk > 0);
    } else {
      static_assert(N == 32, "score tiles of 32, 64 or 128 columns");
      wgmma_ss_n32<0>(s, da, db, kk > 0);
    }
  }
}

// acc += A B over the R rows of an MN-major tile b ([R, D]): A the register
// fragments of k16 steps (R / 16 of them), acc one m64 x kW block a panel
template <int D, int R>
__device__ __forceinline__ void product_cols(float (&acc)[Panels<D>::kN][Panels<D>::kW / 2],
                                             const uint32_t (&a)[R / 16][4], const bf16* b) {
  using P = Panels<D>;
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
    for (int p = 0; p < P::kN; ++p) {
      const uint64_t db = desc<P::kRowBytes>(b + p * R * P::kW + kk * 16 * P::kW);
      if constexpr (P::kW == 64) {
        wgmma_rs_n64<1>(acc[p], a[kk], db, 1);
      } else {
        wgmma_rs_n32<1>(acc[p], a[kk], db, 1);
      }
    }
}

// 2^x, flushing subnormal results to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to nearest-even bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an accumulator of N columns rounded to bf16 as the A fragments of N / 16 k16 steps
template <int N>
__device__ __forceinline__ void to_a(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// -- dropout --------------------------------------------------------------------------

// the keep bits (bit e of the result) of the four accumulator entries of an
// 8-column block when rows are queries and columns keys (the forward, dQ):
// entry e is query iq[e >> 1], key kb + 2t + (e & 1)
__device__ __forceinline__ uint32_t keep4_rows(int kb, const int (&iq)[2], int bh, int t,
                                               uint32_t key0, uint32_t key1, uint32_t threshold) {
  // lanes t and t ^ 1 share a 4-key group: the even one draws row g, the odd
  // one row g + 8, and each sends the words the other needs
  const bool odd = t & 1;
  const uint4 draw =
      ptt::philox4x32_10(make_uint4((uint32_t)(kb / 4 + (t >> 1)), (uint32_t)(odd ? iq[1] : iq[0]),
                                    (uint32_t)bh, 0u),
                         key0, key1);
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? draw.x : draw.z, 1);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? draw.y : draw.w, 1);
  const uint32_t w[4] = {odd ? got0 : draw.x, odd ? got1 : draw.y, odd ? draw.z : got0,
                         odd ? draw.w : got1};
  uint32_t keep = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) keep |= (uint32_t)(w[e] >= threshold) << e;
  return keep;
}

// the keep bits of a tile of NT 8-key blocks from key k0 when rows are
// queries (the forward, dQ), as kw[h][c]: row iq[h], key k0 + 32c + 8i + 2t + b
// at bit 8i + b (the layout of the stored mask's words shifted by 2t)
template <int NT>
__device__ __forceinline__ void draw_rows(uint32_t (&kw)[2][NT / 4], int k0, const int (&iq)[2],
                                          int bh, int t, uint32_t key0, uint32_t key1,
                                          uint32_t threshold) {
#pragma unroll
  for (int c = 0; c < NT / 4; ++c) kw[0][c] = kw[1][c] = 0u;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const uint32_t k4 = keep4_rows(k0 + 8 * n, iq, bh, t, key0, key1, threshold);
    kw[0][n / 4] |= (k4 & 3u) << (8 * (n % 4));
    kw[1][n / 4] |= (k4 >> 2) << (8 * (n % 4));
  }
}

// -- host -----------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, or null
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the tensor map of a contiguous [heads, rows, d] bf16 tensor in boxes of
// box_rows x one panel, swizzled as the descriptors read it; rows past `rows`
// load as zeros. Returns a cudaError_t.
inline int tensor_map(CUtensorMap* map, const void* base, int heads, int rows, int d,
                      int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int w = d < 64 ? d : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)w, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            w == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// the tensor map of a row-major [rows, cols] bf16 matrix whose rows lie
// row_elems apart (a multiple of 8), in boxes of box_cols (64: one
// 128-byte swizzled row) x box_rows; what lies past rows or cols loads as
// zeros. Returns a cudaError_t.
inline int tensor_map_2d(CUtensorMap* map, const void* base, int64_t rows, int cols,
                         int64_t row_elems, int box_cols, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_elems * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

// the current card's streaming multiprocessors: one persistent block each
inline int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return count;
}

// dynamic shared memory is 16-byte aligned; swizzled tiles want 1024
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

}  // namespace
