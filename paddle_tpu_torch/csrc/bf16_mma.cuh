// bf16 on Hopper's tensor cores: the helpers of the bf16 attention kernels
// (csrc/flash_attention_bf16.cu, the forward; csrc/flash_attention_bwd_bf16.cu,
// dQ and dK/dV).
//
// Products run on mma.sync.m16n8k16 with bf16 operands and f32 accumulators,
// one pass: the H100's dense bf16 rate is 989 TFLOP/s. Fragments (PTX ISA,
// "Matrix Fragments for mma.m16n8k16"): a thread (lane = 4g + t) holds A
// rows g and g + 8 at k = 2t, 2t + 1 (a0, a1) and k = 2t + 8, 2t + 9
// (a2, a3), B column g at k = 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1), and
// the accumulator's rows g and g + 8 at columns 2t and 2t + 1. So the
// accumulators of two neighbouring 8-column tiles, rounded to bf16 and
// packed in pairs, are the A fragment of the next product over those 16
// columns, in their natural order.
//
// Tiles sit in shared memory as bf16 rows of D values padded to D + 8, so
// the eight 16-byte rows an ldmatrix reads land on distinct bank groups.
// They are staged by cp.async, 16 bytes a copy, rows past the sequence
// filled with zeros by the copy itself.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // rows a block owns
constexpr int kThreads = 128;  // 4 warps of 16 rows

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a * b, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed on its way into the registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two f32 rounded to nearest-even bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment (16 rows, k over 16 columns) made of the accumulators of
// two neighbouring 8-column tiles, rounded to bf16
__device__ __forceinline__ void acc_to_a(const float (&c0)[4], const float (&c1)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// -- fragments from a tile of rows (row r at base + r * SD) --------------------

// A fragment of rows [r0, r0 + 16) at k in [k0, k0 + 16): rows are the
// mma's rows, the row's values its k
template <int SD>
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const bf16* base, int r0, int k0,
                                       int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, base + (r0 + (m & 1) * 8 + r) * SD + k0 + (m >> 1) * 8);
}

// B fragments of two 8-column tiles whose columns are rows [n0, n0 + 16)
// of the tile and whose k is the row's values [k0, k0 + 16): b[0], b[1]
// for rows n0..n0+7, b[2], b[3] for n0+8..n0+15
template <int SD>
__device__ __forceinline__ void b_rows(uint32_t (&b)[4], const bf16* base, int n0, int k0,
                                       int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldmatrix_x4(b, base + (n0 + (m >> 1) * 8 + r) * SD + k0 + (m & 1) * 8);
}

// B fragments of two 8-column tiles whose columns are the row values
// [n0, n0 + 16) and whose k is rows [k0, k0 + 16) (the tile transposed):
// b[0], b[1] for columns n0..n0+7, b[2], b[3] for n0+8..n0+15
template <int SD>
__device__ __forceinline__ void b_cols(uint32_t (&b)[4], const bf16* base, int k0, int n0,
                                       int lane) {
  const int m = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(b, base + (k0 + (m & 1) * 8 + r) * SD + n0 + (m >> 1) * 8);
}

// -- staging --------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(bf16* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + R) of a [l, D] bf16 matrix into a tile R x (D + 8); rows
// at or past l are zeros
template <int D, int R>
__device__ __forceinline__ void stage_rows(bf16* tile, const bf16* base, int r0, int l) {
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  static_assert((R * kChunks) % kThreads == 0, "a tile is whole chunks for every thread");
#pragma unroll
  for (int j = 0; j < R * kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = r0 + r < l;
    cp_async16(tile + r * (D + 8) + c * 8, base + (int64_t)(valid ? r0 + r : 0) * D + c * 8,
               valid);
  }
}

}  // namespace
