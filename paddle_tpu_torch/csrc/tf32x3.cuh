// 3xTF32 on Hopper's tensor cores: the helpers the attention sources
// (csrc/flash_attention.cu, the forward; csrc/flash_attention_bwd.cu, dQ and
// dK/dV) and the conv GEMM (csrc/conv_bn_relu_mm.cu) share. The attention's
// block constants and split staging are in csrc/attention_staging.cuh.
//
// An f32 operand x is split into hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi), and a product is lo*hi + hi*lo + hi*hi on
// mma.sync.m16n8k8 tf32, accumulated in f32 (the lo*lo term is dropped): about
// 21 bits of each operand where one TF32 pass keeps 11, at a third of the
// TF32 rate, 495/3 = 165 TFLOP/s of f32-accurate products on the H100.
//
// Fragments: in an m16n8k8 step a thread (lane = 4g + t) holds A rows g and
// g + 8 at k = t and t + 4, B column g at k = t and t + 4, and the
// accumulator's rows g and g + 8 at columns 2t and 2t + 1. Taking the k index
// of a step in the order (0, 2, 4, 6, 1, 3, 5, 7) makes a thread's
// accumulator pair its A fragment (acc_frag), so a product's result feeds
// the next product from registers, with the B rows read in the same order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- tensor-core helpers ---------------------------------------------------------

// cvt.rna.tf32.f32 as bits, in two integer operations: round to nearest,
// ties away from zero, to 10 mantissa bits (add half of the dropped 13
// bits' range to the magnitude, then clear them). Equal to the instruction
// for every finite input, and cheaper on the H100.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// hi = tf32(x), lo = tf32(x - hi): x - hi is exact in f32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32, the small terms first: b's two elements come split,
// (hi0, hi1) and (lo0, lo1)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// The A fragment (16 rows x 8 of the d axis at d0) of rows held split in
// shared memory, SD floats apart.
template <int SD>
__device__ __forceinline__ void a_frag(const uint32_t* hi_rows, const uint32_t* lo_rows, int d0,
                                       int g, int t, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int o[4] = {g * SD + d0 + t, (g + 8) * SD + d0 + t, g * SD + d0 + t + 4,
                    (g + 8) * SD + d0 + t + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = hi_rows[o[i]];
    lo[i] = lo_rows[o[i]];
  }
}

// The A fragment of an 8-column block of accumulators (columns in the
// order 0, 2, 4, 6, 1, 3, 5, 7), split into hi/lo.
__device__ __forceinline__ void acc_frag(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  split4(a, hi, lo);
}

// A streamed tile split once for every warp: hi and lo halves, SD apart.
struct Split {
  uint32_t* hi;
  uint32_t* lo;
};

// B elements (o, o + step) of a split tile into mma3
__device__ __forceinline__ void mma3_b(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const Split& b, int o, int step) {
  mma3(d, ah, al, b.hi[o], b.hi[o + step], b.lo[o], b.lo[o + step]);
}

}  // namespace
