// The attention kernels' block constants and split staging
// (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu), on the 3xTF32
// helpers of tf32x3.cuh. A staged row lands in shared memory D + 4 words
// after the one before: both ways a fragment is read then hit 32 distinct
// banks (eight rows by four columns for the d contractions, four row pairs
// by eight columns for the contractions over rows).
#pragma once

#include "tf32x3.cuh"

namespace {

constexpr int kRows = 64;     // rows a block owns
constexpr int kThreads = 128;  // 4 warps of 16 rows

// -- staging ----------------------------------------------------------------------
//
// Operands are split once, as they are staged: a thread reads 16 bytes of a
// row from device memory into registers, splits them and stores the hi and
// lo halves. The next streamed tile is read into registers before the
// current one is computed on (PF float4 a thread a tensor), so its loads are
// in flight during the products; the split tile in shared memory is the
// only copy, which keeps two blocks on an SM at D = 64.

// the PF float4 of rows [r0, r0 + R) of a [l, D] matrix this thread stages;
// rows at or past l read as 0
template <int D, int R>
struct Staged {
  static constexpr int kVecs = D / 4;
  static constexpr int PF = R * kVecs / kThreads;
  static_assert(PF * kThreads == R * kVecs, "a tile is whole float4s for every thread");
  float4 v[PF];

  __device__ __forceinline__ void load(const float* base, int r0, int l) {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / kVecs;
      v[j] = r0 + r < l ? __ldg(reinterpret_cast<const float4*>(base + (int64_t)(r0 + r) * D) +
                                i % kVecs)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // split into hi and lo halves, rows D + 4 floats apart
  __device__ __forceinline__ void store(const Split& out) const {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int off = (i / kVecs) * (D + 4) + (i % kVecs) * 4;
      uint4 h, l;
      split(v[j].x, h.x, l.x);
      split(v[j].y, h.y, l.y);
      split(v[j].z, h.z, l.z);
      split(v[j].w, h.w, l.w);
      *reinterpret_cast<uint4*>(out.hi + off) = h;
      *reinterpret_cast<uint4*>(out.lo + off) = l;
    }
  }
};

// the block's own kRows rows, split into shared memory, R rows at a time
template <int D, int R>
__device__ __forceinline__ void stage_own(const float* base, int r0, int l, const Split& out) {
  Staged<D, R> st;
#pragma unroll 1
  for (int c = 0; c < kRows; c += R) {
    st.load(base, r0 + c, l);
    st.store(Split{out.hi + c * (D + 4), out.lo + c * (D + 4)});
  }
}

}  // namespace
