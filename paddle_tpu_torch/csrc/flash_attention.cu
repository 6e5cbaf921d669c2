// Flash-attention forward for Hopper (sm_90a), float32.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py _fwd_core/_pallas_fwd
// (the tiled kernel) and _fwd_small_core/_pallas_fwd_small (one program
// per batch item, taken on the TPU for short sequences): both compute
//   out = softmax(scale * q k^T [causal-masked] + bias) v,   lse = m + log(l)
// over [B, H, L, D] operands without storing the [Lq, Lk] score matrix.
//
// Bound on the H100: arithmetic. At L=512, D=64 a query row does 4*Lk*D
// flops per 2*D floats of output, so the FP32 units (67 TFLOP/s without
// tensor cores) limit it long before device memory does.
//
// Design: one block per (batch*head, tile of 64 query rows). D/32 threads
// share a query row; each keeps its 32 dims of q and of the f32
// accumulator in registers and meets the others through warp shuffles for
// the q.k dot product. K/V tiles of BK keys are staged through shared
// memory once per block and read by all 64 rows, and a running max m, a
// denominator l and the accumulator give the online softmax, updated every
// 16 keys. Blocks run in any order: nothing carries between them, unlike
// the TPU grid's sequential steps. The bias is read through its strides
// (stride 0 on broadcast dims), so a [B,1,1,Lk] padding mask is never
// expanded. Causal tiles past a block's last row are skipped; ragged Lq
// and Lk are masked, so any length works.
//
// Dropout (upscale in train): the softmax denominator sums the undropped
// probabilities, then the kept ones are scaled by 1/(1-rate) on their way
// into the accumulator, as in the TPU kernel. An entry is dropped where
// its 32 Philox bits (philox.cuh, keyed by the seed the wrapper drew and
// counted by (key column / 4, query row, batch*head)) fall below
// rate * 2^32; one call covers 4 keys of a chunk. The TPU kernel re-seeded
// its hardware PRNG per tile; the counter keying makes the mask
// independent of tiling, so the backward kernels regenerate it exactly.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kChunk = 16;  // keys per online-softmax update
constexpr float kNegInf = -1e30f;  // the TPU kernel's causal fill value

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int D, int BK, bool kDrop>
__global__ void __launch_bounds__(kBlockQ * (D / 32))
    flash_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               int64_t sb, int64_t sh, int64_t sq, int64_t sk,
                               float* __restrict__ out, float* __restrict__ lse, int heads,
                               int lq, int lk, float scale, int causal,
                               const uint32_t* __restrict__ seed, uint32_t threshold,
                               float inv_keep) {
  constexpr int kTpr = D / 32;  // threads per query row
  constexpr int kVec = 8;       // float4 chunks of q / acc per thread (32 dims)
  constexpr int kRowVec = D / 4;
  static_assert(BK % kChunk == 0 && kChunk % 4 == 0, "tile must hold whole chunks");
  __shared__ float4 ks[BK * kRowVec];
  __shared__ float4 vs[BK * kRowVec];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int hd = bh % heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int sub = tid % kTpr;
  const int iq = q0 + tid / kTpr;
  const bool row_ok = iq < lq;
  const int iq_safe = row_ok ? iq : 0;  // out-of-range rows compute on row 0, store nothing

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* qrow = reinterpret_cast<const float4*>(q + ((int64_t)bh * lq + iq_safe) * D);
  float4 qr[kVec];
  float4 acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    qr[c] = qrow[sub + kTpr * c];
    acc[c] = zero;
  }
  float m = kNegInf;
  float l = 0.f;
  const float* brow =
      bias == nullptr ? nullptr : bias + b * sb + hd * sh + (int64_t)iq_safe * sq;
  uint32_t key0 = 0, key1 = 0;
  if (kDrop) {
    key0 = seed[0];
    key1 = seed[1];
  }

  // causal: key ik is visible to row iq when ik <= iq + (lk - lq). Tiles past
  // the block's last row are skipped, but only when every row of the block
  // sees at least key 0: a fully masked row must still see all keys, so its
  // softmax comes out uniform exactly as in the plain version.
  const int shift = lk - lq;
  int n_keys = lk;
  if (causal && q0 + shift >= 0) n_keys = min(lk, q0 + kBlockQ + shift);
  const int n_tiles = (n_keys + BK - 1) / BK;

  const float4* kbase = reinterpret_cast<const float4*>(k + (int64_t)bh * lk * D);
  const float4* vbase = reinterpret_cast<const float4*>(v + (int64_t)bh * lk * D);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every row is done with the previous tile
    for (int i = tid; i < BK * kRowVec; i += blockDim.x) {
      const bool ok = k0 + i / kRowVec < lk;
      const int64_t g = (int64_t)k0 * kRowVec + i;
      ks[i] = ok ? kbase[g] : zero;
      vs[i] = ok ? vbase[g] : zero;
    }
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = ks + (j0 + jj) * kRowVec;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < kVec; ++c) part += dot4(qr[c], kr[sub + kTpr * c]);
#pragma unroll
        for (int o = kTpr / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        const int ik = k0 + j0 + jj;
        float sc = -INFINITY;  // keys past lk contribute nothing
        if (ik < lk) {
          sc = part * scale;  // scale before the bias, as the TPU kernel does
          if (causal && ik > iq_safe + shift) sc = kNegInf;
          if (brow != nullptr) sc += brow[(int64_t)ik * sk];
        }
        s[jj] = sc;
        cmax = fmaxf(cmax, sc);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
      l = l * corr + psum;
      if (kDrop) {  // the kept probabilities, upscaled, feed the accumulator
#pragma unroll
        for (int g = 0; g < kChunk / 4; ++g) {
          const uint4 bits = ptt::philox4x32_10(
              make_uint4((uint32_t)((k0 + j0) / 4 + g), (uint32_t)iq_safe, (uint32_t)bh, 0u),
              key0, key1);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            float& p = s[4 * g + t];
            p = ptt::word(bits, t) >= threshold ? p * inv_keep : 0.f;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        acc[c].x *= corr;
        acc[c].y *= corr;
        acc[c].z *= corr;
        acc[c].w *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* vr = vs + (j0 + jj) * kRowVec;
        const float p = s[jj];
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float4 vv = vr[sub + kTpr * c];
          acc[c].x += p * vv.x;
          acc[c].y += p * vv.y;
          acc[c].z += p * vv.z;
          acc[c].w += p * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float lsafe = l == 0.f ? 1.f : l;  // the TPU kernel's l == 0 guard
    float4* orow = reinterpret_cast<float4*>(out + ((int64_t)bh * lq + iq) * D);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      orow[sub + kTpr * c] = make_float4(acc[c].x / lsafe, acc[c].y / lsafe, acc[c].z / lsafe,
                                         acc[c].w / lsafe);
    }
    if (sub == 0) lse[(int64_t)bh * lq + iq] = m + logf(lsafe);
  }
}

template <int D, int BK>
int launch(const void* q, const void* k, const void* v, const void* bias, int64_t sb, int64_t sh,
           int64_t sq, int64_t sk, void* out, void* lse, int batch, int heads, int lq, int lk,
           float scale, int causal, const void* seed, uint32_t threshold, float inv_keep,
           cudaStream_t stream) {
  const dim3 grid((unsigned)(batch * heads), (unsigned)((lq + kBlockQ - 1) / kBlockQ));
  const dim3 block(kBlockQ * (D / 32));
  auto* kernel = seed == nullptr ? flash_attention_fwd_kernel<D, BK, false>
                                 : flash_attention_fwd_kernel<D, BK, true>;
  kernel<<<grid, block, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), sb, sh, sq, sk, static_cast<float*>(out),
      static_cast<float*>(lse), heads, lq, lk, scale, causal,
      static_cast<const uint32_t*>(seed), threshold, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B*H, Lq, D], k/v [B*H, Lk, D], lse [B*H, Lq], all float32 and
// contiguous; bias is NULL or float32 addressed as
// bias[b*sb + h*sh + iq*sq + ik*sk]. seed is NULL (no dropout) or two
// uint32 words on the device; an entry is kept where its Philox bits are
// >= threshold and then scaled by inv_keep. Returns cudaGetLastError()
// after the launch.
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* bias, int64_t sb, int64_t sh, int64_t sq,
                                       int64_t sk, void* out, void* lse, int batch, int heads,
                                       int lq, int lk, int d, float scale, int causal,
                                       const void* seed, uint32_t threshold, float inv_keep,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0 || lq == 0) return (int)cudaSuccess;
  switch (d) {
    case 32:
      return launch<32, 64>(q, k, v, bias, sb, sh, sq, sk, out, lse, batch, heads, lq, lk, scale,
                            causal, seed, threshold, inv_keep, s);
    case 64:
      return launch<64, 64>(q, k, v, bias, sb, sh, sq, sk, out, lse, batch, heads, lq, lk, scale,
                            causal, seed, threshold, inv_keep, s);
    case 128:
      return launch<128, 32>(q, k, v, bias, sb, sh, sq, sk, out, lse, batch, heads, lq, lk,
                             scale, causal, seed, threshold, inv_keep, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
