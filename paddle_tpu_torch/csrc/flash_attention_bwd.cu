// Flash-attention backward for Hopper (sm_90a), float32: a dQ kernel and
// a dK/dV kernel.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py _pallas_bwd (dQ over
// query tiles, _dq_core; dK/dV over key tiles, _dkv_core) and
// _pallas_bwd_small (all three in one pass, taken on the TPU for short
// sequences). From the forward's per-row logsumexp `lse` and
// delta = rowsum(dO * O) both recompute the probabilities
//   P = exp(scale * q k^T [causal-masked] + bias - lse)
// and, with the dropout mask M (kept entries scaled by 1/(1-rate)),
//   dP = (dO v^T) o M,  dS = P o (dP - delta),
//   dQ = scale * dS k,  dK = scale * dS^T q,  dV = (P o M)^T dO.
//
// Bound on the H100: arithmetic on the FP32 units. The dQ kernel does
// 6*Lq*Lk*D flops per head (S, dP, dQ) and the dK/dV kernel 8*Lq*Lk*D
// (S, dP, dV, dK): the split recomputes S and dP in both, which buys
// writes without atomics.
//
// Design: the forward's layout. One dQ block per (batch*head, 64 query
// rows), walking key tiles staged in shared memory; one dK/dV block per
// (batch*head, 64 key rows), walking query tiles (q, dO, lse, delta)
// staged in shared memory. D/32 threads share a row and keep its 32 dims
// of every row operand and accumulator in registers, meeting through warp
// shuffles for the dot products. Every block writes its own rows of dQ or
// dK/dV, so no atomics: the gradients repeat bit for bit. The bias is read
// through its strides, so a [B,1,1,Lk] mask is never expanded; causal
// tiles that no row sees are skipped; ragged Lq/Lk are masked. The small
// TPU variant needs no kernel of its own: the same two cover short
// sequences.
//
// Dropout: the mask is the forward's, regenerated from the same Philox
// counter (philox.cuh). A dQ thread walks keys along its query row, so one
// Philox call gives it 4 consecutive keys. A dK/dV thread walks query rows
// down its key column: the 4 threads of 4 neighbouring keys each draw the
// words of one of 4 query rows and trade them through 4 shuffles, so each
// call is used in full there too.
//
// Causal rows that see no key (Lq > Lk): the plain softmax over their
// all -1e30 scores is uniform, 1/Lk per key, and the masked scores pass
// no gradient to q or k. The kernels give such rows P = 1/Lk (the lse of
// -1e30 + log(Lk) rounds to -1e30 in f32 and cannot) and no dS.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kBlockQ = 64;  // query rows per dQ block
constexpr int kBlockK = 64;  // key rows per dK/dV block
constexpr int kChunk = 4;    // keys per inner step of the dQ kernel (one Philox call)
constexpr int kVec = 8;      // float4 chunks of a row a thread holds (32 dims)

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x += a * x.x;
  acc.y += a * x.y;
  acc.z += a * x.z;
  acc.w += a * x.w;
}

template <int kTpr>
__device__ __forceinline__ float row_sum(float part) {
#pragma unroll
  for (int o = kTpr / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  return part;
}

template <int D, int BK, bool kDrop>
__global__ void __launch_bounds__(kBlockQ * (D / 32))
    flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ bias,
                                  int64_t sb, int64_t sh, int64_t sq, int64_t sk,
                                  const float* __restrict__ dout, const float* __restrict__ lse,
                                  const float* __restrict__ delta, float* __restrict__ dq,
                                  int heads, int lq, int lk, float scale, int causal,
                                  const uint32_t* __restrict__ seed, uint32_t threshold,
                                  float inv_keep) {
  constexpr int kTpr = D / 32;  // threads per query row
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
  const int64_t row = (int64_t)bh * lq + iq_safe;
  const float4* qrow = reinterpret_cast<const float4*>(q + row * D);
  const float4* dorow = reinterpret_cast<const float4*>(dout + row * D);
  float4 qr[kVec], dor[kVec], acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    qr[c] = qrow[sub + kTpr * c];
    dor[c] = dorow[sub + kTpr * c];
    acc[c] = zero;
  }
  const float lse_i = lse[row];
  const float delta_i = delta[row];
  const float* brow =
      bias == nullptr ? nullptr : bias + b * sb + hd * sh + (int64_t)iq_safe * sq;
  uint32_t key0 = 0, key1 = 0;
  if (kDrop) {
    key0 = seed[0];
    key1 = seed[1];
  }

  const int shift = lk - lq;
  const bool row_dead = causal && iq_safe + shift < 0;  // sees no key: no dS at all
  int n_keys = lk;  // the forward's causal skipping
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
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = ks + (j0 + jj) * kRowVec;
        const float4* vr = vs + (j0 + jj) * kRowVec;
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          ps += dot4(qr[c], kr[sub + kTpr * c]);
          pd += dot4(dor[c], vr[sub + kTpr * c]);
        }
        s[jj] = row_sum<kTpr>(ps);
        dp[jj] = row_sum<kTpr>(pd);
      }
      uint4 bits[kChunk / 4];
      if (kDrop) {
#pragma unroll
        for (int g = 0; g < kChunk / 4; ++g)
          bits[g] = ptt::philox4x32_10(
              make_uint4((uint32_t)((k0 + j0) / 4 + g), (uint32_t)iq_safe, (uint32_t)bh, 0u),
              key0, key1);
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int ik = k0 + j0 + jj;
        float ds = 0.f;  // keys past lk and causal-masked scores pass no gradient
        if (ik < lk && !row_dead && !(causal && ik > iq_safe + shift)) {
          float sc = s[jj] * scale;
          if (brow != nullptr) sc += brow[(int64_t)ik * sk];
          const float p = expf(sc - lse_i);
          float dpv = dp[jj];
          if (kDrop) dpv = ptt::word(bits[jj / 4], jj % 4) >= threshold ? dpv * inv_keep : 0.f;
          ds = p * (dpv - delta_i);
        }
        s[jj] = ds;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = ks + (j0 + jj) * kRowVec;
#pragma unroll
        for (int c = 0; c < kVec; ++c) axpy4(acc[c], s[jj], kr[sub + kTpr * c]);
      }
    }
  }

  if (row_ok) {
    float4* out = reinterpret_cast<float4*>(dq + ((int64_t)bh * lq + iq) * D);
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      out[sub + kTpr * c] =
          make_float4(acc[c].x * scale, acc[c].y * scale, acc[c].z * scale, acc[c].w * scale);
  }
}

template <int D, int BQ, bool kDrop>
__global__ void __launch_bounds__(kBlockK * (D / 32))
    flash_attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ bias,
                                   int64_t sb, int64_t sh, int64_t sq, int64_t sk,
                                   const float* __restrict__ dout, const float* __restrict__ lse,
                                   const float* __restrict__ delta, float* __restrict__ dk,
                                   float* __restrict__ dv, int heads, int lq, int lk, float scale,
                                   int causal, const uint32_t* __restrict__ seed,
                                   uint32_t threshold, float inv_keep) {
  constexpr int kTpr = D / 32;  // threads per key row
  constexpr int kRowVec = D / 4;
  static_assert(BQ % 4 == 0, "query tiles hold whole groups of 4 rows");
  static_assert(32 % (4 * kTpr) == 0, "the 4 threads trading Philox words share a warp");
  __shared__ float4 qs[BQ * kRowVec];
  __shared__ float4 dos[BQ * kRowVec];
  __shared__ float lses[BQ];
  __shared__ float deltas[BQ];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int hd = bh % heads;
  const int k0 = blockIdx.y * kBlockK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int sub = tid % kTpr;
  const int jr = tid / kTpr;
  const int quad = jr & 3;  // this key's place among 4 neighbours
  const int ik = k0 + jr;
  const bool col_ok = ik < lk;
  const int ik_safe = col_ok ? ik : 0;  // out-of-range keys compute on key 0, store nothing

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t col = (int64_t)bh * lk + ik_safe;
  const float4* krow = reinterpret_cast<const float4*>(k + col * D);
  const float4* vrow = reinterpret_cast<const float4*>(v + col * D);
  float4 kr[kVec], vr[kVec], dka[kVec], dva[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    kr[c] = krow[sub + kTpr * c];
    vr[c] = vrow[sub + kTpr * c];
    dka[c] = zero;
    dva[c] = zero;
  }
  const float* bcol =
      bias == nullptr ? nullptr : bias + b * sb + hd * sh + (int64_t)ik_safe * sk;
  uint32_t key0 = 0, key1 = 0;
  if (kDrop) {
    key0 = seed[0];
    key1 = seed[1];
  }

  const int shift = lk - lq;
  // causal: query rows before k0 - shift see none of this block's keys.
  // With Lq > Lk (shift < 0) the first rows see no key and so, uniformly,
  // every key: nothing is skipped then.
  int q_begin = 0;
  if (causal && shift >= 0) q_begin = max(0, k0 - shift) / BQ * BQ;
  const float inv_lk = 1.0f / (float)lk;

  const float4* qbase = reinterpret_cast<const float4*>(q + (int64_t)bh * lq * D);
  const float4* dobase = reinterpret_cast<const float4*>(dout + (int64_t)bh * lq * D);
  for (int t0 = q_begin; t0 < lq; t0 += BQ) {
    __syncthreads();  // every key is done with the previous tile
    for (int i = tid; i < BQ * kRowVec; i += blockDim.x) {
      const bool ok = t0 + i / kRowVec < lq;
      const int64_t g = (int64_t)t0 * kRowVec + i;
      qs[i] = ok ? qbase[g] : zero;
      dos[i] = ok ? dobase[g] : zero;
    }
    for (int i = tid; i < BQ; i += blockDim.x) {
      const bool ok = t0 + i < lq;
      lses[i] = ok ? lse[(int64_t)bh * lq + t0 + i] : 0.f;
      deltas[i] = ok ? delta[(int64_t)bh * lq + t0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int i4 = 0; i4 < BQ; i4 += 4) {
      // bits of rows t0+i4 .. t0+i4+3 at this key: this thread draws row
      // t0+i4+quad for the 4 keys of its quad, then the 4 threads trade
      uint32_t b0 = 0u, b1 = 0u, b2 = 0u, b3 = 0u;
      if (kDrop) {
        const uint4 w = ptt::philox4x32_10(
            make_uint4((uint32_t)(ik >> 2), (uint32_t)(t0 + i4 + quad), (uint32_t)bh, 0u), key0,
            key1);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int src = (quad + t) & 3;  // the thread that drew row t0+i4+src
          const uint32_t got = __shfl_sync(0xffffffffu, ptt::word(w, (quad - t) & 3),
                                           lane + (src - quad) * kTpr);
          b0 = src == 0 ? got : b0;
          b1 = src == 1 ? got : b1;
          b2 = src == 2 ? got : b2;
          b3 = src == 3 ? got : b3;
        }
      }
      // one row at a time: unrolled, the compiler would hold 4 rows of q
      // and dO in registers beside k, v, dK and dV, and spill
#pragma unroll 1
      for (int r = 0; r < 4; ++r) {
        const uint32_t bits_r = r == 0 ? b0 : r == 1 ? b1 : r == 2 ? b2 : b3;
        const int i = i4 + r;
        const int iq = t0 + i;
        const float4* qr = qs + i * kRowVec;
        const float4* dor = dos + i * kRowVec;
        float ps = 0.f, pd = 0.f;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          ps += dot4(qr[sub + kTpr * c], kr[c]);
          pd += dot4(dor[sub + kTpr * c], vr[c]);
        }
        const float s = row_sum<kTpr>(ps);
        const float dp = row_sum<kTpr>(pd);
        float pv = 0.f, ds = 0.f;
        if (iq < lq) {
          const bool masked = causal && ik > iq + shift;
          float p = 0.f;  // a masked score's probability underflows to 0 ...
          if (causal && iq + shift < 0) {
            p = inv_lk;  // ... except in a row that sees no key at all
          } else if (!masked) {
            float sc = s * scale;
            if (bcol != nullptr) sc += bcol[(int64_t)iq * sq];
            p = expf(sc - lses[i]);
          }
          float dpv = dp;
          pv = p;
          if (kDrop) {
            const bool keep = bits_r >= threshold;
            pv = keep ? p * inv_keep : 0.f;
            dpv = keep ? dp * inv_keep : 0.f;
          }
          if (!masked) ds = p * (dpv - deltas[i]);
        }
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          axpy4(dva[c], pv, dor[sub + kTpr * c]);
          axpy4(dka[c], ds, qr[sub + kTpr * c]);
        }
      }
    }
  }

  if (col_ok) {
    float4* dko = reinterpret_cast<float4*>(dk + ((int64_t)bh * lk + ik) * D);
    float4* dvo = reinterpret_cast<float4*>(dv + ((int64_t)bh * lk + ik) * D);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      dko[sub + kTpr * c] = make_float4(dka[c].x * scale, dka[c].y * scale, dka[c].z * scale,
                                        dka[c].w * scale);
      dvo[sub + kTpr * c] = dva[c];
    }
  }
}

struct Args {
  const float *q, *k, *v, *bias;
  int64_t sb, sh, sq, sk;
  const float *dout, *lse, *delta;
  int batch, heads, lq, lk;
  float scale;
  int causal;
  const uint32_t* seed;
  uint32_t threshold;
  float inv_keep;
};

template <int D, int BK>
int launch_dq(const Args& a, float* dq, cudaStream_t stream) {
  const dim3 grid((unsigned)(a.batch * a.heads), (unsigned)((a.lq + kBlockQ - 1) / kBlockQ));
  auto* kernel = a.seed == nullptr ? flash_attention_bwd_dq_kernel<D, BK, false>
                                   : flash_attention_bwd_dq_kernel<D, BK, true>;
  kernel<<<grid, kBlockQ * (D / 32), 0, stream>>>(a.q, a.k, a.v, a.bias, a.sb, a.sh, a.sq, a.sk,
                                                 a.dout, a.lse, a.delta, dq, a.heads, a.lq, a.lk,
                                                 a.scale, a.causal, a.seed, a.threshold,
                                                 a.inv_keep);
  return (int)cudaGetLastError();
}

template <int D, int BQ>
int launch_dkv(const Args& a, float* dk, float* dv, cudaStream_t stream) {
  const dim3 grid((unsigned)(a.batch * a.heads), (unsigned)((a.lk + kBlockK - 1) / kBlockK));
  auto* kernel = a.seed == nullptr ? flash_attention_bwd_dkv_kernel<D, BQ, false>
                                   : flash_attention_bwd_dkv_kernel<D, BQ, true>;
  kernel<<<grid, kBlockK * (D / 32), 0, stream>>>(a.q, a.k, a.v, a.bias, a.sb, a.sh, a.sq, a.sk,
                                                 a.dout, a.lse, a.delta, dk, dv, a.heads, a.lq,
                                                 a.lk, a.scale, a.causal, a.seed, a.threshold,
                                                 a.inv_keep);
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* bias, int64_t sb,
               int64_t sh, int64_t sq, int64_t sk, const void* dout, const void* lse,
               const void* delta, int batch, int heads, int lq, int lk, float scale, int causal,
               const void* seed, uint32_t threshold, float inv_keep) {
  return Args{static_cast<const float*>(q),     static_cast<const float*>(k),
              static_cast<const float*>(v),     static_cast<const float*>(bias),
              sb,                               sh,
              sq,                               sk,
              static_cast<const float*>(dout),  static_cast<const float*>(lse),
              static_cast<const float*>(delta), batch,
              heads,                            lq,
              lk,                               scale,
              causal,                           static_cast<const uint32_t*>(seed),
              threshold,                        inv_keep};
}

}  // namespace

// Shapes as the forward's: q/dout/dq [B*H, Lq, D], k/v/dk/dv [B*H, Lk, D],
// lse/delta [B*H, Lq], all float32 and contiguous; bias NULL or addressed
// as bias[b*sb + h*sh + iq*sq + ik*sk]; seed NULL (no dropout) or the
// forward's two uint32 words on the device. Each returns
// cudaGetLastError() after its launch.
extern "C" int ptt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* bias, int64_t sb, int64_t sh, int64_t sq,
                                          int64_t sk, const void* dout, const void* lse,
                                          const void* delta, void* dq, int batch, int heads,
                                          int lq, int lk, int d, float scale, int causal,
                                          const void* seed, uint32_t threshold, float inv_keep,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0 || lq == 0 || lk == 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, bias, sb, sh, sq, sk, dout, lse, delta, batch, heads, lq, lk,
                           scale, causal, seed, threshold, inv_keep);
  float* out = static_cast<float*>(dq);
  switch (d) {
    case 32:
      return launch_dq<32, 64>(a, out, s);
    case 64:
      return launch_dq<64, 64>(a, out, s);
    case 128:
      return launch_dq<128, 32>(a, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ptt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* bias, int64_t sb, int64_t sh, int64_t sq,
                                           int64_t sk, const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int batch,
                                           int heads, int lq, int lk, int d, float scale,
                                           int causal, const void* seed, uint32_t threshold,
                                           float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0 || lq == 0 || lk == 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, bias, sb, sh, sq, sk, dout, lse, delta, batch, heads, lq, lk,
                           scale, causal, seed, threshold, inv_keep);
  float* dko = static_cast<float*>(dk);
  float* dvo = static_cast<float*>(dv);
  switch (d) {
    case 32:
      return launch_dkv<32, 64>(a, dko, dvo, s);
    case 64:
      return launch_dkv<64, 64>(a, dko, dvo, s);
    case 128:
      return launch_dkv<128, 32>(a, dko, dvo, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
