// Flash-attention backward for Hopper (sm_90a), bfloat16 operands on the
// tensor cores: the dQ and dK/dV kernels of the AMP path.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py _pallas_bwd (_dq_core,
// _dkv_core) and _pallas_bwd_small on bf16 q, k, v and dO, with the TPU
// kernels' rounding points. From the forward's f32 lse and
// delta = rowsum(dO * O) (f32) both recompute
//   P = exp(scale * q k^T [causal-masked] + bias - lse)        (f32)
//   dP = (dO v^T) o M,  dS = P o (dP - delta)                   (f32)
// and then dQ = scale * round(dS) k, dK = scale * round(dS)^T q and
// dV = round(P o M)^T dO, where round() is the bf16 rounding the TPU
// kernels apply before those products (ds.astype(kt.dtype),
// p_v.T.astype(do.dtype)); every product accumulates in f32 and each
// gradient is rounded to bf16 once, at the end.
//
// Bound on the H100: tensor-core work, 6*Lq*Lk*D flops a head in the dQ
// kernel (S, dP, dQ) and 8*Lq*Lk*D in the dK/dV kernel (S, dP, dV, dK) on
// mma.sync.m16n8k16 bf16 (bf16_mma.cuh), one pass, against 989 TFLOP/s.
//
// Design: csrc/flash_attention_bwd.cu's, on bf16. A block is 4 warps and
// owns 64 rows (query rows for dQ, key rows for dK/dV), 16 a warp; its own
// rows sit in shared memory for the whole kernel and the other operand
// streams through in tiles, two in flight (cp.async into a double buffer).
// S and dP (S^T and dP^T in the dK/dV kernel, keys as rows) come out in the
// accumulator layout; the softmax, bias, causal mask, dropout and dS are
// applied there in registers; rounded to bf16 they are the A fragment of the
// next product as they lie, whose B fragments (the streamed rows taken as k)
// come from ldmatrix.trans. Each block writes only its own rows: no atomics,
// and the gradients repeat bit for bit.
//
// Dropout: the mask is the forward's, regenerated from the same Philox
// counter with the f32 kernels' lane exchanges (the fragment layout is the
// same). Causal rows that see no key (Lq > Lk) get P = 1/Lk and no dS, as in
// the f32 kernels.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "philox.cuh"

namespace {

// shared memory of either kernel: the block's own two row blocks, two
// buffers of the two streamed tiles and, for the dK/dV kernel, two buffers
// of the tile's lse and delta
template <int D, int BS>
constexpr size_t smem_bytes(bool stats) {
  return (size_t)(2 * kRows + 4 * BS) * (D + 8) * sizeof(bf16) +
         (stats ? 4 * BS * sizeof(float) : 0);
}

// -- dQ ----------------------------------------------------------------------------

template <int D, int BK, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                       const bf16* __restrict__ v,
                                       const float* __restrict__ bias, int64_t sb, int64_t sh,
                                       int64_t sq, int64_t sk, const bf16* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta, bf16* __restrict__ dq,
                                       int heads, int lq, int lk, float scale, int causal,
                                       const uint32_t* __restrict__ seed, uint32_t threshold,
                                       float inv_keep) {
  constexpr int SD = D + 8, NT = BK / 8, ND = D / 8;
  static_assert(NT * 4 <= 32, "a tile's keep bits fit one word");
  static_assert(BK % 16 == 0 && D % 16 == 0, "whole k16 steps");
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // this block's query rows
  bf16* dos = qs + kRows * SD;
  bf16* ks = dos + kRows * SD;  // [2][BK][SD]
  bf16* vs = ks + 2 * BK * SD;

  const int bh = blockIdx.x, b = bh / heads, hd = bh % heads;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* kb = k + (int64_t)bh * lk * D;
  const bf16* vb = v + (int64_t)bh * lk * D;

  const int shift = lk - lq;
  int n_keys = lk;  // the forward's causal skipping
  if (causal && q0 + shift >= 0) n_keys = min(lk, q0 + kRows + shift);
  const int n_tiles = (n_keys + BK - 1) / BK;

  stage_rows<D, kRows>(qs, q + (int64_t)bh * lq * D, q0, lq);
  stage_rows<D, kRows>(dos, dout + (int64_t)bh * lq * D, q0, lq);
  stage_rows<D, BK>(ks, kb, 0, lk);
  stage_rows<D, BK>(vs, vb, 0, lk);
  cp_async_commit();

  // the two query rows of this thread's accumulators: g and g + 8 of its warp
  int iq[2];
  float lse_r[2], delta_r[2];
  bool dead[2];
  const float* brow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    iq[h] = q0 + 16 * warp + g + 8 * h;
    const int safe = iq[h] < lq ? iq[h] : 0;  // rows past lq compute on row 0, store nothing
    lse_r[h] = lse[(int64_t)bh * lq + safe];
    delta_r[h] = delta[(int64_t)bh * lq + safe];
    dead[h] = causal && safe + shift < 0;  // sees no key: no dS at all
    brow[h] = bias == nullptr ? nullptr : bias + b * sb + hd * sh + (int64_t)safe * sq;
  }
  uint32_t key0 = 0, key1 = 0;
  if (kDrop) {
    key0 = seed[0];
    key1 = seed[1];
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    const bf16* kt = ks + (tile & 1) * BK * SD;
    const bf16* vt = vs + (tile & 1) * BK * SD;
    if (tile + 1 < n_tiles) {  // the next tile into the other buffer
      stage_rows<D, BK>(ks + ((tile + 1) & 1) * BK * SD, kb, k0 + BK, lk);
      stage_rows<D, BK>(vs + ((tile + 1) & 1) * BK * SD, vb, k0 + BK, lk);
    }
    cp_async_commit();
    // this tile's bias, read while the copies are in flight
    float bv[NT][4];
    if (bias != nullptr) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ik = k0 + 8 * n + 2 * t + (e & 1);
          bv[n][e] = ik < lk ? __ldg(brow[e >> 1] + (int64_t)ik * sk) : 0.f;
        }
    }
    // this tile's dropout mask: bit 4n + e keeps element e of key block n
    uint32_t keep = 0u;
    if (kDrop) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // lanes t and t ^ 1 share a 4-key group: the even one draws row g,
        // the odd one row g + 8, and each sends the words the other needs
        const bool odd = t & 1;
        const uint4 draw = ptt::philox4x32_10(
            make_uint4((uint32_t)((k0 + 8 * n) / 4 + (t >> 1)),
                       (uint32_t)(odd ? iq[1] : iq[0]), (uint32_t)bh, 0u),
            key0, key1);
        const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? draw.x : draw.z, 1);
        const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? draw.y : draw.w, 1);
        const uint32_t w[4] = {odd ? got0 : draw.x, odd ? got1 : draw.y, odd ? draw.z : got0,
                               odd ? draw.w : got1};
#pragma unroll
        for (int e = 0; e < 4; ++e) keep |= (uint32_t)(w[e] >= threshold) << (4 * n + e);
      }
    }
    cp_async_wait<1>();  // this tile (and, the first time, the own rows) has landed
    __syncthreads();

    // S = q k^T and dP = dO v^T for this warp's 16 rows and the tile's keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t qa[4], oa[4];
      a_rows<SD>(qa, qs, 16 * warp, 16 * kd, lane);
      a_rows<SD>(oa, dos, 16 * warp, 16 * kd, lane);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t kf[4], vf[4];
        b_rows<SD>(kf, kt, 8 * n, 16 * kd, lane);
        b_rows<SD>(vf, vt, 8 * n, 16 * kd, lane);
        mma_bf16(s[n], qa, kf[0], kf[1]);
        mma_bf16(s[n + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[n], oa, vf[0], vf[1]);
        mma_bf16(dp[n + 1], oa, vf[2], vf[3]);
      }
    }

    // dS on the fragments: element e is row g + 8 * (e >> 1), key 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int ik = k0 + 8 * n + 2 * t + (e & 1);
        float ds = 0.f;  // keys past lk and causal-masked scores pass no gradient
        if (ik < lk && !dead[h] && !(causal && ik > iq[h] + shift)) {
          float sc = s[n][e] * scale;
          if (bias != nullptr) sc += bv[n][e];
          const float p = expf(sc - lse_r[h]);
          float dpv = dp[n][e];
          if (kDrop) dpv = (keep >> (4 * n + e)) & 1u ? dpv * inv_keep : 0.f;
          ds = p * (dpv - delta_r[h]);
        }
        s[n][e] = ds;
      }
    }

    // dQ += dS k over this tile's keys, dS rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], da);
#pragma unroll
      for (int c = 0; c < ND; c += 2) {
        uint32_t kf[4];
        b_cols<SD>(kf, kt, 16 * kk, 8 * c, lane);
        mma_bf16(acc[c], da, kf[0], kf[1]);
        mma_bf16(acc[c + 1], da, kf[2], kf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (iq[h] >= lq) continue;
    bf16* out = dq + ((int64_t)bh * lq + iq[h]) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      *reinterpret_cast<uint32_t*>(out + 8 * c) =
          pack_bf16(acc[c][2 * h] * scale, acc[c][2 * h + 1] * scale);
  }
}

// -- dK / dV -----------------------------------------------------------------------

template <int D, int BQ, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        const float* __restrict__ bias, int64_t sb, int64_t sh,
                                        int64_t sq, int64_t sk, const bf16* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, int heads, int lq, int lk,
                                        float scale, int causal,
                                        const uint32_t* __restrict__ seed, uint32_t threshold,
                                        float inv_keep) {
  constexpr int SD = D + 8, NT = BQ / 8, ND = D / 8;
  static_assert(NT * 4 <= 32, "a tile's keep bits fit one word");
  static_assert(BQ % 16 == 0 && D % 16 == 0, "whole k16 steps");
  static_assert(BQ <= kThreads, "one thread stages each row's lse and delta");
  extern __shared__ float4 smem4[];
  bf16* kos = reinterpret_cast<bf16*>(smem4);  // this block's key rows
  bf16* vos = kos + kRows * SD;
  bf16* qs = vos + kRows * SD;  // [2][BQ][SD]
  bf16* dos = qs + 2 * BQ * SD;
  float* lts = reinterpret_cast<float*>(dos + 2 * BQ * SD);  // [2][BQ] lse of the tile
  float* dlts = lts + 2 * BQ;                                // [2][BQ] its delta

  const int bh = blockIdx.x, b = bh / heads, hd = bh % heads;
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* qb = q + (int64_t)bh * lq * D;
  const bf16* dob = dout + (int64_t)bh * lq * D;
  const float* lb = lse + (int64_t)bh * lq;
  const float* db = delta + (int64_t)bh * lq;

  const int shift = lk - lq;
  // causal: query rows before k0 - shift see none of this block's keys.
  // With Lq > Lk (shift < 0) the first rows see no key and so, uniformly,
  // every key: nothing is skipped then.
  int q_begin = 0;
  if (causal && shift >= 0) q_begin = max(0, k0 - shift) / BQ * BQ;
  const int n_tiles = q_begin < lq ? (lq - q_begin + BQ - 1) / BQ : 0;
  const float inv_lk = 1.0f / (float)lk;

  auto stage_tile = [&](int buf, int r0) {
    stage_rows<D, BQ>(qs + buf * BQ * SD, qb, r0, lq);
    stage_rows<D, BQ>(dos + buf * BQ * SD, dob, r0, lq);
    if (threadIdx.x < BQ) {
      const int r = r0 + threadIdx.x;
      const bool valid = r < lq;  // rows past lq read as 0 and are never used
      cp_async4(lts + buf * BQ + threadIdx.x, lb + (valid ? r : 0), valid);
      cp_async4(dlts + buf * BQ + threadIdx.x, db + (valid ? r : 0), valid);
    }
  };
  stage_rows<D, kRows>(kos, k + (int64_t)bh * lk * D, k0, lk);
  stage_rows<D, kRows>(vos, v + (int64_t)bh * lk * D, k0, lk);
  if (n_tiles > 0) stage_tile(0, q_begin);
  cp_async_commit();

  // the two key rows of this thread's accumulators: g and g + 8 of its warp
  int ik[2];
  const float* bcol[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ik[h] = k0 + 16 * warp + g + 8 * h;
    const int safe = ik[h] < lk ? ik[h] : 0;  // keys past lk compute on key 0, store nothing
    bcol[h] = bias == nullptr ? nullptr : bias + b * sb + hd * sh + (int64_t)safe * sk;
  }
  uint32_t key0 = 0, key1 = 0;
  if (kDrop) {
    key0 = seed[0];
    key1 = seed[1];
  }

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = q_begin + tile * BQ;
    const int buf = tile & 1;
    const bf16* qt = qs + buf * BQ * SD;
    const bf16* dot = dos + buf * BQ * SD;
    const float* lt = lts + buf * BQ;
    const float* dlt = dlts + buf * BQ;
    if (tile + 1 < n_tiles) stage_tile((tile + 1) & 1, t0 + BQ);
    cp_async_commit();
    // this tile's bias, read while the copies are in flight
    float bv[NT][4];
    if (bias != nullptr) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int iq = t0 + 8 * n + 2 * t + (e & 1);
          bv[n][e] = iq < lq ? __ldg(bcol[e >> 1] + (int64_t)iq * sq) : 0.f;
        }
    }
    // this tile's dropout mask: bit 4n + e keeps element e of query block n
    uint32_t keep = 0u;
    if (kDrop) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // lane j = g % 4 of a 4-key group draws (key row j >> 1, query
        // 2t + (j & 1)); each needs word j of all four draws
        const int j = g & 3;
        const int key = j >> 1 ? ik[1] : ik[0];
        const uint4 draw = ptt::philox4x32_10(
            make_uint4((uint32_t)(key >> 2), (uint32_t)(t0 + 8 * n + 2 * t + (j & 1)),
                       (uint32_t)bh, 0u),
            key0, key1);
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int src = (j + r) & 3;  // the lane that drew element src
          const uint32_t got =
              __shfl_sync(0xffffffffu, ptt::word(draw, (j - r) & 3), lane + (src - j) * 4);
          w[0] = src == 0 ? got : w[0];
          w[1] = src == 1 ? got : w[1];
          w[2] = src == 2 ? got : w[2];
          w[3] = src == 3 ? got : w[3];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) keep |= (uint32_t)(w[e] >= threshold) << (4 * n + e);
      }
    }
    cp_async_wait<1>();  // this tile (and, the first time, the own rows) has landed
    __syncthreads();

    // S^T = k q^T and dP^T = v dO^T: keys as rows, this tile's queries as columns
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t ka[4], va[4];
      a_rows<SD>(ka, kos, 16 * warp, 16 * kd, lane);
      a_rows<SD>(va, vos, 16 * warp, 16 * kd, lane);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t qf[4], of[4];
        b_rows<SD>(qf, qt, 8 * n, 16 * kd, lane);
        b_rows<SD>(of, dot, 8 * n, 16 * kd, lane);
        mma_bf16(s[n], ka, qf[0], qf[1]);
        mma_bf16(s[n + 1], ka, qf[2], qf[3]);
        mma_bf16(dp[n], va, of[0], of[1]);
        mma_bf16(dp[n + 1], va, of[2], of[3]);
      }
    }

    // P o M and dS on the fragments: element e is key g + 8 * (e >> 1),
    // query 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = 8 * n + 2 * t + (e & 1);
        const int iq = t0 + col;
        float pv = 0.f, ds = 0.f;
        if (iq < lq) {
          const bool masked = causal && ik[h] > iq + shift;
          float p = 0.f;  // a masked score's probability underflows to 0 ...
          if (causal && iq + shift < 0) {
            p = inv_lk;  // ... except in a row that sees no key at all
          } else if (!masked) {
            float sc = s[n][e] * scale;
            if (bias != nullptr) sc += bv[n][e];
            p = expf(sc - lt[col]);
          }
          float dpv = dp[n][e];
          pv = p;
          if (kDrop) {
            const bool kept = (keep >> (4 * n + e)) & 1u;
            pv = kept ? p * inv_keep : 0.f;
            dpv = kept ? dpv * inv_keep : 0.f;
          }
          if (!masked) ds = p * (dpv - dlt[col]);
        }
        s[n][e] = pv;
        dp[n][e] = ds;
      }
    }

    // dV += round(P o M)^T dO and dK += round(dS)^T q over this tile's queries
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], pa);
      acc_to_a(dp[2 * kk], dp[2 * kk + 1], da);
#pragma unroll
      for (int c = 0; c < ND; c += 2) {
        uint32_t of[4], qf[4];
        b_cols<SD>(of, dot, 16 * kk, 8 * c, lane);
        b_cols<SD>(qf, qt, 16 * kk, 8 * c, lane);
        mma_bf16(acc_v[c], pa, of[0], of[1]);
        mma_bf16(acc_v[c + 1], pa, of[2], of[3]);
        mma_bf16(acc_k[c], da, qf[0], qf[1]);
        mma_bf16(acc_k[c + 1], da, qf[2], qf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (none is read when no tile is live)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (ik[h] >= lk) continue;
    const int64_t row = ((int64_t)bh * lk + ik[h]) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      *reinterpret_cast<uint32_t*>(dk + row + 8 * c) =
          pack_bf16(acc_k[c][2 * h] * scale, acc_k[c][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row + 8 * c) =
          pack_bf16(acc_v[c][2 * h], acc_v[c][2 * h + 1]);
    }
  }
}

// -- launches ----------------------------------------------------------------------

struct Args {
  const bf16 *q, *k, *v;
  const float* bias;
  int64_t sb, sh, sq, sk;
  const bf16* dout;
  const float *lse, *delta;
  int batch, heads, lq, lk;
  float scale;
  int causal;
  const uint32_t* seed;
  uint32_t threshold;
  float inv_keep;
};

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, int BK>
int launch_dq(const Args& a, bf16* dq, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BK>(false);
  const dim3 grid((unsigned)(a.batch * a.heads), (unsigned)((a.lq + kRows - 1) / kRows));
  auto* kernel = a.seed == nullptr ? flash_attention_bwd_dq_bf16_kernel<D, BK, false>
                                   : flash_attention_bwd_dq_bf16_kernel<D, BK, true>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(a.q, a.k, a.v, a.bias, a.sb, a.sh, a.sq, a.sk, a.dout,
                                           a.lse, a.delta, dq, a.heads, a.lq, a.lk, a.scale,
                                           a.causal, a.seed, a.threshold, a.inv_keep);
  return (int)cudaGetLastError();
}

template <int D, int BQ>
int launch_dkv(const Args& a, bf16* dk, bf16* dv, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ>(true);
  const dim3 grid((unsigned)(a.batch * a.heads), (unsigned)((a.lk + kRows - 1) / kRows));
  auto* kernel = a.seed == nullptr ? flash_attention_bwd_dkv_bf16_kernel<D, BQ, false>
                                   : flash_attention_bwd_dkv_bf16_kernel<D, BQ, true>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(a.q, a.k, a.v, a.bias, a.sb, a.sh, a.sq, a.sk, a.dout,
                                           a.lse, a.delta, dk, dv, a.heads, a.lq, a.lk, a.scale,
                                           a.causal, a.seed, a.threshold, a.inv_keep);
  return (int)cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* bias, int64_t sb,
               int64_t sh, int64_t sq, int64_t sk, const void* dout, const void* lse,
               const void* delta, int batch, int heads, int lq, int lk, float scale, int causal,
               const void* seed, uint32_t threshold, float inv_keep) {
  return Args{static_cast<const bf16*>(q),      static_cast<const bf16*>(k),
              static_cast<const bf16*>(v),      static_cast<const float*>(bias),
              sb,                               sh,
              sq,                               sk,
              static_cast<const bf16*>(dout),   static_cast<const float*>(lse),
              static_cast<const float*>(delta), batch,
              heads,                            lq,
              lk,                               scale,
              causal,                           static_cast<const uint32_t*>(seed),
              threshold,                        inv_keep};
}

}  // namespace

// Shapes as the forward's: q/dout/dq [B*H, Lq, D], k/v/dk/dv [B*H, Lk, D]
// bfloat16, lse/delta [B*H, Lq] float32, all contiguous; bias NULL or f32
// addressed as bias[b*sb + h*sh + iq*sq + ik*sk]; seed NULL (no dropout) or
// the forward's two uint32 words on the device. Each returns
// cudaGetLastError() after its launch (or the error of allowing its
// shared memory).
extern "C" int ptt_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                               const void* bias, int64_t sb, int64_t sh,
                                               int64_t sq, int64_t sk, const void* dout,
                                               const void* lse, const void* delta, void* dq,
                                               int batch, int heads, int lq, int lk, int d,
                                               float scale, int causal, const void* seed,
                                               uint32_t threshold, float inv_keep,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0 || lq == 0 || lk == 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, bias, sb, sh, sq, sk, dout, lse, delta, batch, heads, lq, lk,
                           scale, causal, seed, threshold, inv_keep);
  bf16* out = static_cast<bf16*>(dq);
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

extern "C" int ptt_flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                                const void* bias, int64_t sb, int64_t sh,
                                                int64_t sq, int64_t sk, const void* dout,
                                                const void* lse, const void* delta, void* dk,
                                                void* dv, int batch, int heads, int lq, int lk,
                                                int d, float scale, int causal, const void* seed,
                                                uint32_t threshold, float inv_keep,
                                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0 || lq == 0 || lk == 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, bias, sb, sh, sq, sk, dout, lse, delta, batch, heads, lq, lk,
                           scale, causal, seed, threshold, inv_keep);
  bf16* dko = static_cast<bf16*>(dk);
  bf16* dvo = static_cast<bf16*>(dv);
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
