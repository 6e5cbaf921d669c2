// Flash-attention backward for Hopper (sm_90a), float32 on the tensor cores
// in 3xTF32: a dQ kernel and a dK/dV kernel.
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
// Bound on the H100: tensor-core work. Every product runs on
// mma.sync.m16n8k8 tf32 in 3xTF32, as PyTorch's memory-efficient attention
// does for f32 (CUTLASS's OpMultiplyAddFastF32): each f32 operand x is split
// into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and a product is
// lo*hi + hi*lo + hi*hi accumulated in f32; the lo*lo term is dropped. That
// keeps about 21 bits of each operand where one TF32 pass keeps 11, and
// costs three tensor-core passes: the ceiling is 495/3 = 165 TFLOP/s of
// f32-accurate products. The dQ kernel does 6*Lq*Lk*D flops a head (S, dP,
// dQ) and the dK/dV kernel 8*Lq*Lk*D (S, dP, dV, dK): the split recomputes
// S and dP in both, 14 units of products where one fused pass does 10, and
// in exchange every block writes only its own rows, so no atomics and the
// gradients repeat bit for bit.
//
// Design (the 3xTF32 helpers and the split staging are in tf32x3.cuh, shared
// with the forward). A block is 4 warps and owns 64 rows: query rows in the
// dQ kernel, key rows in the dK/dV kernel; each warp owns 16 of them. The block's own
// rows (q and dO, or k and v) sit in shared memory for the whole kernel; the
// other operand (k and v, or q, dO, lse and delta) streams through in tiles
// of BS rows (32 at D = 64). Every operand is split into hi/lo once, as it
// is staged into shared memory, so the products read ready halves and the
// splitting is not repeated by each warp. The next tile is read from device
// memory into registers while the current one is computed on (double
// buffering in registers: a staged copy in shared memory beside the split
// one would leave room for one block an SM, not two); rows past the
// sequence read as 0, so ragged Lq and Lk are masked, never padded. Shared
// rows are D + 4 words apart, which puts both ways a fragment is read on 32
// distinct banks: eight rows by four columns (the d-contractions), and four
// row pairs by eight columns (the contractions over rows).
//
// Each warp computes its 16 x BS tile of S and of dP in the accumulator
// layout, with the rows it owns as the mma's rows: S and dP in the dQ
// kernel, S^T and dP^T in the dK/dV kernel (keys as rows, k q^T and
// v dO^T). The softmax, bias, causal mask, dropout and dS are applied on
// those fragments in registers. The next product contracts over the
// streamed rows (dQ = dS k; dV = (P o M)^T dO, dK = dS^T q), so the same
// registers feed it as the A operand: the order of the k index inside an
// m16n8k8 step is free, and taking it as (0, 2, 4, 6, 1, 3, 5, 7) makes a
// thread's accumulator pair (columns 2t, 2t+1) exactly its A fragment
// (k = t, t + 4), with the B rows read in the same order. Nothing is
// transposed through shared memory.
//
// The bias is read through its strides, so a [B,1,1,Lk] mask is never
// expanded, and a tile's bias is read before its products, so the loads are
// in flight while they run; causal tiles that no row sees are skipped. The small TPU
// variant needs no kernel of its own: the same two cover short sequences.
//
// Dropout: the mask is the forward's, regenerated from the same Philox
// counter (philox.cuh), one call per four entries, drawn before a tile's
// products so that the integer work overlaps them, and kept as one bit an
// entry until the softmax needs it. A dQ thread holds keys
// 2t, 2t+1 of an 8-key tile in rows g and g+8: two neighbouring lanes share
// one 4-key group, so one draws row g and the other row g+8, and they trade
// two words by shuffle. A dK/dV thread holds keys g, g+8 at queries 2t,
// 2t+1: the four lanes of a 4-key group draw its 4 (row, query) calls and
// trade words in four shuffles.
//
// Causal rows that see no key (Lq > Lk): the plain softmax over their
// all -1e30 scores is uniform, 1/Lk per key, and the masked scores pass
// no gradient to q or k. The kernels give such rows P = 1/Lk (the lse of
// -1e30 + log(Lk) rounds to -1e30 in f32 and cannot) and no dS.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "tf32x3.cuh"

namespace {

// shared memory of either kernel, split into hi and lo: the block's own
// rows (2 tensors x kRows) and the streamed tile (2 tensors x BS); for the
// dK/dV kernel lse and delta of the tile besides
template <int D, int BS>
constexpr size_t smem_bytes(bool stats) {
  return (size_t)(2 * (2 * kRows + 2 * BS) * (D + 4) + (stats ? 2 * BS : 0)) * sizeof(float);
}

// -- dQ ----------------------------------------------------------------------------

template <int D, int BK, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ bias,
                                  int64_t sb, int64_t sh, int64_t sq, int64_t sk,
                                  const float* __restrict__ dout, const float* __restrict__ lse,
                                  const float* __restrict__ delta, float* __restrict__ dq,
                                  int heads, int lq, int lk, float scale, int causal,
                                  const uint32_t* __restrict__ seed, uint32_t threshold,
                                  float inv_keep) {
  constexpr int SD = D + 4, NT = BK / 8, ND = D / 8;
  extern __shared__ float4 smem4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem4);
  const Split qs{sm, sm + kRows * SD};  // this block's query rows, split
  const Split dos{sm + 2 * kRows * SD, sm + 3 * kRows * SD};
  const Split kt{sm + 4 * kRows * SD, sm + 4 * kRows * SD + BK * SD};  // this key tile, split
  const Split vt{sm + 4 * kRows * SD + 2 * BK * SD, sm + 4 * kRows * SD + 3 * BK * SD};

  const int bh = blockIdx.x, b = bh / heads, hd = bh % heads;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* kb = k + (int64_t)bh * lk * D;
  const float* vb = v + (int64_t)bh * lk * D;

  const int shift = lk - lq;
  int n_keys = lk;  // the forward's causal skipping
  if (causal && q0 + shift >= 0) n_keys = min(lk, q0 + kRows + shift);
  const int n_tiles = (n_keys + BK - 1) / BK;

  Staged<D, BK> k_next, v_next;
  k_next.load(kb, 0, lk);
  v_next.load(vb, 0, lk);
  stage_own<D, BK>(q + (int64_t)bh * lq * D, q0, lq, qs);
  stage_own<D, BK>(dout + (int64_t)bh * lq * D, q0, lq, dos);

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

  const int own = 16 * warp * SD;  // this warp's rows
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    // this tile's bias, read now and used after the products
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
    __syncthreads();  // every warp is done with the previous tile
    k_next.store(kt);
    v_next.store(vt);
    __syncthreads();  // this tile (and, the first time, the own rows) is split
    if (tile + 1 < n_tiles) {
      k_next.load(kb, k0 + BK, lk);
      v_next.load(vb, k0 + BK, lk);
    }
    // this tile's dropout mask, drawn before the products so that the
    // integer work overlaps them: bit 4n + e keeps element e of key block n
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

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 8) {
      uint32_t qh[4], ql[4], oh[4], ol[4];
      a_frag<SD>(qs.hi + own, qs.lo + own, d0, g, t, qh, ql);
      a_frag<SD>(dos.hi + own, dos.lo + own, d0, g, t, oh, ol);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int o = (8 * n + g) * SD + d0 + t;
        mma3_b(s[n], qh, ql, kt, o, 4);
        mma3_b(dp[n], oh, ol, vt, o, 4);
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

    // dQ += dS k, contracting over this tile's keys
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t dh[4], dl[4];
      acc_frag(s[n], dh, dl);
#pragma unroll
      for (int c = 0; c < ND; ++c)
        mma3_b(acc[c], dh, dl, kt, (8 * n + 2 * t) * SD + 8 * c + g, SD);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (iq[h] >= lq) continue;
    float* out = dq + ((int64_t)bh * lq + iq[h]) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      *reinterpret_cast<float2*>(out + 8 * c) =
          make_float2(acc[c][2 * h] * scale, acc[c][2 * h + 1] * scale);
  }
}

// -- dK / dV -----------------------------------------------------------------------

template <int D, int BQ, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ bias,
                                   int64_t sb, int64_t sh, int64_t sq, int64_t sk,
                                   const float* __restrict__ dout, const float* __restrict__ lse,
                                   const float* __restrict__ delta, float* __restrict__ dk,
                                   float* __restrict__ dv, int heads, int lq, int lk, float scale,
                                   int causal, const uint32_t* __restrict__ seed,
                                   uint32_t threshold, float inv_keep) {
  constexpr int SD = D + 4, NT = BQ / 8, ND = D / 8;
  extern __shared__ float4 smem4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem4);
  const Split kos{sm, sm + kRows * SD};  // this block's key rows, split
  const Split vos{sm + 2 * kRows * SD, sm + 3 * kRows * SD};
  const Split qt{sm + 4 * kRows * SD, sm + 4 * kRows * SD + BQ * SD};  // this query tile, split
  const Split dot{sm + 4 * kRows * SD + 2 * BQ * SD, sm + 4 * kRows * SD + 3 * BQ * SD};
  float* lt = reinterpret_cast<float*>(sm + 4 * (kRows + BQ) * SD);  // [BQ] lse of the tile
  float* dlt = lt + BQ;                                                // [BQ] its delta

  const int bh = blockIdx.x, b = bh / heads, hd = bh % heads;
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* qb = q + (int64_t)bh * lq * D;
  const float* dob = dout + (int64_t)bh * lq * D;
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

  static_assert(BQ <= kThreads, "one thread stages each row's lse and delta");
  Staged<D, BQ> q_next, do_next;
  float l_next = 0.f, dl_next = 0.f;
  auto load_next = [&](int r0) {
    q_next.load(qb, r0, lq);
    do_next.load(dob, r0, lq);
    if (threadIdx.x < BQ && r0 + (int)threadIdx.x < lq) {
      l_next = lb[r0 + threadIdx.x];
      dl_next = db[r0 + threadIdx.x];
    }
  };
  load_next(q_begin);
  stage_own<D, BQ>(k + (int64_t)bh * lk * D, k0, lk, kos);
  stage_own<D, BQ>(v + (int64_t)bh * lk * D, k0, lk, vos);

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

  const int own = 16 * warp * SD;  // this warp's rows
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = q_begin + tile * BQ;
    // this tile's bias, read now and used after the products
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
    __syncthreads();  // every warp is done with the previous tile
    q_next.store(qt);
    do_next.store(dot);
    if (threadIdx.x < BQ) {
      lt[threadIdx.x] = l_next;  // rows past lq are never read
      dlt[threadIdx.x] = dl_next;
    }
    __syncthreads();  // this tile (and, the first time, the own rows) is split
    if (tile + 1 < n_tiles) load_next(t0 + BQ);
    // this tile's dropout mask, drawn before the products so that the
    // integer work overlaps them: bit 4n + e keeps element e of query block n
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

    // S^T = k q^T and dP^T = v dO^T: keys as rows, this tile's queries as columns
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 8) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      a_frag<SD>(kos.hi + own, kos.lo + own, d0, g, t, kh, kl);
      a_frag<SD>(vos.hi + own, vos.lo + own, d0, g, t, vh, vl);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int o = (8 * n + g) * SD + d0 + t;
        mma3_b(s[n], kh, kl, qt, o, 4);
        mma3_b(dp[n], vh, vl, dot, o, 4);
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

    // dV += (P o M)^T dO and dK += dS^T q, contracting over this tile's queries
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      acc_frag(s[n], ph, pl);
      acc_frag(dp[n], dh, dl);
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const int o = (8 * n + 2 * t) * SD + 8 * c + g;
        mma3_b(acc_v[c], ph, pl, dot, o, SD);
        mma3_b(acc_k[c], dh, dl, qt, o, SD);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (ik[h] >= lk) continue;
    const int64_t row = ((int64_t)bh * lk + ik[h]) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      *reinterpret_cast<float2*>(dk + row + 8 * c) =
          make_float2(acc_k[c][2 * h] * scale, acc_k[c][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv + row + 8 * c) =
          make_float2(acc_v[c][2 * h], acc_v[c][2 * h + 1]);
    }
  }
}

// -- launches ----------------------------------------------------------------------

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

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, int BK>
int launch_dq(const Args& a, float* dq, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BK>(false);
  const dim3 grid((unsigned)(a.batch * a.heads), (unsigned)((a.lq + kRows - 1) / kRows));
  auto* kernel = a.seed == nullptr ? flash_attention_bwd_dq_kernel<D, BK, false>
                                   : flash_attention_bwd_dq_kernel<D, BK, true>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(a.q, a.k, a.v, a.bias, a.sb, a.sh, a.sq, a.sk, a.dout,
                                           a.lse, a.delta, dq, a.heads, a.lq, a.lk, a.scale,
                                           a.causal, a.seed, a.threshold, a.inv_keep);
  return (int)cudaGetLastError();
}

template <int D, int BQ>
int launch_dkv(const Args& a, float* dk, float* dv, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ>(true);
  const dim3 grid((unsigned)(a.batch * a.heads), (unsigned)((a.lk + kRows - 1) / kRows));
  auto* kernel = a.seed == nullptr ? flash_attention_bwd_dkv_kernel<D, BQ, false>
                                   : flash_attention_bwd_dkv_kernel<D, BQ, true>;
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
// cudaGetLastError() after its launch (or the error of allowing its
// shared memory).
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
      return launch_dq<64, 32>(a, out, s);
    case 128:
      return launch_dq<128, 16>(a, out, s);
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
      return launch_dkv<64, 32>(a, dko, dvo, s);
    case 128:
      return launch_dkv<128, 16>(a, dko, dvo, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
