// Flash-attention backward for Hopper (sm_90a), bfloat16 operands on the
// tensor cores by wgmma from TMA-fed shared memory: the dQ and dK/dV kernels
// of the AMP path.
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
// gradient is rounded to bf16 once, at the end. The dQ kernel computes
// delta itself, from the rows of dO and O it owns, and writes it for the
// dK/dV kernel that follows it on the stream.
//
// Bound on the H100: tensor-core work, 6*Lq*Lk*D flops a head in the dQ
// kernel (S, dP, dQ) and 8*Lq*Lk*D in the dK/dV kernel (S, dP, dV, dK)
// against 989 TFLOP/s. As in the forward, the ALU work on the scores (the
// softmax recomputed, dS, masks) takes as many issue slots as the products
// at D = 64; drawing the Philox mask again in both kernels would cost more
// than the products, so they read the mask the forward stored.
//
// Design (wgmma_attention.cuh): persistent blocks, one an SM, each walking
// over work items of 128 rows (query rows for dQ, key rows for dK/dV), 64
// for each of two consumer warpgroups; a producer warp loads an item's own
// two row tiles by TMA (double-buffered, so the next item's arrive during
// this one) and streams the other operand's tiles through a ring of stages,
// with the bias row (dQ), the tile's lse and delta (dK/dV) and the tile's
// words of the stored dropout mask staged beside them. S and dP (S^T and
// dP^T in the dK/dV kernel, keys as rows) are two wgmma chains from shared
// memory, issued before the tile's mask is read and while the previous
// tile's gradient products still run. The softmax, bias, masks, dropout and
// dS are applied on the accumulators in registers; rounded to bf16 they are
// the register A operand of the next products, whose B is the streamed tile
// as it lies (MN-major). Each item writes only its own rows: no atomics, and
// the gradients repeat bit for bit.
//
// Dropout: the mask is the one the forward drew and stored, one bit an
// entry (flash_attention_bf16.cu); the producer stages a tile's words beside
// its operands, so neither kernel draws Philox bits again. Causal rows that
// see no key (Lq > Lk) get P = 1/Lk and no dS, as in the f32 kernels.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_attention.cuh"

namespace {

// stages of the streamed ring: two at D = 128, where the own tiles are largest
template <int D>
__host__ __device__ constexpr int stages() {
  return D == 128 ? 2 : 3;
}

// the bias: 0 none, 1 a row per (batch, head) (sq == 0), 2 anything else
__host__ __device__ inline int bias_kind(const void* bias, int64_t sq) {
  return bias == nullptr ? 0 : sq == 0 ? 1 : 2;
}

// -- dQ ----------------------------------------------------------------------------

template <int D, int BK>
constexpr size_t dq_smem_bytes() {
  return 1024 + (size_t)(4 * kBlockRows + 2 * stages<D>() * BK) * D * sizeof(bf16) +
         stages<D>() * (BK + kBlockRows * BK / 32) * sizeof(float) +
         (4 + 2 * stages<D>()) * sizeof(uint64_t);
}

// key tiles a block of query rows from q0 reads (the forward's causal skipping)
__device__ __forceinline__ int dq_tiles(int q0, int lq, int lk, int causal, int bk) {
  const int shift = lk - lq;
  int n_keys = lk;
  if (causal && q0 + shift >= 0) n_keys = min(lk, q0 + kBlockRows + shift);
  return (n_keys + bk - 1) / bk;
}

template <int D, int BK, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_bf16_kernel(
        const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
        const float* __restrict__ bias, int64_t sb, int64_t sh, int64_t sq, int64_t sk,
        const bf16* __restrict__ out, const bf16* __restrict__ dout,
        const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
        int heads, int lq, int lk, int row_blocks, int n_items, float scale, int causal,
        const uint32_t* __restrict__ keep_in, int words, float inv_keep) {
  using P = Panels<D>;
  constexpr int S = stages<D>(), NT = BK / 8, WT = BK / 32;
  constexpr int kOwnBytes = 2 * kBlockRows * D * sizeof(bf16);
  constexpr int kTileBytes = 2 * BK * D * sizeof(bf16);
  extern __shared__ uint8_t smem_raw[];
  bf16* own = reinterpret_cast<bf16*>(align1024(smem_raw));  // [2][q, dO][kBlockRows * D]
  bf16* ks = own + 4 * kBlockRows * D;                        // [S][BK * D]
  bf16* vs = ks + S * BK * D;
  float* bs = reinterpret_cast<float*>(vs + S * BK * D);  // [S][BK] bias row
  // [S][kBlockRows][WT] the forward's stored mask of the tile, when given
  uint32_t* mk = reinterpret_cast<uint32_t*>(bs + S * BK);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(mk + S * kBlockRows * WT);
  uint64_t* own_empty = own_full + 2;
  uint64_t* full = own_empty + 2;
  uint64_t* empty = full + S;
  const int shift = lk - lq, mode = bias_kind(bias, sq);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&own_full[i], 1);
      mbar_init(&own_empty[i], 4 * kConsumers);
    }
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 32);  // the producer warp's lanes, after the bias row and mask
      mbar_init(&empty[i], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == kConsumers) {
    // -- producer ----------------------------------------------------------------------
    regs_dec<kProducerRegs>();
    if (threadIdx.x / 32 == 4 * kConsumers) {
      int tc = 0;
      for (int it = 0, item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / row_blocks, q0 = (item % row_blocks) * kBlockRows;
        const int n_tiles = dq_tiles(q0, lq, lk, causal, BK);
        const float* brow = mode == 1 ? bias + (bh / heads) * sb + (bh % heads) * sh : nullptr;
        if (lane == 0) {
          const int ib = it & 1;
          bf16* qo = own + ib * 2 * kBlockRows * D;
          mbar_wait(&own_empty[ib], ((it >> 1) & 1) ^ 1);
          mbar_arrive_tx(&own_full[ib], kOwnBytes);
          tma_tile<D, kBlockRows>(qo, &tq, &own_full[ib], q0, bh);
          tma_tile<D, kBlockRows>(qo + kBlockRows * D, &tdo, &own_full[ib], q0, bh);
        }
        // a tile's bias row and mask words are read a tile ahead, so the loads
        // land while the producer waits for the stage
        constexpr int kMask = kDrop ? kBlockRows * WT / 32 : 0;
        const uint32_t* mrows = kDrop ? keep_in + ((int64_t)bh * lq + q0) * words : nullptr;
        float row[BK / 32];
        uint32_t msk[kMask > 0 ? kMask : 1];
        auto fetch = [&](int j) {
#pragma unroll
          for (int i = 0; i < BK / 32; ++i) {
            const int ik = j * BK + 32 * i + lane;
            row[i] = brow != nullptr && ik < lk ? __ldg(brow + (int64_t)ik * sk) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < kMask; ++i) {
            const int e = 32 * i + lane, r = e / WT, c = j * WT + e % WT;
            msk[i] = q0 + r < lq && c < words ? __ldg(mrows + r * words + c) : 0u;
          }
        };
        fetch(0);
        for (int j = 0; j < n_tiles; ++j, ++tc) {
          const int st = tc % S;
          mbar_wait(&empty[st], ((tc / S) & 1) ^ 1);
#pragma unroll
          for (int i = 0; i < BK / 32; ++i) bs[st * BK + 32 * i + lane] = row[i];
#pragma unroll
          for (int i = 0; i < kMask; ++i) mk[st * kBlockRows * WT + 32 * i + lane] = msk[i];
          if (j + 1 < n_tiles) fetch(j + 1);
          if (lane == 0) {
            mbar_arrive_tx(&full[st], kTileBytes);
            tma_tile<D, BK>(ks + st * BK * D, &tk, &full[st], j * BK, bh);
            tma_tile<D, BK>(vs + st * BK * D, &tv, &full[st], j * BK, bh);
          } else {
            mbar_arrive(&full[st]);
          }
        }
      }
    }
  } else {
    // -- consumers: 64 query rows a warpgroup ------------------------------------------
    regs_inc<kConsumerRegs>();
    const int w = (threadIdx.x / 32) % 4, g = lane >> 2, t = lane & 3;
    float acc[P::kN][P::kW / 2];
    float s[BK / 2], dp[BK / 2];  // S and dP of the newest tile; s then holds dS
    uint32_t da[BK / 16][4];      // dS as the dQ product takes it, bf16
    uint32_t kw[2][WT];           // the tile's keep bits, as the forward's draw_rows lays them

    int tc = 0;
    for (int it = 0, item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / row_blocks, b = bh / heads, hd = bh % heads;
      const int q0 = (item % row_blocks) * kBlockRows;
      const int n_tiles = dq_tiles(q0, lq, lk, causal, BK);
      const int r_lo = q0 + 64 * wg + 16 * w;  // this warp's first row
      int iq[2];
      float lse_r[2];
      bool dead[2];
      const float* brow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        iq[h] = r_lo + g + 8 * h;
        const int safe = iq[h] < lq ? iq[h] : 0;  // rows past lq compute on row 0, store nothing
        lse_r[h] = lse[(int64_t)bh * lq + safe];
        dead[h] = causal && safe + shift < 0;  // sees no key: no dS at all
        brow[h] = mode == 2 ? bias + b * sb + hd * sh + (int64_t)safe * sq : nullptr;
      }
      // delta = rowsum(dO * O) of this warp's 16 rows, for dS here and for the
      // dK/dV kernel after this one: lanes 2r and 2r + 1 read the two halves of
      // row r_lo + r, 16 bytes a load, all loads in flight at once
      constexpr int kVec = D / 16;
      const int row = r_lo + (lane >> 1);
      float sum = 0.f;
      if (row < lq) {
        const int64_t off = ((int64_t)bh * lq + row) * D + (lane & 1) * (D / 2);
        uint4 av[kVec], ov[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          av[i] = __ldg(reinterpret_cast<const uint4*>(dout + off) + i);
          ov[i] = __ldg(reinterpret_cast<const uint4*>(out + off) + i);
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av[i]);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float2 x = __bfloat1622float2(a2[c]), y = __bfloat1622float2(o2[c]);
            sum = fmaf(x.x, y.x, sum);
            sum = fmaf(x.y, y.y, sum);
          }
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((lane & 1) == 0 && row < lq) delta[(int64_t)bh * lq + row] = sum;
      const float delta_r[2] = {__shfl_sync(0xffffffffu, sum, 2 * g),
                                __shfl_sync(0xffffffffu, sum, 2 * g + 16)};
      const float lse2[2] = {lse_r[0] * kLog2e, lse_r[1] * kLog2e};
      const int ib = it & 1;
      const bf16* qw = own + ib * 2 * kBlockRows * D + 64 * wg * P::kW;  // this warpgroup's rows
      const bf16* dow = qw + kBlockRows * D;
#pragma unroll
      for (int p = 0; p < P::kN; ++p)
#pragma unroll
        for (int i = 0; i < P::kW / 2; ++i) acc[p][i] = 0.f;

      auto release = [&](uint64_t* bar) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      };
      // dS of tile j on s and dp; constant flags as in the forward's scores
      auto grad = [&](int j, bool whole, bool full_bias) {
        const int k0 = j * BK;
        const float* brs = bs + ((tc + j) % S) * BK + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 row = *reinterpret_cast<const float2*>(brs + 8 * n);  // 0 without one
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int ik = k0 + 8 * n + 2 * t + (e & 1);
            float bv = e & 1 ? row.y : row.x;
            if (full_bias && ik < lk) bv = __ldg(brow[h] + (int64_t)ik * sk);
            const float p = ex2(fmaf(fmaf(s[4 * n + e], scale, bv), kLog2e, -lse2[h]));
            float dpv = dp[4 * n + e];
            if (kDrop)
              dpv = (kw[h][n / 4] >> (8 * (n % 4) + (e & 1))) & 1u ? dpv * inv_keep : 0.f;
            float ds = p * (dpv - delta_r[h]);
            // keys past lk and causal-masked scores pass no gradient
            if (!whole && (ik >= lk || dead[h] || (causal && ik > iq[h] + shift))) ds = 0.f;
            s[4 * n + e] = ds;
          }
        }
      };

      mbar_wait(&own_full[ib], (it >> 1) & 1);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = (tc + j) % S;
        mbar_wait(&full[st], ((tc + j) / S) & 1);
        reg_fence(s);
        reg_fence(dp);
        wgmma_fence();
        product_rows<D, kBlockRows, BK>(s, qw, ks + st * BK * D);
        product_rows<D, kBlockRows, BK>(dp, dow, vs + st * BK * D);
        wgmma_commit();
        if (kDrop) {  // the forward's mask of the tile, staged by the producer
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < WT; ++c)
              kw[h][c] = mk[(st * kBlockRows + iq[h] - q0) * WT + c] >> (2 * t);
        }
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
#pragma unroll
        for (int p = 0; p < P::kN; ++p) reg_fence(acc[p]);
        reg_fence(da);
        if (j > 0) release(&empty[(tc + j - 1) % S]);
        if (mode == 2) {
          grad(j, false, true);
        } else if ((j + 1) * BK <= lk && (!causal || ((j + 1) * BK - 1 <= r_lo + shift))) {
          grad(j, true, false);  // no key past lk, none causal-hidden, no dead row in this warp
        } else {
          grad(j, false, false);
        }
        to_a<BK>(s, da);
        wgmma_fence();
        product_cols<D, BK>(acc, da, ks + st * BK * D);  // dQ += round(dS) k
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P::kN; ++p) reg_fence(acc[p]);
      reg_fence(da);
      release(&empty[(tc + n_tiles - 1) % S]);
      release(&own_empty[ib]);
      tc += n_tiles;

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (iq[h] >= lq) continue;
        bf16* orow = dq + ((int64_t)bh * lq + iq[h]) * D + 2 * t;
#pragma unroll
        for (int p = 0; p < P::kN; ++p)
#pragma unroll
          for (int c = 0; c < P::kW / 8; ++c)
            *reinterpret_cast<uint32_t*>(orow + p * P::kW + 8 * c) =
                pack_bf16(acc[p][4 * c + 2 * h] * scale, acc[p][4 * c + 2 * h + 1] * scale);
      }
    }
  }
}

// -- dK / dV -----------------------------------------------------------------------

template <int D, int BQ>
constexpr size_t dkv_smem_bytes() {
  return 1024 + (size_t)(4 * kBlockRows + 2 * stages<D>() * BQ) * D * sizeof(bf16) +
         stages<D>() * BQ * (2 + kBlockRows / 32) * sizeof(float) +
         (4 + 2 * stages<D>()) * sizeof(uint64_t);
}

// the first query row a block of keys from k0 reads: causal query rows before
// k0 - shift see none of its keys. With Lq > Lk (shift < 0) the first rows see
// no key and so, uniformly, every key: nothing is skipped then.
__device__ __forceinline__ int dkv_first_row(int k0, int lq, int lk, int causal, int bq) {
  const int shift = lk - lq;
  return causal && shift >= 0 ? max(0, k0 - shift) / bq * bq : 0;
}

template <int D, int BQ, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkv_bf16_kernel(
        const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
        const float* __restrict__ bias, int64_t sb, int64_t sh, int64_t sq, int64_t sk,
        const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
        bf16* __restrict__ dv, int heads, int lq, int lk, int row_blocks, int n_items,
        float scale, int causal, const uint32_t* __restrict__ keep_in, int words,
        float inv_keep) {
  using P = Panels<D>;
  constexpr int S = stages<D>(), NT = BQ / 8;
  constexpr int kOwnBytes = 2 * kBlockRows * D * sizeof(bf16);
  constexpr int kTileBytes = 2 * BQ * D * sizeof(bf16);
  extern __shared__ uint8_t smem_raw[];
  bf16* own = reinterpret_cast<bf16*>(align1024(smem_raw));  // [2][k, v][kBlockRows * D]
  bf16* qs = own + 4 * kBlockRows * D;                        // [S][BQ * D]
  bf16* dos = qs + S * BQ * D;
  float* lts = reinterpret_cast<float*>(dos + S * BQ * D);  // [S][BQ] lse * log2(e) of the tile
  float* dlts = lts + S * BQ;                               // [S][BQ] its delta
  // [S][BQ][kBlockRows / 32] the forward's stored mask of the tile's query rows
  // and the item's keys, when given
  uint32_t* mk = reinterpret_cast<uint32_t*>(dlts + S * BQ);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(mk + S * BQ * (kBlockRows / 32));
  uint64_t* own_empty = own_full + 2;
  uint64_t* full = own_empty + 2;
  uint64_t* empty = full + S;
  const int shift = lk - lq, mode = bias_kind(bias, sq);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&own_full[i], 1);
      mbar_init(&own_empty[i], 4 * kConsumers);
    }
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 32);  // the producer warp's lanes, after lse and delta
      mbar_init(&empty[i], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == kConsumers) {
    // -- producer ----------------------------------------------------------------------
    regs_dec<kProducerRegs>();
    if (threadIdx.x / 32 == 4 * kConsumers) {
      int tc = 0;
      for (int it = 0, item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / row_blocks, k0 = (item % row_blocks) * kBlockRows;
        const int q_begin = dkv_first_row(k0, lq, lk, causal, BQ);
        const int n_tiles = q_begin < lq ? (lq - q_begin + BQ - 1) / BQ : 0;
        const float* lb = lse + (int64_t)bh * lq;
        const float* db = delta + (int64_t)bh * lq;
        if (lane == 0) {
          const int ib = it & 1;
          bf16* kv = own + ib * 2 * kBlockRows * D;
          mbar_wait(&own_empty[ib], ((it >> 1) & 1) ^ 1);
          mbar_arrive_tx(&own_full[ib], kOwnBytes);
          tma_tile<D, kBlockRows>(kv, &tk, &own_full[ib], k0, bh);
          tma_tile<D, kBlockRows>(kv + kBlockRows * D, &tv, &own_full[ib], k0, bh);
        }
        // a tile's lse, delta and mask words are read a tile ahead, so the loads
        // land while the producer waits for the stage
        constexpr int kW = kBlockRows / 32, kMask = kDrop ? BQ * kW / 32 : 0;
        const uint32_t* mhead = kDrop ? keep_in + (int64_t)bh * lq * words : nullptr;
        float lrow[BQ / 32], drow[BQ / 32];
        uint32_t msk[kMask > 0 ? kMask : 1];
        auto fetch = [&](int i) {
          const int t0 = q_begin + i * BQ;
#pragma unroll
          for (int j = 0; j < BQ / 32; ++j) {
            const int r = t0 + 32 * j + lane;
            const bool valid = r < lq;  // rows past lq read as 0 and are never used
            lrow[j] = valid ? __ldg(lb + r) * kLog2e : 0.f;
            drow[j] = valid ? __ldg(db + r) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < kMask; ++j) {
            const int e = 32 * j + lane, r = t0 + e / kW, c = k0 / 32 + e % kW;
            msk[j] = r < lq && c < words ? __ldg(mhead + r * words + c) : 0u;
          }
        };
        if (n_tiles > 0) fetch(0);
        for (int i = 0; i < n_tiles; ++i, ++tc) {
          const int st = tc % S, t0 = q_begin + i * BQ;
          mbar_wait(&empty[st], ((tc / S) & 1) ^ 1);
#pragma unroll
          for (int j = 0; j < BQ / 32; ++j) {
            lts[st * BQ + 32 * j + lane] = lrow[j];
            dlts[st * BQ + 32 * j + lane] = drow[j];
          }
#pragma unroll
          for (int j = 0; j < kMask; ++j) mk[st * BQ * kW + 32 * j + lane] = msk[j];
          if (i + 1 < n_tiles) fetch(i + 1);
          if (lane == 0) {
            mbar_arrive_tx(&full[st], kTileBytes);
            tma_tile<D, BQ>(qs + st * BQ * D, &tq, &full[st], t0, bh);
            tma_tile<D, BQ>(dos + st * BQ * D, &tdo, &full[st], t0, bh);
          } else {
            mbar_arrive(&full[st]);
          }
        }
      }
    }
  } else {
    // -- consumers: 64 key rows a warpgroup --------------------------------------------
    regs_inc<kConsumerRegs>();
    const int w = (threadIdx.x / 32) % 4, g = lane >> 2, t = lane & 3;
    const float inv_lk = 1.0f / (float)lk;
    float acc_k[P::kN][P::kW / 2], acc_v[P::kN][P::kW / 2];
    float s[BQ / 2], dp[BQ / 2];  // S^T and dP^T of the newest tile; then P o M and dS
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    uint32_t keep[(NT + 7) / 8];

    int tc = 0;
    for (int it = 0, item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / row_blocks, b = bh / heads, hd = bh % heads;
      const int k0 = (item % row_blocks) * kBlockRows;
      const int q_begin = dkv_first_row(k0, lq, lk, causal, BQ);
      const int n_tiles = q_begin < lq ? (lq - q_begin + BQ - 1) / BQ : 0;
      const int k_lo = k0 + 64 * wg + 16 * w;  // this warp's first key row
      int ik[2];
      float bk[2] = {0.f, 0.f};  // a row bias (mode 1) is one value a key row
      const float* bcol[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ik[h] = k_lo + g + 8 * h;
        const int safe = ik[h] < lk ? ik[h] : 0;  // keys past lk compute on key 0, store nothing
        const float* base = bias == nullptr ? nullptr : bias + b * sb + hd * sh;
        if (mode == 1) bk[h] = __ldg(base + (int64_t)safe * sk);
        bcol[h] = mode == 2 ? base + (int64_t)safe * sk : nullptr;
      }
      const int ib = it & 1;
      const bf16* kw = own + ib * 2 * kBlockRows * D + 64 * wg * P::kW;  // this warpgroup's rows
      const bf16* vw = kw + kBlockRows * D;
#pragma unroll
      for (int p = 0; p < P::kN; ++p)
#pragma unroll
        for (int i = 0; i < P::kW / 2; ++i) acc_k[p][i] = acc_v[p][i] = 0.f;

      auto release = [&](uint64_t* bar) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      };
      // P o M (on s) and dS (on dp) of tile i: element e is key ik[e >> 1],
      // query t0 + 8n + 2t + (e & 1); constant flags as in the dQ kernel
      auto grad = [&](int i, bool whole, bool full_bias) {
        const int t0 = q_begin + i * BQ, st = (tc + i) % S;
        const float* lt = lts + st * BQ + 2 * t;
        const float* dlt = dlts + st * BQ + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * n);
          const float2 dl = *reinterpret_cast<const float2*>(dlt + 8 * n);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int iq = t0 + 8 * n + 2 * t + (e & 1);
            const float lse_c = e & 1 ? l2.y : l2.x, delta_c = e & 1 ? dl.y : dl.x;
            float bv = bk[h];
            if (full_bias && iq < lq) bv = __ldg(bcol[h] + (int64_t)iq * sq);
            float p = ex2(fmaf(fmaf(s[4 * n + e], scale, bv), kLog2e, -lse_c));
            float dpv = dp[4 * n + e];
            bool masked = false;
            if (!whole) {
              masked = iq >= lq || (causal && ik[h] > iq + shift);
              if (iq >= lq) {
                p = 0.f;
              } else if (causal && iq + shift < 0) {
                p = inv_lk;  // a row that sees no key at all is uniform over every key ...
              } else if (masked) {
                p = 0.f;  // ... where a masked score's probability underflows to 0
              }
            }
            float pv = p;
            if (kDrop) {
              const float scale_keep = (keep[n / 8] >> (4 * (n % 8) + e)) & 1u ? inv_keep : 0.f;
              pv = p * scale_keep;
              dpv *= scale_keep;
            }
            s[4 * n + e] = pv;
            dp[4 * n + e] = masked ? 0.f : p * (dpv - delta_c);
          }
        }
      };

      mbar_wait(&own_full[ib], (it >> 1) & 1);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = (tc + i) % S, t0 = q_begin + i * BQ;
        mbar_wait(&full[st], ((tc + i) / S) & 1);
        reg_fence(s);
        reg_fence(dp);
        wgmma_fence();
        product_rows<D, kBlockRows, BQ>(s, kw, qs + st * BQ * D);   // S^T = k q^T
        product_rows<D, kBlockRows, BQ>(dp, vw, dos + st * BQ * D);  // dP^T = v dO^T
        wgmma_commit();
        if (kDrop) {
          // the forward's mask, staged by query row: one word holds this warp's 16 keys
#pragma unroll
          for (int j = 0; j < (NT + 7) / 8; ++j) keep[j] = 0u;
          const int shift_k = (k_lo & 31) + g;
          const uint32_t* words_st = mk + st * BQ * (kBlockRows / 32) + (k_lo - k0) / 32;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int b2 = 0; b2 < 2; ++b2) {
              const uint32_t word = words_st[(8 * n + 2 * t + b2) * (kBlockRows / 32)];
              keep[n / 8] |= ((word >> shift_k) & 1u) << (4 * (n % 8) + b2);
              keep[n / 8] |= ((word >> (shift_k + 8)) & 1u) << (4 * (n % 8) + 2 + b2);
            }
        }
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
#pragma unroll
        for (int p = 0; p < P::kN; ++p) {
          reg_fence(acc_k[p]);
          reg_fence(acc_v[p]);
        }
        reg_fence(pa);
        reg_fence(da);
        if (i > 0) release(&empty[(tc + i - 1) % S]);
        if (mode == 2) {
          grad(i, false, true);
        } else if (t0 + BQ <= lq && (!causal || k_lo + 15 <= t0 + shift)) {
          grad(i, true, false);  // every query row real and seeing all of this warp's keys
        } else {
          grad(i, false, false);
        }
        to_a<BQ>(s, pa);
        to_a<BQ>(dp, da);
        wgmma_fence();
        product_cols<D, BQ>(acc_v, pa, dos + st * BQ * D);  // dV += round(P o M)^T dO
        product_cols<D, BQ>(acc_k, da, qs + st * BQ * D);   // dK += round(dS)^T q
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P::kN; ++p) {
        reg_fence(acc_k[p]);
        reg_fence(acc_v[p]);
      }
      reg_fence(pa);
      reg_fence(da);
      if (n_tiles > 0) release(&empty[(tc + n_tiles - 1) % S]);
      release(&own_empty[ib]);
      tc += n_tiles;

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ik[h] >= lk) continue;
        const int64_t row = ((int64_t)bh * lk + ik[h]) * D + 2 * t;
#pragma unroll
        for (int p = 0; p < P::kN; ++p)
#pragma unroll
          for (int c = 0; c < P::kW / 8; ++c) {
            const int col = p * P::kW + 8 * c;
            *reinterpret_cast<uint32_t*>(dk + row + col) =
                pack_bf16(acc_k[p][4 * c + 2 * h] * scale, acc_k[p][4 * c + 2 * h + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + row + col) =
                pack_bf16(acc_v[p][4 * c + 2 * h], acc_v[p][4 * c + 2 * h + 1]);
          }
      }
    }
  }
}

// -- launches ----------------------------------------------------------------------

struct Args {
  const bf16 *q, *k, *v;
  const float* bias;
  int64_t sb, sh, sq, sk;
  const bf16* dout;
  const float* lse;
  int batch, heads, lq, lk;
  float scale;
  int causal;
  const uint32_t* keep;  // the forward's stored dropout mask, or NULL: no dropout
  float inv_keep;
};

// Above 48 KB a kernel's dynamic shared memory must be allowed first.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, int BK, bool kDrop>
int launch_dq(const Args& a, const bf16* out, float* delta, bf16* dq, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D, BK>();
  const int bh = a.batch * a.heads, row_blocks = (a.lq + kBlockRows - 1) / kBlockRows;
  const int n_items = bh * row_blocks;
  CUtensorMap tq, tdo, tk, tv;
  int e = tensor_map(&tq, a.q, bh, a.lq, D, kBlockRows);
  if (e == 0) e = tensor_map(&tdo, a.dout, bh, a.lq, D, kBlockRows);
  if (e == 0) e = tensor_map(&tk, a.k, bh, a.lk, D, BK);
  if (e == 0) e = tensor_map(&tv, a.v, bh, a.lk, D, BK);
  if (e != 0) return e;
  auto* kernel = flash_attention_bwd_dq_bf16_kernel<D, BK, kDrop>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)min(n_items, sm_count()), kThreads, smem, stream>>>(
      tq, tdo, tk, tv, a.bias, a.sb, a.sh, a.sq, a.sk, out, a.dout, a.lse, delta, dq, a.heads,
      a.lq, a.lk, row_blocks, n_items, a.scale, a.causal, a.keep, (a.lk + 31) / 32,
      a.inv_keep);
  return (int)cudaGetLastError();
}

template <int D, int BQ, bool kDrop>
int launch_dkv(const Args& a, const float* delta, bf16* dk, bf16* dv, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D, BQ>();
  const int bh = a.batch * a.heads, row_blocks = (a.lk + kBlockRows - 1) / kBlockRows;
  const int n_items = bh * row_blocks;
  CUtensorMap tq, tdo, tk, tv;
  int e = tensor_map(&tq, a.q, bh, a.lq, D, BQ);
  if (e == 0) e = tensor_map(&tdo, a.dout, bh, a.lq, D, BQ);
  if (e == 0) e = tensor_map(&tk, a.k, bh, a.lk, D, kBlockRows);
  if (e == 0) e = tensor_map(&tv, a.v, bh, a.lk, D, kBlockRows);
  if (e != 0) return e;
  auto* kernel = flash_attention_bwd_dkv_bf16_kernel<D, BQ, kDrop>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)min(n_items, sm_count()), kThreads, smem, stream>>>(
      tq, tdo, tk, tv, a.bias, a.sb, a.sh, a.sq, a.sk, a.lse, delta, dk, dv, a.heads, a.lq,
      a.lk, row_blocks, n_items, a.scale, a.causal, a.keep, (a.lk + 31) / 32, a.inv_keep);
  return (int)cudaGetLastError();
}

// the streamed tile of each head dim: BK keys for dQ, BQ query rows for dK/dV
template <int D>
int dq_d(const Args& a, const bf16* out, float* delta, bf16* dq, cudaStream_t s) {
  return a.keep != nullptr ? launch_dq<D, 64, true>(a, out, delta, dq, s)
                           : launch_dq<D, 64, false>(a, out, delta, dq, s);
}
template <int D>
int dkv_d(const Args& a, const float* delta, bf16* dk, bf16* dv, cudaStream_t s) {
  constexpr int BQ = D == 128 ? 32 : 64;
  return a.keep != nullptr ? launch_dkv<D, BQ, true>(a, delta, dk, dv, s)
                           : launch_dkv<D, BQ, false>(a, delta, dk, dv, s);
}

Args make_args(const void* q, const void* k, const void* v, const void* bias, int64_t sb,
               int64_t sh, int64_t sq, int64_t sk, const void* dout, const void* lse, int batch,
               int heads, int lq, int lk, float scale, int causal, const void* keep,
               float inv_keep) {
  return Args{static_cast<const bf16*>(q),    static_cast<const bf16*>(k),
              static_cast<const bf16*>(v),    static_cast<const float*>(bias),
              sb,                             sh,
              sq,                             sk,
              static_cast<const bf16*>(dout), static_cast<const float*>(lse),
              batch,                          heads,
              lq,                             lk,
              scale,                          causal,
              static_cast<const uint32_t*>(keep), inv_keep};
}

}  // namespace

// Shapes as the forward's: q/dout/out/dq [B*H, Lq, D], k/v/dk/dv [B*H, Lk, D]
// bfloat16, lse/delta [B*H, Lq] float32, all contiguous; bias NULL or f32
// addressed as bias[b*sb + h*sh + iq*sq + ik*sk]; keep NULL (no dropout) or
// the mask the forward stored, int32 [B*H, Lq, ceil(Lk / 32)] with entry
// (iq, ik) kept where bit ik % 32 of word ik / 32 is set, whose kept
// probabilities are scaled by inv_keep. The dQ entry computes delta
// = rowsum(dout * out) into `delta`; the dK/dV entry reads it. Each returns
// cudaGetLastError() after its launch (or the error of encoding a tensor
// map or allowing the kernel's shared memory).
extern "C" int ptt_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                               const void* bias, int64_t sb, int64_t sh,
                                               int64_t sq, int64_t sk, const void* dout,
                                               const void* lse, void* delta, const void* out,
                                               void* dq, int batch, int heads, int lq, int lk,
                                               int d, float scale, int causal, const void* keep,
                                               float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0 || lq == 0 || lk == 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, bias, sb, sh, sq, sk, dout, lse, batch, heads, lq, lk, scale,
                           causal, keep, inv_keep);
  const bf16* o = static_cast<const bf16*>(out);
  float* dl = static_cast<float*>(delta);
  bf16* g = static_cast<bf16*>(dq);
  switch (d) {
    case 32:
      return dq_d<32>(a, o, dl, g, s);
    case 64:
      return dq_d<64>(a, o, dl, g, s);
    case 128:
      return dq_d<128>(a, o, dl, g, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ptt_flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                                const void* bias, int64_t sb, int64_t sh,
                                                int64_t sq, int64_t sk, const void* dout,
                                                const void* lse, const void* delta, void* dk,
                                                void* dv, int batch, int heads, int lq, int lk,
                                                int d, float scale, int causal, const void* keep,
                                                float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0 || lq == 0 || lk == 0) return (int)cudaSuccess;
  const Args a = make_args(q, k, v, bias, sb, sh, sq, sk, dout, lse, batch, heads, lq, lk, scale,
                           causal, keep, inv_keep);
  const float* dl = static_cast<const float*>(delta);
  bf16* gk = static_cast<bf16*>(dk);
  bf16* gv = static_cast<bf16*>(dv);
  switch (d) {
    case 32:
      return dkv_d<32>(a, dl, gk, gv, s);
    case 64:
      return dkv_d<64>(a, dl, gk, gv, s);
    case 128:
      return dkv_d<128>(a, dl, gk, gv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
