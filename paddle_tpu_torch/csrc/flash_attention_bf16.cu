// Flash-attention forward for Hopper (sm_90a), bfloat16 operands on the
// tensor cores by wgmma from TMA-fed shared memory: the AMP path.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py _fwd_core/_pallas_fwd
// and _fwd_small_core/_pallas_fwd_small on bf16 q, k, v, with the TPU
// kernel's rounding points: S = q k^T accumulated in f32, scaled, masked and
// biased in f32, the online softmax in f32, the probabilities rounded to
// bf16 before P V (p_acc.astype(vt.dtype)), the output accumulated in f32
// and rounded to bf16 once, at the end; lse = m + log(l) in f32.
//
// Bound on the H100: the two products are 4*Lq*Lk*D flops a head against
// 989 TFLOP/s, the operands 2*(2*Lq + 2*Lk)*D bytes against 3.35 TB/s; at
// BERT's [32, 12, 512, 64] the bytes bind (0.030 ms against 0.026). What
// binds in fact is ALU work beside the products: at D = 64 the softmax of a
// score costs about as many issue slots as its share of the two products,
// and with dropout the Philox draws (philox.cuh, ten rounds per four
// entries) cost twice the softmax again.
//
// Design (wgmma_attention.cuh): persistent blocks, one an SM, each walking
// over work items of 128 query rows, 64 for each of two consumer warpgroups;
// a producer warp keeps TMA loads in flight: an item's query rows (two
// buffers, so the next item's land during this one) and K and V tiles of BN
// keys into a ring of kStages stages, K's and V's on their own full barriers
// (S can start before V lands), with the tile's bias row (a pad mask, sq ==
// 0) staged beside them; eight consumer warps release a stage. S = q k^T is
// one wgmma chain from shared memory; the probabilities, rounded to bf16,
// are the register A operand of P V, whose B is the V tile as it lies
// (MN-major). Each iteration issues S_j, then P_{j-1} V_{j-1}, then draws
// tile j's dropout bits while both run, and waits for S_j only (FA3's
// intra-warpgroup pipelining); the output is rescaled once P V is done. The
// scores' masks are applied only on tiles that need them (ragged or causal
// edges), each of the three variants compiled on its own.
//
// The bias is f32, read through its strides (stride 0 on broadcast dims).
// Causal scores are -1e30 and tiles past a block's last row are skipped when
// every row of the block sees key 0; keys and rows past Lk and Lq load as
// zeros (the tensor maps are 3-D) and are masked. Dropout: an entry is
// dropped where its 32 Philox bits, counted by (key column / 4, query row,
// batch*head), fall below rate * 2^32, so the f32 and bf16 kernels drop the
// same entries; the denominator sums the undropped probabilities. The
// kernel stores the mask, one bit an entry (the quad's four lanes OR their
// bits into 32-key words), so the backward reads it instead of drawing it
// twice more.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_attention.cuh"

namespace {

constexpr int kStages = 3;  // K/V ring depth: with two the next tile's loads land late

template <int D, int BN>
constexpr size_t fwd_smem_bytes() {
  return 1024 + (size_t)(2 * kBlockRows + 2 * kStages * BN) * D * sizeof(bf16) +
         kStages * BN * sizeof(float) + (4 + 3 * kStages) * sizeof(uint64_t);
}

// the key tiles a block of query rows from q0 reads: causal blocks skip the
// tiles past their last row when every row sees key 0
__device__ __forceinline__ int fwd_tiles(int q0, int lq, int lk, int causal, int bn) {
  const int shift = lk - lq;  // causal: key ik is visible to row iq when ik <= iq + shift
  int n_keys = lk;
  if (causal && q0 + shift >= 0) n_keys = min(lk, q0 + kBlockRows + shift);
  return (n_keys + bn - 1) / bn;
}

// bias_mode: 0 none, 1 a row per (batch, head) (sq == 0: staged in shared
// memory a tile at a time), 2 anything else (read per entry)
template <int D, int BN, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const float* __restrict__ bias, int64_t sb, int64_t sh,
                                    int64_t sq, int64_t sk, int bias_mode,
                                    bf16* __restrict__ out, float* __restrict__ lse, int heads,
                                    int lq, int lk, int row_blocks, int n_items, float scale,
                                    int causal, const uint32_t* __restrict__ seed,
                                    uint32_t* __restrict__ keep_out, int words,
                                    uint32_t threshold, float inv_keep) {
  using P = Panels<D>;
  constexpr int NT = BN / 8;  // 8-key blocks a tile
  constexpr int WT = BN / 32;  // 32-key words of the mask a tile row
  constexpr int kTileBytes = BN * D * sizeof(bf16);
  extern __shared__ uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(align1024(smem_raw));  // [2][kBlockRows * D]
  bf16* ks = qs + 2 * kBlockRows * D;                       // [kStages][BN * D]
  bf16* vs = ks + kStages * BN * D;
  float* bs = reinterpret_cast<float*>(vs + kStages * BN * D);  // [kStages][BN] bias row
  uint64_t* q_full = reinterpret_cast<uint64_t*>(bs + kStages * BN);  // [2]
  uint64_t* q_empty = q_full + 2;                                     // [2]
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  const int shift = lk - lq;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 4 * kConsumers);  // one arrival a consumer warp
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&k_full[i], 32);  // the producer warp's lanes, after the bias row
      mbar_init(&v_full[i], 1);
      mbar_init(&empty[i], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == kConsumers) {
    // -- producer: one warp keeps the ring full, item after item ---------------------
    regs_dec<kProducerRegs>();
    if (threadIdx.x / 32 == 4 * kConsumers) {
      int tc = 0;  // tiles issued
      for (int it = 0, item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / row_blocks, q0 = (item % row_blocks) * kBlockRows;
        const int n_tiles = fwd_tiles(q0, lq, lk, causal, BN);
        const float* brow = bias_mode == 1 ? bias + (bh / heads) * sb + (bh % heads) * sh : nullptr;
        if (lane == 0) {
          const int qb = it & 1;
          mbar_wait(&q_empty[qb], ((it >> 1) & 1) ^ 1);  // the buffer's last item released
          mbar_arrive_tx(&q_full[qb], kBlockRows * D * sizeof(bf16));
          tma_tile<D, kBlockRows>(qs + qb * kBlockRows * D, &tq, &q_full[qb], q0, bh);
        }
        // a tile's bias row is read a tile ahead, so the loads land while the
        // producer waits for the stage
        float row[BN / 32];
        auto fetch = [&](int j) {
#pragma unroll
          for (int i = 0; i < BN / 32; ++i) {
            const int ik = j * BN + 32 * i + lane;
            row[i] = brow != nullptr && ik < lk ? __ldg(brow + (int64_t)ik * sk) : 0.f;
          }
        };
        fetch(0);
        for (int j = 0; j < n_tiles; ++j, ++tc) {
          const int st = tc % kStages;
          mbar_wait(&empty[st], ((tc / kStages) & 1) ^ 1);  // the stage's last tile released
#pragma unroll
          for (int i = 0; i < BN / 32; ++i) bs[st * BN + 32 * i + lane] = row[i];
          if (j + 1 < n_tiles) fetch(j + 1);
          if (lane == 0) {
            mbar_arrive_tx(&k_full[st], kTileBytes);
            tma_tile<D, BN>(ks + st * BN * D, &tk, &k_full[st], j * BN, bh);
            mbar_arrive_tx(&v_full[st], kTileBytes);
            tma_tile<D, BN>(vs + st * BN * D, &tv, &v_full[st], j * BN, bh);
          } else {
            mbar_arrive(&k_full[st]);
          }
        }
      }
    }
  } else {
    // -- consumers: 64 query rows a warpgroup ------------------------------------------
    regs_inc<kConsumerRegs>();
    const int w = (threadIdx.x / 32) % 4, g = lane >> 2, t = lane & 3;
    uint32_t key0 = 0, key1 = 0;
    if (kDrop) {
      key0 = seed[0];
      key1 = seed[1];
    }
    float o[P::kN][P::kW / 2];
    float s[BN / 2];          // S of the newest tile, then its probabilities
    uint32_t pa[BN / 16][4];  // the probabilities P V takes, bf16
    uint32_t kw[2][WT];  // the tile's keep bits: row h, key 32c + 8i + 2t + b at bit 8i + b

    int tc = 0;  // tiles consumed
    for (int it = 0, item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int bh = item / row_blocks, b = bh / heads, hd = bh % heads;
      const int q0 = (item % row_blocks) * kBlockRows;
      const int n_tiles = fwd_tiles(q0, lq, lk, causal, BN);
      const int r_lo = q0 + 64 * wg + 16 * w;  // this warp's first row
      // the two query rows of this thread's accumulators
      int iq[2];
      const float* brow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        iq[h] = r_lo + g + 8 * h;
        const int safe = iq[h] < lq ? iq[h] : 0;  // rows past lq compute on row 0, store nothing
        brow[h] = bias_mode == 2 ? bias + b * sb + hd * sh + (int64_t)safe * sq : nullptr;
      }
      const int qb = it & 1;
      const bf16* qw = qs + qb * kBlockRows * D + 64 * wg * P::kW;  // this warpgroup's rows
#pragma unroll
      for (int p = 0; p < P::kN; ++p)
#pragma unroll
        for (int i = 0; i < P::kW / 2; ++i) o[p][i] = 0.f;
      float m[2] = {kNegInf, kNegInf};  // running row max
      float l[2] = {0.f, 0.f};          // this lane's share of the running row sum

      auto issue_s = [&](int j) {
        reg_fence(s);
        wgmma_fence();
        product_rows<D, kBlockRows, BN>(s, qw, ks + ((tc + j) % kStages) * BN * D);
        wgmma_commit();
      };
      auto issue_pv = [&](int j) {
#pragma unroll
        for (int p = 0; p < P::kN; ++p) reg_fence(o[p]);
        wgmma_fence();
        product_cols<D, BN>(o, pa, vs + ((tc + j) % kStages) * BN * D);
        wgmma_commit();
      };
      auto release = [&](uint64_t* bar) {  // this warp is done with a buffer
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
      };
      // tile j's dropout bits, ALU work while the products run; stored for the
      // backward: the quad's lanes OR their bits into whole words
      auto draw = [&](int j) {
        if (kDrop) {
          // the draws depend on this empty asm, which follows the products' issue:
          // the compiler cannot hoist them ahead of the wgmma instructions
          asm volatile("" : "+r"(key0), "+r"(key1));
          draw_rows<NT>(kw, j * BN, iq, bh, t, key0, key1, threshold);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t mine = 0u;
#pragma unroll
            for (int c = 0; c < WT; ++c) {
              uint32_t word = kw[h][c] << (2 * t);
              word |= __shfl_xor_sync(0xffffffffu, word, 1);
              word |= __shfl_xor_sync(0xffffffffu, word, 2);
              if (t == c) mine = word;
            }
            if (t < WT && iq[h] < lq && j * WT + t < words)
              keep_out[((int64_t)bh * lq + iq[h]) * words + j * WT + t] = mine;
          }
        }
      };
      // tile j's scores on s (scaled, biased, masked) and their row maxima over
      // this lane's entries; called with constant flags, so each call site is
      // its own code: `whole` drops the masks, `full_bias` reads the bias per entry
      auto scores = [&](int j, bool whole, bool full_bias, float (&mx)[2]) {
        const int k0 = j * BN;
        const float* brs = bs + ((tc + j) % kStages) * BN + 2 * t;
        float part[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[h][i] = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 row = *reinterpret_cast<const float2*>(brs + 8 * n);  // 0 without one
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int ik = k0 + 8 * n + 2 * t + (e & 1);
            float bv = e & 1 ? row.y : row.x;
            if (full_bias && ik < lk) bv = __ldg(brow[h] + (int64_t)ik * sk);
            float sc = fmaf(s[4 * n + e], scale, bv);  // scaled before the bias, as on the TPU
            if (!whole) {
              if (ik >= lk) {
                sc = -INFINITY;  // keys past lk contribute nothing
              } else if (causal && ik > iq[h] + shift) {
                sc = kNegInf + bv;
              }
            }
            s[4 * n + e] = sc;
            part[h][n & 3] = fmaxf(part[h][n & 3], sc);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mx[h] = fmaxf(fmaxf(part[h][0], part[h][1]), fmaxf(part[h][2], part[h][3]));
      };
      // the online softmax of tile j on s; returns the rescale of the sums so far
      auto softmax = [&](int j, float (&corr)[2]) {
        const int k0 = j * BN;
        float mx[2];
        if (bias_mode == 2) {
          scores(j, false, true, mx);
        } else if (k0 + BN <= lk && (!causal || k0 + BN - 1 <= r_lo + shift)) {
          scores(j, true, false, mx);  // no key past lk, none causal-hidden from this warp
        } else {
          scores(j, false, false, mx);
        }
        float ml[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the row's max over the quad's lanes
          float v = mx[h];
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          const float m_new = fmaxf(m[h], v);
          corr[h] = ex2((m[h] - m_new) * kLog2e);
          m[h] = m_new;
          ml[h] = m_new;
        }
        float ls[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            float p = ex2((s[4 * n + e] - ml[h]) * kLog2e);
            ls[h][n & 3] += p;  // the denominator sums the undropped probabilities
            if (kDrop) p = (kw[h][n / 4] >> (8 * (n % 4) + (e & 1))) & 1u ? p * inv_keep : 0.f;
            s[4 * n + e] = p;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          l[h] = l[h] * corr[h] + ((ls[h][0] + ls[h][1]) + (ls[h][2] + ls[h][3]));
      };

      mbar_wait(&q_full[qb], (it >> 1) & 1);
      float corr[2];
      mbar_wait(&k_full[tc % kStages], (tc / kStages) & 1);
      issue_s(0);
      draw(0);
      wgmma_wait<0>();
      reg_fence(s);
      softmax(0, corr);
      to_a<BN>(s, pa);
      for (int j = 1; j < n_tiles; ++j) {
        mbar_wait(&k_full[(tc + j) % kStages], ((tc + j) / kStages) & 1);
        issue_s(j);
        mbar_wait(&v_full[(tc + j - 1) % kStages], ((tc + j - 1) / kStages) & 1);
        issue_pv(j - 1);
        draw(j);
        wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
        reg_fence(s);
        softmax(j, corr);
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < P::kN; ++p) reg_fence(o[p]);
        reg_fence(pa);
        release(&empty[(tc + j - 1) % kStages]);
#pragma unroll
        for (int p = 0; p < P::kN; ++p)
#pragma unroll
          for (int i = 0; i < P::kW / 2; ++i) o[p][i] *= corr[(i >> 1) & 1];
        to_a<BN>(s, pa);
      }
      const int last = tc + n_tiles - 1;
      mbar_wait(&v_full[last % kStages], (last / kStages) & 1);
      issue_pv(n_tiles - 1);
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P::kN; ++p) reg_fence(o[p]);
      release(&empty[last % kStages]);
      release(&q_empty[qb]);
      tc += n_tiles;

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        if (iq[h] >= lq) continue;
        const float lsafe = l[h] == 0.f ? 1.f : l[h];  // the TPU kernel's l == 0 guard
        bf16* orow = out + ((int64_t)bh * lq + iq[h]) * D + 2 * t;
#pragma unroll
        for (int p = 0; p < P::kN; ++p)
#pragma unroll
          for (int c = 0; c < P::kW / 8; ++c)
            *reinterpret_cast<uint32_t*>(orow + p * P::kW + 8 * c) =
                pack_bf16(o[p][4 * c + 2 * h] / lsafe, o[p][4 * c + 2 * h + 1] / lsafe);
        if (t == 0) lse[(int64_t)bh * lq + iq[h]] = m[h] + logf(lsafe);
      }
    }
  }
}

struct Args {
  const bf16 *q, *k, *v;
  const float* bias;
  int64_t sb, sh, sq, sk;
  bf16* out;
  float* lse;
  int batch, heads, lq, lk;
  float scale;
  int causal;
  const uint32_t* seed;
  uint32_t* keep;
  uint32_t threshold;
  float inv_keep;
};

template <int D, int BN, bool kDrop>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D, BN>();
  const int bh = a.batch * a.heads, row_blocks = (a.lq + kBlockRows - 1) / kBlockRows;
  const int n_items = bh * row_blocks;
  CUtensorMap tq, tk, tv;
  int e = tensor_map(&tq, a.q, bh, a.lq, D, kBlockRows);
  if (e == 0) e = tensor_map(&tk, a.k, bh, a.lk, D, BN);
  if (e == 0) e = tensor_map(&tv, a.v, bh, a.lk, D, BN);
  if (e != 0) return e;
  const int bias_mode = a.bias == nullptr ? 0 : a.sq == 0 ? 1 : 2;
  auto* kernel = flash_attention_fwd_bf16_kernel<D, BN, kDrop>;
  // above 48 KB a kernel's dynamic shared memory must be allowed first
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)min(n_items, sm_count()), kThreads, smem, stream>>>(
      tq, tk, tv, a.bias, a.sb, a.sh, a.sq, a.sk, bias_mode, a.out, a.lse, a.heads, a.lq, a.lk,
      row_blocks, n_items, a.scale, a.causal, a.seed, a.keep, (a.lk + 31) / 32, a.threshold,
      a.inv_keep);
  return (int)cudaGetLastError();
}

// the key tile BN of each head dim (the plain version's _KEY_TILES follows it)
template <int D>
int launch_d(const Args& a, cudaStream_t stream) {
  constexpr int BN = D == 128 ? 64 : 128;
  return a.seed != nullptr ? launch<D, BN, true>(a, stream) : launch<D, BN, false>(a, stream);
}

}  // namespace

// q/out [B*H, Lq, D], k/v [B*H, Lk, D] bfloat16, lse [B*H, Lq] float32, all
// contiguous; bias is NULL or float32 addressed as
// bias[b*sb + h*sh + iq*sq + ik*sk]. seed is NULL (no dropout) or two
// uint32 words on the device; an entry is kept where its Philox bits are
// >= threshold and then scaled by inv_keep, and the mask is stored into
// keep, int32 [B*H, Lq, ceil(Lk / 32)], entry (iq, ik) at bit ik % 32 of
// word ik / 32 (the words of the key tiles a causal block skips are left
// unwritten: every entry there is masked); dropout without keep is refused.
// Returns cudaGetLastError() after the launch (or the error of encoding a
// tensor map or allowing the kernel's shared memory).
extern "C" int ptt_flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                            const void* bias, int64_t sb, int64_t sh, int64_t sq,
                                            int64_t sk, void* out, void* lse, void* keep,
                                            int batch, int heads, int lq, int lk, int d,
                                            float scale, int causal, const void* seed,
                                            uint32_t threshold, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0 || lq == 0) return (int)cudaSuccess;
  if (seed != nullptr && keep == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const float*>(bias),
               sb, sh, sq, sk,
               static_cast<bf16*>(out), static_cast<float*>(lse),
               batch, heads, lq, lk, scale, causal,
               static_cast<const uint32_t*>(seed), static_cast<uint32_t*>(keep),
               threshold, inv_keep};
  switch (d) {
    case 32:
      return launch_d<32>(a, s);
    case 64:
      return launch_d<64>(a, s);
    case 128:
      return launch_d<128>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
