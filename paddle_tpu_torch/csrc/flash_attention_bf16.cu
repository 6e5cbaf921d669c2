// Flash-attention forward for Hopper (sm_90a), bfloat16 operands on the
// tensor cores: the AMP path.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py _fwd_core/_pallas_fwd
// and _fwd_small_core/_pallas_fwd_small on bf16 q, k, v, with the TPU
// kernel's rounding points: S = q k^T accumulated in f32, scaled, masked and
// biased in f32, the online softmax in f32, the probabilities rounded to
// bf16 before P V (p_acc.astype(vt.dtype)), the output accumulated in f32
// and rounded to bf16 once, at the end; lse = m + log(l) in f32.
//
// Bound on the H100: tensor-core work. The two products are 4*Lq*Lk*D flops
// a head on mma.sync.m16n8k16 bf16 (bf16_mma.cuh), one pass, against the
// card's 989 TFLOP/s; the operands are 2*(2*Lq + 2*Lk)*D bytes.
//
// Design: csrc/flash_attention.cu's, on bf16. A block is 4 warps and owns 64
// query rows, 16 a warp, whose A fragments sit in registers for the whole
// kernel. K and V stream through in tiles of BK keys, two tiles in flight:
// the next one is copied by cp.async into the other half of a double buffer
// while the current one is computed on. S comes out in the accumulator
// layout (rows g and g + 8, keys 2t and 2t + 1 of each 8-key block), where
// the scale, the causal mask, the bias, the running row max (two shuffles
// over a quad) and exp are applied; the probabilities, rounded to bf16, are
// the A fragment of P V as they lie (bf16_mma.cuh), with V's B fragments
// read by ldmatrix.trans. Each lane sums its own probabilities; the four
// lanes of a row meet once, at the end.
//
// The bias is f32, read through its strides (stride 0 on broadcast dims),
// before a tile's products. Causal scores are -1e30 and tiles past a
// block's last row are skipped when every row of the block sees key 0, as
// in the f32 kernel; keys and rows past Lk and Lq are zeros and masked.
//
// Dropout: the f32 kernel's, on the same fragment layout. An entry is
// dropped where its 32 Philox bits (philox.cuh, keyed by the seed and
// counted by (key column / 4, query row, batch*head)) fall below
// rate * 2^32, so the f32 and bf16 kernels drop the same entries; the
// denominator sums the undropped probabilities.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "philox.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's causal fill value

// shared memory: the block's query rows, then two K and two V tiles
template <int D, int BK>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(kRows + 4 * BK) * (D + 8) * sizeof(bf16);
}

template <int D, int BK, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                    const bf16* __restrict__ v, const float* __restrict__ bias,
                                    int64_t sb, int64_t sh, int64_t sq, int64_t sk,
                                    bf16* __restrict__ out, float* __restrict__ lse, int heads,
                                    int lq, int lk, float scale, int causal,
                                    const uint32_t* __restrict__ seed, uint32_t threshold,
                                    float inv_keep) {
  constexpr int SD = D + 8, NT = BK / 8, ND = D / 8;
  static_assert(NT * 4 <= 32, "a tile's keep bits fit one word");
  static_assert(BK % 16 == 0 && D % 16 == 0, "whole k16 steps");
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* ks = qs + kRows * SD;  // [2][BK][SD]
  bf16* vs = ks + 2 * BK * SD;

  const int bh = blockIdx.x, b = bh / heads, hd = bh % heads;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* kb = k + (int64_t)bh * lk * D;
  const bf16* vb = v + (int64_t)bh * lk * D;

  // causal: key ik is visible to row iq when ik <= iq + (lk - lq)
  const int shift = lk - lq;
  int n_keys = lk;
  if (causal && q0 + shift >= 0) n_keys = min(lk, q0 + kRows + shift);
  const int n_tiles = (n_keys + BK - 1) / BK;

  stage_rows<D, kRows>(qs, q + (int64_t)bh * lq * D, q0, lq);
  stage_rows<D, BK>(ks, kb, 0, lk);
  stage_rows<D, BK>(vs, vb, 0, lk);
  cp_async_commit();

  // the two query rows of this thread's accumulators: g and g + 8 of its warp
  int iq[2];
  const float* brow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    iq[h] = q0 + 16 * warp + g + 8 * h;
    const int safe = iq[h] < lq ? iq[h] : 0;  // rows past lq compute on row 0, store nothing
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
  float m[2] = {kNegInf, kNegInf};  // running row max
  float l[2] = {0.f, 0.f};          // this lane's share of the running row sum
  uint32_t qf[D / 16][4];           // this warp's query rows as A fragments

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
    cp_async_wait<1>();  // this tile (and, the first time, the query rows) has landed
    __syncthreads();
    if (tile == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) a_rows<SD>(qf[kd], qs, 16 * warp, 16 * kd, lane);
    }

    // S = q k^T for this warp's 16 rows and the tile's BK keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        b_rows<SD>(bf, kt, 8 * n, 16 * kd, lane);
        mma_bf16(s[n], qf[kd], bf[0], bf[1]);
        mma_bf16(s[n + 1], qf[kd], bf[2], bf[3]);
      }
    }

    // scores on the fragments: element e is row g + 8 * (e >> 1), key 2t + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int ik = k0 + 8 * n + 2 * t + (e & 1);
        float sc = -INFINITY;  // keys past lk contribute nothing
        if (ik < lk) {
          sc = s[n][e] * scale;  // scale before the bias, as the TPU kernel does
          if (causal && ik > iq[h] + shift) sc = kNegInf;
          if (bias != nullptr) sc += bv[n][e];
        }
        s[n][e] = sc;
        mx[h] = fmaxf(mx[h], sc);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the row's max over the quad's lanes
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = expf(s[n][e] - m[h]);
        l[h] += p;  // the denominator sums the undropped probabilities
        if (kDrop) p = (keep >> (4 * n + e)) & 1u ? p * inv_keep : 0.f;
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      acc[c][0] *= corr[0];
      acc[c][1] *= corr[0];
      acc[c][2] *= corr[1];
      acc[c][3] *= corr[1];
    }

    // out += P v over this tile's keys, P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(s[2 * kk], s[2 * kk + 1], pa);
#pragma unroll
      for (int c = 0; c < ND; c += 2) {
        uint32_t bf[4];
        b_cols<SD>(bf, vt, 16 * kk, 8 * c, lane);
        mma_bf16(acc[c], pa, bf[0], bf[1]);
        mma_bf16(acc[c + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (iq[h] >= lq) continue;
    const float lsafe = l[h] == 0.f ? 1.f : l[h];  // the TPU kernel's l == 0 guard
    bf16* orow = out + ((int64_t)bh * lq + iq[h]) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      *reinterpret_cast<uint32_t*>(orow + 8 * c) =
          pack_bf16(acc[c][2 * h] / lsafe, acc[c][2 * h + 1] / lsafe);
    if (t == 0) lse[(int64_t)bh * lq + iq[h]] = m[h] + logf(lsafe);
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
  uint32_t threshold;
  float inv_keep;
};

template <int D, int BK, bool kDrop>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D, BK>();
  const dim3 grid((unsigned)(a.batch * a.heads), (unsigned)((a.lq + kRows - 1) / kRows));
  auto* kernel = flash_attention_fwd_bf16_kernel<D, BK, kDrop>;
  // above 48 KB a kernel's dynamic shared memory must be allowed first
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, stream>>>(a.q, a.k, a.v, a.bias, a.sb, a.sh, a.sq, a.sk, a.out,
                                          a.lse, a.heads, a.lq, a.lk, a.scale, a.causal, a.seed,
                                          a.threshold, a.inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B*H, Lq, D], k/v [B*H, Lk, D] bfloat16, lse [B*H, Lq] float32, all
// contiguous; bias is NULL or float32 addressed as
// bias[b*sb + h*sh + iq*sq + ik*sk]. seed is NULL (no dropout) or two
// uint32 words on the device; an entry is kept where its Philox bits are
// >= threshold and then scaled by inv_keep. Returns cudaGetLastError()
// after the launch (or the error of allowing its shared memory).
extern "C" int ptt_flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                            const void* bias, int64_t sb, int64_t sh, int64_t sq,
                                            int64_t sk, void* out, void* lse, int batch,
                                            int heads, int lq, int lk, int d, float scale,
                                            int causal, const void* seed, uint32_t threshold,
                                            float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0 || lq == 0) return (int)cudaSuccess;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const float*>(bias),
               sb, sh, sq, sk,
               static_cast<bf16*>(out), static_cast<float*>(lse),
               batch, heads, lq, lk, scale, causal,
               static_cast<const uint32_t*>(seed), threshold, inv_keep};
  const bool drop = seed != nullptr;
  switch (d) {
    case 32:
      return drop ? launch<32, 64, true>(a, s) : launch<32, 64, false>(a, s);
    case 64:
      return drop ? launch<64, 64, true>(a, s) : launch<64, 64, false>(a, s);
    case 128:
      return drop ? launch<128, 64, true>(a, s) : launch<128, 64, false>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
