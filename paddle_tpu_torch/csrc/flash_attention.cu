// Flash-attention forward for Hopper (sm_90a), float32 on the tensor cores
// in 3xTF32.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py _fwd_core/_pallas_fwd
// (the tiled kernel) and _fwd_small_core/_pallas_fwd_small (one program
// per batch item, taken on the TPU for short sequences): both compute
//   out = softmax(scale * q k^T [causal-masked] + bias) v,   lse = m + log(l)
// over [B, H, L, D] operands without storing the [Lq, Lk] score matrix.
//
// Bound on the H100: tensor-core work. The two products are 4*Lq*Lk*D flops
// a head against 4*(2*Lq + 2*Lk)*D bytes of operands. They run on
// mma.sync.m16n8k8 tf32 in 3xTF32 (tf32x3.cuh), f32-accurate like PyTorch's
// own f32 attention, at a third of the TF32 rate: 495/3 TFLOP/s.
//
// Design: the backward's dQ kernel (csrc/flash_attention_bwd.cu) without
// its dP product, with an online softmax where dQ reads the saved lse. A
// block is 4 warps and owns 64 query rows, 16 a warp, split into hi/lo in
// shared memory once. K and V stream through in tiles of BK keys, each split
// once as it is staged, the next tile waiting in registers meanwhile. Each
// warp computes its 16 x BK tile of S = q k^T in the accumulator layout
// (rows g and g + 8, keys 2t and 2t + 1 of each 8-key block), scales,
// masks and biases it there, and takes the running row max over the four
// lanes of a quad (two shuffles). exp(S - m) then feeds P V from the same
// registers through the (0, 2, 4, 6, 1, 3, 5, 7) k order, the dQ kernel's
// dS k product; the output accumulates in registers and is rescaled by
// exp(m_old - m_new) a tile. Each lane sums its own probabilities; the four
// lanes of a row meet once, at the end, for l and lse = m + log(l). Blocks
// run in any order: nothing carries between them, unlike the TPU grid's
// sequential steps.
//
// The scale comes before the bias, as in the TPU kernel. The bias is read
// through its strides (stride 0 on broadcast dims), so a [B,1,1,Lk] padding
// mask is never expanded, and a tile's bias is read before its products.
// Causal scores are filled with -1e30; tiles past a block's last row are
// skipped, but only when every row of the block sees key 0, so a row that
// sees no key (Lq > Lk) sees all of them at -1e30 and comes out uniform, as
// in the plain version. Keys and rows past Lk and Lq read as 0 and are
// masked, never padded; l == 0 is guarded.
//
// Dropout (upscale in train): the softmax denominator sums the undropped
// probabilities, then the kept ones are scaled by 1/(1-rate) on their way
// into P V, as in the TPU kernel. An entry is dropped where its 32 Philox
// bits (philox.cuh, keyed by the seed the wrapper drew and counted by (key
// column / 4, query row, batch*head)) fall below rate * 2^32. A thread holds
// keys 2t, 2t+1 of an 8-key block in rows g and g+8, as a dQ thread does:
// lanes t and t^1 share one 4-key call, one draws row g and the other row
// g+8, and they trade two words by shuffle. The bits are drawn before the
// tile's products. The counter keying makes the mask independent of the
// tiling, so the dQ and dK/dV kernels regenerate it exactly.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's causal fill value

// shared memory: the block's query rows and the streamed K and V tile, each
// split into hi and lo
template <int D, int BK>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(2 * (kRows + 2 * BK) * (D + 4)) * sizeof(float);
}

template <int D, int BK, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               int64_t sb, int64_t sh, int64_t sq, int64_t sk,
                               float* __restrict__ out, float* __restrict__ lse, int heads,
                               int lq, int lk, float scale, int causal,
                               const uint32_t* __restrict__ seed, uint32_t threshold,
                               float inv_keep) {
  constexpr int SD = D + 4, NT = BK / 8, ND = D / 8;
  static_assert(NT * 4 <= 32, "a tile's keep bits fit one word");
  extern __shared__ float4 smem4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem4);
  const Split qs{sm, sm + kRows * SD};  // this block's query rows, split
  const Split kt{sm + 2 * kRows * SD, sm + 2 * kRows * SD + BK * SD};  // this key tile, split
  const Split vt{sm + 2 * kRows * SD + 2 * BK * SD, sm + 2 * kRows * SD + 3 * BK * SD};

  const int bh = blockIdx.x, b = bh / heads, hd = bh % heads;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* kb = k + (int64_t)bh * lk * D;
  const float* vb = v + (int64_t)bh * lk * D;

  // causal: key ik is visible to row iq when ik <= iq + (lk - lq)
  const int shift = lk - lq;
  int n_keys = lk;
  if (causal && q0 + shift >= 0) n_keys = min(lk, q0 + kRows + shift);
  const int n_tiles = (n_keys + BK - 1) / BK;

  Staged<D, BK> k_next, v_next;
  k_next.load(kb, 0, lk);
  v_next.load(vb, 0, lk);
  stage_own<D, BK>(q + (int64_t)bh * lq * D, q0, lq, qs);

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
    __syncthreads();  // this tile (and, the first time, the query rows) is split
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

    // S = q k^T for this warp's 16 rows and the tile's BK keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 8) {
      uint32_t qh[4], ql[4];
      a_frag<SD>(qs.hi + own, qs.lo + own, d0, g, t, qh, ql);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma3_b(s[n], qh, ql, kt, (8 * n + g) * SD + d0 + t, 4);
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

    // out += P v, contracting over this tile's keys
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t ph[4], pl[4];
      acc_frag(s[n], ph, pl);
#pragma unroll
      for (int c = 0; c < ND; ++c)
        mma3_b(acc[c], ph, pl, vt, (8 * n + 2 * t) * SD + 8 * c + g, SD);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (iq[h] >= lq) continue;
    const float lsafe = l[h] == 0.f ? 1.f : l[h];  // the TPU kernel's l == 0 guard
    float* orow = out + ((int64_t)bh * lq + iq[h]) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c) =
          make_float2(acc[c][2 * h] / lsafe, acc[c][2 * h + 1] / lsafe);
    if (t == 0) lse[(int64_t)bh * lq + iq[h]] = m[h] + logf(lsafe);
  }
}

struct Args {
  const float *q, *k, *v, *bias;
  int64_t sb, sh, sq, sk;
  float *out, *lse;
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
  auto* kernel = flash_attention_fwd_kernel<D, BK, kDrop>;
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

// q/out [B*H, Lq, D], k/v [B*H, Lk, D], lse [B*H, Lq], all float32 and
// contiguous; bias is NULL or float32 addressed as
// bias[b*sb + h*sh + iq*sq + ik*sk]. seed is NULL (no dropout) or two
// uint32 words on the device; an entry is kept where its Philox bits are
// >= threshold and then scaled by inv_keep. Returns cudaGetLastError()
// after the launch (or the error of allowing its shared memory).
extern "C" int ptt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* bias, int64_t sb, int64_t sh, int64_t sq,
                                       int64_t sk, void* out, void* lse, int batch, int heads,
                                       int lq, int lk, int d, float scale, int causal,
                                       const void* seed, uint32_t threshold, float inv_keep,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads == 0 || lq == 0) return (int)cudaSuccess;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(bias),
               sb, sh, sq, sk,
               static_cast<float*>(out), static_cast<float*>(lse),
               batch, heads, lq, lk, scale, causal,
               static_cast<const uint32_t*>(seed), threshold, inv_keep};
  const bool drop = seed != nullptr;
  // keys a tile, by head dim, with and without dropout: at D = 64 on the
  // H100 64-key tiles (two blocks an SM) were the fastest without dropout
  // and 32-key tiles with it, at L = 128 to 512; 32-row blocks were slower
  // at every length, L = 128 included.
  switch (d) {
    case 32:
      return drop ? launch<32, 64, true>(a, s) : launch<32, 64, false>(a, s);
    case 64:
      return drop ? launch<64, 32, true>(a, s) : launch<64, 64, false>(a, s);
    case 128:
      return drop ? launch<128, 16, true>(a, s) : launch<128, 16, false>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
