// Conv-as-matmul with a fused batch-norm epilogue in bf16, for Hopper (sm_90a).
//
// Replaces the bf16 forms of paddle_tpu/ops/pallas/conv_bn_relu.py
// _mm_affine_relu (eval: y = relu(bf16(p2 @ w2) * scale + shift), rounded to
// bf16, the pre-activation never stored) and _mm_stats (training: co =
// bf16(p2 @ w2) plus per-tile float32 channel sums of the rounded co). p2
// [M, K] are the conv's patches (or its channels-last input for a 1x1
// stride-1 conv) and w2 [K, N] its weight, N = Cout, both bf16 and row-major;
// w2's rows are ldb >= N elements apart; scale and shift are float32.
//
// Bound on the H100: device memory. At layer1's 3x3 conv at batch 128
// ([401408, 576] @ [576, 64]) reading p2 once takes 0.138 ms at 3.35 TB/s and
// the products 0.030 ms at bf16's 989 TFLOP/s: the kernel has to keep p2's
// bytes streaming, and the tensor cores have room to spare.
//
// Design: the float32 kernel's (conv_bn_relu_mm.cu) with bf16 operands. One
// block of 4 warps per 128 x 64 output tile, each warp a 64 x 32 quarter (4 x
// 4 m16n8 accumulators in float32). Slabs of 32 k (a 128 x 32 slab of p2, a 32
// x 64 slab of w2, 14.5 KB with padding) stream through a ring of kStages slabs
// in shared memory by 16-byte cp.async with no registers in between, one
// cp.async.wait_group and one barrier a slab. Fragments come from shared
// memory by ldmatrix (p2's as it lies; w2's, which is k-major, transposed by
// ldmatrix.trans, so neither operand is rearranged in device memory), and
// each step of 16 k issues 16 mma.sync.m16n8k16 bf16 products with float32
// sums. Rows sit kSA (80 bytes) and kSB (144 bytes) apart, so the 8 rows an
// ldmatrix phase reads fall on distinct bank groups. A 16-byte copy needs a
// row to start on a 16-byte boundary: K must be a multiple of 8 (the wrapper
// pads K with zero columns in the lowering; the stem's 147 becomes 152) and
// ldb a multiple of 8 (the wrapper pads w2's rows). The copies' source size
// fills what lies past M, K or ldb with zeros. This is mma.sync, not wgmma:
// the simple first kernel; the tensor cores are not what bounds it.
//
// Rounding, as the TPU kernels round: the float32 sums are rounded to bf16
// once (co); the channel sums add the rounded values in float32; the affine
// rounds as __fmul_rn then __fadd_rn on the rounded co, then relu, then bf16.
//
// Epilogues (a template parameter):
//   kAffineRelu: y = bf16(relu(bf16(acc) * scale + shift));
//   kStats:      co = bf16(acc), and one [tiles, N] row of float32 channel
//                sums of the stored co per block (rows >= M masked): the 8 row
//                groups of a warp meet by shuffles, the 2 warps of a column in
//                shared memory, in a fixed order. No atomics, so the sums
//                repeat bit for bit;
//   kPartial:    split-K (eval only): block z of the grid multiplies slabs
//                [z * slice_slabs, (z + 1) * slice_slabs) and stores its raw
//                float32 sums in slice z of an [S, M, N] workspace;
//                conv_mm_bf16_reduce_kernel adds the S slices in slice order,
//                rounds the sum to bf16 and applies the affine + relu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBM = 128;  // output rows a block
constexpr int kBN = 64;   // output columns a block
constexpr int kBK = 32;   // depth of one slab
constexpr int kWM = 64;   // output rows a warp
constexpr int kWN = 32;   // output columns a warp
constexpr int kWarpsN = kBN / kWN;
constexpr int kThreads = 32 * (kBM / kWM) * kWarpsN;
constexpr int kMT = kWM / 16;  // m16 tiles a warp
constexpr int kNT = kWN / 8;   // n8 tiles a warp
constexpr int kStages = 4;     // slabs in the ring
constexpr int kSA = kBK + 8;   // elements between p2 rows of a slab (80 bytes)
constexpr int kSB = kBN + 8;   // elements between w2 rows of a slab (144 bytes)
constexpr int kStageElems = kBM * kSA + kBK * kSB;
constexpr int kSmemBytes = kStages * kStageElems * 2;
constexpr int kReduceThreads = 256;

enum Epilogue { kAffineRelu = 0, kStats = 1, kPartial = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the batch-norm pre-activation rounded as the plain version rounds it, then relu
__device__ __forceinline__ float affine_relu(float x, float scale, float shift) {
  return fmaxf(__fadd_rn(__fmul_rn(x, scale), shift), 0.f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory past L1, of which the first
// `bytes` (0 or 16) are read and the rest filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b, m16n8k16, bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy slab [kb, kb + kBK) of p2 rows [row0, row0 + kBM) and of w2 columns
// [col0, col0 + kBN) into one stage of the ring, 8 elements a copy; what lies
// at or past m, k_end or ldb is filled with zeros (k_end and ldb are
// multiples of 8, so a chunk is all in or all out).
__device__ __forceinline__ void load_slab(__nv_bfloat16* as, const __nv_bfloat16* __restrict__ a,
                                          const __nv_bfloat16* __restrict__ b, int64_t row0,
                                          int col0, int kb, int64_t m, int k, int k_end,
                                          int ldb) {
  __nv_bfloat16* bs = as + kBM * kSA;
  constexpr int kAChunks = kBK / 8, kBChunks = kBN / 8;
  static_assert(kBM * kAChunks % kThreads == 0 && kBK * kBChunks % kThreads == 0,
                "every thread copies whole chunks");
#pragma unroll
  for (int p = 0; p < kBM * kAChunks / kThreads; ++p) {
    const int i = threadIdx.x + p * kThreads;
    const int r = i / kAChunks, q = i % kAChunks;
    const int c = kb + 8 * q;
    const bool in = row0 + r < m && c < k_end;
    cp_async16(as + r * kSA + 8 * q, in ? a + (row0 + r) * k + c : a, in ? 16 : 0);
  }
#pragma unroll
  for (int p = 0; p < kBK * kBChunks / kThreads; ++p) {
    const int i = threadIdx.x + p * kThreads;
    const int r = i / kBChunks, q = i % kBChunks;
    const int c = col0 + 8 * q;
    const bool in = kb + r < k_end && c < ldb;
    cp_async16(bs + r * kSB + 8 * q, in ? b + (int64_t)(kb + r) * ldb + c : b, in ? 16 : 0);
  }
}

// out [M, N] (float32 slice blockIdx.z of the workspace for kPartial, bf16
// otherwise) of p2 [M, K] @ w2 [K, N] over slabs [blockIdx.z * slice_slabs,
// ...) of K
template <int EPI>
__global__ void __launch_bounds__(kThreads, 3)
    conv_mm_bf16_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                        int64_t m, int k, int n, int ldb, int slice_slabs,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        void* __restrict__ out, float* __restrict__ partial) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp / kWarpsN * kWM, wc = warp % kWarpsN * kWN;  // the warp's corner
  const int64_t row0 = (int64_t)blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * slice_slabs * kBK;
  const int k_end = min(k, k_begin + slice_slabs * kBK);
  const int slabs = (k_end - k_begin + kBK - 1) / kBK;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the ring: slab s sits in stage s % kStages; one commit group a slab,
  // empty past the last, so the wait below counts slabs
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs)
      load_slab(smem + s * kStageElems, a, b, row0, col0, k_begin + s * kBK, m, k, k_end, ldb);
    cp_async_commit();
  }
  // ldmatrix addresses: A rows wr + 16i + lane % 16 at k + 8 (lane / 16); B
  // rows k + lane % 8 + 8 (lane / 8 % 2) at columns wc + 8j + 8 (lane / 16)
  const int a_off = (wr + lane % 16) * kSA + 8 * (lane / 16);
  const int b_off = (lane % 8 + 8 * (lane / 8 % 2)) * kSB + wc + 8 * (lane / 16);
#pragma unroll 1
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kStages - 2>();  // slab s has landed (this thread's copies)
    __syncthreads();               // everyone's, and slab s - 1's stage is free
    const int next = s + kStages - 1;
    if (next < slabs)
      load_slab(smem + next % kStages * kStageElems, a, b, row0, col0, k_begin + next * kBK, m,
                k, k_end, ldb);
    cp_async_commit();
    const __nv_bfloat16* as = smem + s % kStages * kStageElems;
    const __nv_bfloat16* bs = as + kBM * kSA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bf[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + b_off + kk * kSB + j * 8);
        bf[j][0] = r[0], bf[j][1] = r[1], bf[j + 1][0] = r[2], bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        uint32_t af[4];
        ldmatrix_x4(af, as + a_off + i * 16 * kSA + kk);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }

  // a thread holds rows wr + 16i + g (+ 8) at columns wc + 8j + 2t (+ 1)
  float sc[kNT][2], sh[kNT][2], colsum[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = col0 + wc + j * 8 + 2 * t + e;
      sc[j][e] = (EPI == kAffineRelu && c < n) ? scale[c] : 0.f;
      sh[j][e] = (EPI == kAffineRelu && c < n) ? shift[c] : 0.f;
      colsum[j][e] = 0.f;
    }
  const bool pairs = n % 2 == 0;  // pair stores stay aligned
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + wr + i * 16 + h * 8 + g;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = col0 + wc + j * 8 + 2 * t;
        if (c >= n) continue;
        const float x0 = acc[i][j][2 * h], x1 = acc[i][j][2 * h + 1];
        if (EPI == kPartial) {
          float* dst = static_cast<float*>(out) + (int64_t)blockIdx.z * m * n + r * n + c;
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
          } else {
            dst[0] = x0;
            if (c + 1 < n) dst[1] = x1;
          }
          continue;
        }
        float v0 = round_bf16(x0), v1 = round_bf16(x1);
        if (EPI == kStats) {
          colsum[j][0] += v0;
          if (c + 1 < n) colsum[j][1] += v1;
        } else {
          v0 = affine_relu(v0, sc[j][0], sh[j][0]);
          v1 = affine_relu(v1, sc[j][1], sh[j][1]);
        }
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + r * n + c;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (c + 1 < n) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }

  if (EPI == kStats) {
    // the 8 row groups of a warp meet by shuffles (lanes t, t + 4, ... hold
    // the same columns), then the warps of a column in shared memory, the
    // ring's space, added in warp order
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int d = 4; d < 32; d *= 2)
          colsum[j][e] += __shfl_xor_sync(0xffffffffu, colsum[j][e], d);
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
    float* red = reinterpret_cast<float*>(smem);  // [kBM / kWM][kBN]
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) red[wr / kWM * kBN + wc + j * 8 + 2 * t + e] = colsum[j][e];
    }
    __syncthreads();
    const int c = threadIdx.x;
    if (c < kBN && col0 + c < n) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kBM / kWM; ++w) s += red[w * kBN + c];
      partial[(int64_t)blockIdx.x * n + col0 + c] = s;
    }
  }
}

// y [M, N] = bf16(relu(bf16(ws[0] + ws[1] + ... + ws[S-1]) * scale + shift)),
// the split-K slices of the float32 workspace added in slice order; VEC: 4
// columns a thread (N % 4 == 0).
template <bool VEC>
__global__ void __launch_bounds__(kReduceThreads)
    conv_mm_bf16_reduce_kernel(const float* __restrict__ ws, int slices, int64_t m, int n,
                               const float* __restrict__ scale, const float* __restrict__ shift,
                               __nv_bfloat16* __restrict__ y) {
  const int64_t mn = m * n;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    for (int64_t i = first; i < mn / 4; i += step) {
      float4 s = reinterpret_cast<const float4*>(ws)[i];
      for (int z = 1; z < slices; ++z) {
        const float4 v = reinterpret_cast<const float4*>(ws + z * mn)[i];
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      const int c = (int)(i * 4 % n);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(y + i * 4);
      dst[0] = __floats2bfloat162_rn(affine_relu(round_bf16(s.x), scale[c], shift[c]),
                                     affine_relu(round_bf16(s.y), scale[c + 1], shift[c + 1]));
      dst[1] = __floats2bfloat162_rn(affine_relu(round_bf16(s.z), scale[c + 2], shift[c + 2]),
                                     affine_relu(round_bf16(s.w), scale[c + 3], shift[c + 3]));
    }
  } else {
    for (int64_t i = first; i < mn; i += step) {
      float s = ws[i];
      for (int z = 1; z < slices; ++z) s += ws[z * mn + i];
      const int c = (int)(i % n);
      y[i] = __float2bfloat16_rn(affine_relu(round_bf16(s), scale[c], shift[c]));
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int EPI>
int launch(const void* a, const void* b, int64_t m, int k, int n, int ldb, int slices,
           int slice_slabs, const void* scale, const void* shift, void* out, void* partial,
           void* stream) {
  // 16-byte copies: bases on 16 bytes, K and w2's row length multiples of 8
  if (m <= 0 || k <= 0 || n <= 0 || k % 8 != 0 || ldb % 8 != 0 || ldb < n ||
      (n + kBN - 1) / kBN > 65535 || (m + kBM - 1) / kBM > 0x7fffffff || !aligned16(a) ||
      !aligned16(b) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  auto* kernel = conv_mm_bf16_kernel<EPI>;
  // above 48 KB a kernel's dynamic shared memory must be allowed first
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)((n + kBN - 1) / kBN),
                  (unsigned)slices);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), m, k, n, ldb,
      slice_slabs, static_cast<const float*>(scale), static_cast<const float*>(shift), out,
      static_cast<float*>(partial));
  return (int)cudaGetLastError();
}

}  // namespace

// y [M, N] bf16 = relu(bf16(a [M, K] @ b [K, N]) * scale [N] + shift [N]);
// b's rows ldb elements apart. a, b and y 16-byte aligned, K and ldb
// multiples of 8 (else cudaErrorInvalidValue). Returns cudaGetLastError()
// after the launch.
extern "C" int ptt_conv_mm_bf16_affine_relu(const void* a, const void* b, const void* scale,
                                            const void* shift, void* y, int64_t m, int k, int n,
                                            int ldb, void* stream) {
  const int slabs = (k + kBK - 1) / kBK;
  return launch<kAffineRelu>(a, b, m, k, n, ldb, 1, slabs, scale, shift, y, nullptr, stream);
}

// The same y through split-K: `slices` slices of `slice_slabs` slabs of K
// each (the last one shorter, none empty) into the float32 ws [slices, M, N],
// then the ordered sum, its rounding to bf16 and the affine + relu. Two
// launches; returns the first error.
extern "C" int ptt_conv_mm_bf16_affine_relu_split(const void* a, const void* b,
                                                  const void* scale, const void* shift, void* y,
                                                  void* ws, int64_t m, int k, int n, int ldb,
                                                  int slices, int slice_slabs, void* stream) {
  const int slabs = (k + kBK - 1) / kBK;
  if (slices < 1 || slices > 65535 || slice_slabs < 1 || (slices - 1) * slice_slabs >= slabs ||
      !aligned16(y))
    return (int)cudaErrorInvalidValue;
  int err = launch<kPartial>(a, b, m, k, n, ldb, slices, slice_slabs, nullptr, nullptr, ws,
                             nullptr, stream);
  if (err != 0) return err;
  const bool vec = n % 4 == 0;
  const int64_t items = m * n / (vec ? 4 : 1);
  // a few blocks an SM of the card's 132, each walking its share
  const unsigned blocks =
      (unsigned)std::min<int64_t>((items + kReduceThreads - 1) / kReduceThreads, 132 * 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y);
  if (vec)
    conv_mm_bf16_reduce_kernel<true><<<blocks, kReduceThreads, 0, s>>>(w, slices, m, n, sc, sh,
                                                                       out);
  else
    conv_mm_bf16_reduce_kernel<false><<<blocks, kReduceThreads, 0, s>>>(w, slices, m, n, sc, sh,
                                                                        out);
  return (int)cudaGetLastError();
}

// co [M, N] bf16 = bf16(a @ b), and the float32 partial [ceil(M / 128), N]
// holding each 128-row tile's column sums of the rounded co. Returns
// cudaGetLastError() after the launch.
extern "C" int ptt_conv_mm_bf16_stats(const void* a, const void* b, void* co, void* partial,
                                      int64_t m, int k, int n, int ldb, void* stream) {
  const int slabs = (k + kBK - 1) / kBK;
  return launch<kStats>(a, b, m, k, n, ldb, 1, slabs, nullptr, nullptr, co, partial, stream);
}

// Rows of one partial-sum tile, for the wrapper's allocation.
extern "C" int ptt_conv_mm_bf16_tile_rows() { return kBM; }
