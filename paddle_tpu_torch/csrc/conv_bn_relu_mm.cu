// Conv-as-matmul with a fused batch-norm epilogue, for Hopper (sm_90a), f32
// products on the tensor cores in 3xTF32.
//
// Replaces paddle_tpu/ops/pallas/conv_bn_relu.py _mm_affine_relu (eval:
// y = relu((p2 @ w2) * scale + shift), the pre-activation never stored)
// and _mm_stats (training: co = p2 @ w2 plus per-tile channel sums of co).
// p2 [M, K] are the conv's patches (or its channels-last input for a 1x1
// stride-1 conv), w2 [K, N] its weight, N = Cout; all float32, row-major.
//
// Bound on the H100: device memory. The products run on mma.sync.m16n8k8
// tf32 as lo*hi + hi*lo + hi*hi (tf32x3.cuh), f32-accurate at 495/3 = 165
// TFLOP/s. At layer1's 3x3 conv at batch 128 ([401408, 576] @ [576, 64])
// they take 0.18 ms there, while reading p2 once takes 0.31 ms at 3.35 TB/s:
// the kernel has to keep p2's bytes streaming.
//
// Design: one block of 4 warps per 128 x 64 output tile, each warp a 64 x 32
// quarter of it (4 x 4 m16n8 accumulators). Slabs of 32 k (a 128 x 32 slab
// of p2 and a 32 x 64 slab of w2) stream through a ring of kStages slabs in
// shared memory, copied by cp.async with no registers in between: the copies
// of the next kStages - 1 slabs are in flight while one is multiplied, with
// one cp.async.wait_group and one barrier a slab. A thread splits each value
// into hi/lo as it reads it from shared memory for a fragment, and issues
// each of the three passes over its 4 independent n8 tiles before the next,
// so no product waits on the one before it. Within a step of 8 k the
// physical k order (0, 1), (2, 3), ... is read as the logical (t, t + 4) of
// lane t, so each A-fragment row pair is one 8-byte load; rows sit kSA (A)
// and kSB (B) words apart, which puts a warp's fragment loads on distinct
// banks. Every copy is 16 bytes, at any K and N: the stem's K = 3*7*7 = 147
// puts p2's rows 588 bytes apart, so a row that starts off a 16-byte
// boundary is copied from the boundary before it and read that many floats
// further on (load_slab). The copies' source size fills what lies past M,
// K or N with zeros, so nothing is padded.
//
// Accuracy: the tensor cores add a product into an f32 accumulator without
// rounding it to nearest, and the error grows with the number of additions:
// summed in the accumulators over all of layer4's K = 4608, the products
// landed past the 2e-5 of the largest output that the checks allow against
// the plain f32 product on the H100. So each slab's 12 products per output
// start from zero, and the slab's sum is added into the running sum in
// ordinary f32 arithmetic (64 FADDs a slab a thread).
//
// Epilogues (a template parameter):
//   kAffineRelu: y = relu(acc * scale + shift), rounded as __fmul_rn then
//                __fadd_rn, the way the plain version and the training
//                kernels round the same pre-activation;
//   kStats:      store co = acc, and one [tiles, N] row of channel sums per
//                block (rows >= M masked): the 8 row groups of a warp meet by
//                shuffles, the 2 warps of a column in shared memory, in a
//                fixed order. No atomics, so the sums repeat bit for bit;
//   kPartial:    split-K (eval only). Block z of the grid multiplies slabs
//                [z * slice_slabs, (z + 1) * slice_slabs) and stores its raw
//                sums in slice z of an [S, M, N] workspace;
//                conv_mm_reduce_kernel then adds the S slices in slice order
//                and applies the affine + relu. For products whose output
//                tiles fill less than a wave of the card (serving at small
//                batch: ResNet-50's layer4 at batch 1 has 8 tiles and K =
//                4608). The wrapper plans S.
// Stores are 8 bytes a lane (a quad writes 32 contiguous bytes of a row)
// when N is even.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tf32x3.cuh"

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
constexpr int kStages = 3;     // slabs in the ring
constexpr int kSA = kBK + 8;   // words between p2 rows of a slab
constexpr int kSB = kBN + 4;   // words between w2 rows of a slab
constexpr int kStageFloats = kBM * kSA + kBK * kSB;
constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);
constexpr int kReduceThreads = 256;

enum Epilogue { kAffineRelu = 0, kStats = 1, kPartial = 2 };

// the batch-norm pre-activation rounded as the plain version rounds it, then relu
__device__ __forceinline__ float affine_relu(float x, float scale, float shift) {
  return fmaxf(__fadd_rn(__fmul_rn(x, scale), shift), 0.f);
}

// d = a * b, the m16n8k8 tf32 product onto a zero accumulator
__device__ __forceinline__ void mma_from_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory past L1, of which the first
// `bytes` (0 to 16) are read and the rest are filled with zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
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

// Copy slab [kb, kb + kBK) of p2 rows [row0, row0 + kBM) and of w2 columns
// [col0, col0 + kBN) into one stage of the ring, in 16-byte chunks; what lies
// at or past m, k_end or n is filled with zeros. ALIGNED: K % 4 == 0 and
// N % 4 == 0, so every row starts on a 16-byte boundary. Otherwise p2 row r
// starts ph = r * K % 4 floats past one: its chunks start ph floats before
// kb, one more chunk a row, and its slab lands ph floats into its row of
// the stage (the first ph are the slab before's and never read); w2's rows
// the same with N. row0, col0 and kb are multiples of 4, so the phase
// depends on r alone.
template <bool ALIGNED>
__device__ __forceinline__ void load_slab(float* as, const float* __restrict__ a,
                                          const float* __restrict__ b, int64_t row0, int col0,
                                          int kb, int64_t m, int k, int k_end, int n) {
  float* bs = as + kBM * kSA;
  constexpr int kAChunks = kBK / 4 + !ALIGNED, kBChunks = kBN / 4 + !ALIGNED;
  static_assert(kBM * kAChunks % kThreads == 0, "p2's chunks are whole for every thread");
#pragma unroll
  for (int p = 0; p < kBM * kAChunks / kThreads; ++p) {
    const int i = threadIdx.x + p * kThreads;
    const int r = i / kAChunks, q = i % kAChunks;
    const int c = kb - (ALIGNED ? 0 : r * (k & 3) & 3) + 4 * q;  // the chunk's first k
    const int bytes = row0 + r < m ? 4 * max(0, min(4, k_end - c)) : 0;
    cp_async16(as + r * kSA + 4 * q, bytes ? a + (row0 + r) * k + c : a, bytes);
  }
#pragma unroll
  for (int p = 0; p < (kBK * kBChunks + kThreads - 1) / kThreads; ++p) {
    const int i = threadIdx.x + p * kThreads;
    if (ALIGNED || i < kBK * kBChunks) {
      const int r = i / kBChunks, q = i % kBChunks;
      const int c = col0 - (ALIGNED ? 0 : r * (n & 3) & 3) + 4 * q;  // the chunk's first column
      const int bytes = kb + r < k_end ? 4 * max(0, min(4, n - c)) : 0;
      cp_async16(bs + r * kSB + 4 * q, bytes ? b + (int64_t)(kb + r) * n + c : b, bytes);
    }
  }
}

// out [M, N] (slice blockIdx.z of the workspace for kPartial) of p2 [M, K]
// @ w2 [K, N] over slabs [blockIdx.z * slice_slabs, ...) of K; ALIGNED: K
// and N are multiples of 4 (load_slab).
template <int EPI, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 2)
    conv_mm_kernel(const float* __restrict__ a, const float* __restrict__ b, int64_t m, int k,
                   int n, int slice_slabs, const float* __restrict__ scale,
                   const float* __restrict__ shift, float* __restrict__ out,
                   float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp / kWarpsN * kWM, wc = warp % kWarpsN * kWN;  // the warp's corner
  const int64_t row0 = (int64_t)blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * slice_slabs * kBK;
  const int k_end = min(k, k_begin + slice_slabs * kBK);
  const int slabs = (k_end - k_begin + kBK - 1) / kBK;
  if (EPI == kPartial) out += (int64_t)blockIdx.z * m * n;
  // where this thread's fragment rows sit past their row's start in a stage
  // (load_slab): p2 rows wr + 16i + g (+ 8) are g modulo 4, w2 rows kk + 2t
  // (+ 1) are 2t (+ 1) modulo 4
  const int a_ph = ALIGNED ? 0 : g * (k & 3) & 3;
  const int b_ph0 = ALIGNED ? 0 : 2 * t * (n & 3) & 3;
  const int b_ph1 = ALIGNED ? 0 : (2 * t + 1) * (n & 3) & 3;

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
      load_slab<ALIGNED>(smem + s * kStageFloats, a, b, row0, col0, k_begin + s * kBK, m, k,
                        k_end, n);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kStages - 2>();  // slab s has landed (this thread's copies)
    __syncthreads();               // everyone's, and slab s - 1's stage is free
    const int next = s + kStages - 1;
    if (next < slabs)
      load_slab<ALIGNED>(smem + next % kStages * kStageFloats, a, b, row0, col0,
                        k_begin + next * kBK, m, k, k_end, n);
    cp_async_commit();
    const float* as = smem + s % kStages * kStageFloats;
    const float* bs = as + kBM * kSA;
    float part[kMT][kNT][4];  // this slab's products, added into acc after it
    // one step of 8 k; physical k kk + 2t and kk + 2t + 1 are lane t's
    // logical k t and t + 4
    auto step = [&](int kk, auto first) {
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* bp = bs + (kk + 2 * t) * kSB + wc + j * 8 + g;
        split(bp[b_ph0], bh[j][0], bl[j][0]);
        split(bp[kSB + b_ph1], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const float* ap = as + (wr + i * 16 + g) * kSA + a_ph + kk + 2 * t;
        float av[4];
        if (ALIGNED) {  // rows g and g + 8 at k t and t + 4, one 8-byte load each
          const float2 r0 = *reinterpret_cast<const float2*>(ap);
          const float2 r8 = *reinterpret_cast<const float2*>(ap + 8 * kSA);
          av[0] = r0.x, av[1] = r8.x, av[2] = r0.y, av[3] = r8.y;
        } else {
          av[0] = ap[0], av[1] = ap[8 * kSA], av[2] = ap[1], av[3] = ap[8 * kSA + 1];
        }
        uint32_t ah[4], al[4];
        split4(av, ah, al);
        // lo*hi + hi*lo + hi*hi, pass by pass over the kNT independent tiles
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (decltype(first)::value) mma_from_zero(part[i][j], al, bh[j][0], bh[j][1]);
          else mma(part[i][j], al, bh[j][0], bh[j][1]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(part[i][j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(part[i][j], ah, bh[j][0], bh[j][1]);
      }
    };
    step(0, std::true_type{});
#pragma unroll
    for (int kk = 8; kk < kBK; kk += 8) step(kk, std::false_type{});
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
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
  const bool pairs = n % 2 == 0;  // 8-byte stores stay aligned
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + wr + i * 16 + h * 8 + g;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = col0 + wc + j * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[i][j][2 * h + e];
          if (EPI == kAffineRelu) {
            v[e] = affine_relu(x, sc[j][e], sh[j][e]);
          } else {
            v[e] = x;
            if (EPI == kStats) colsum[j][e] += x;
          }
        }
        float* dst = out + r * n + c;
        if (pairs && c < n) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          if (c < n) dst[0] = v[0];
          if (c + 1 < n) dst[1] = v[1];
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
    float* red = smem;  // [kBM / kWM][kBN]
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

// y [M, N] = relu((ws[0] + ws[1] + ... + ws[S-1]) * scale + shift), the
// split-K slices of the workspace added in slice order; VEC: 4 columns a
// thread (N % 4 == 0).
template <bool VEC>
__global__ void __launch_bounds__(kReduceThreads)
    conv_mm_reduce_kernel(const float* __restrict__ ws, int slices, int64_t m, int n,
                          const float* __restrict__ scale, const float* __restrict__ shift,
                          float* __restrict__ y) {
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
      reinterpret_cast<float4*>(y)[i] =
          make_float4(affine_relu(s.x, scale[c], shift[c]),
                      affine_relu(s.y, scale[c + 1], shift[c + 1]),
                      affine_relu(s.z, scale[c + 2], shift[c + 2]),
                      affine_relu(s.w, scale[c + 3], shift[c + 3]));
    }
  } else {
    for (int64_t i = first; i < mn; i += step) {
      float s = ws[i];
      for (int z = 1; z < slices; ++z) s += ws[z * mn + i];
      const int c = (int)(i % n);
      y[i] = affine_relu(s, scale[c], shift[c]);
    }
  }
}

template <int EPI, bool ALIGNED>
int launch_mm(const void* a, const void* b, int64_t m, int k, int n, int slices, int slice_slabs,
              const void* scale, const void* shift, void* out, void* partial,
              cudaStream_t stream) {
  auto* kernel = conv_mm_kernel<EPI, ALIGNED>;
  // above 48 KB a kernel's dynamic shared memory must be allowed first
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)((n + kBN - 1) / kBN),
                  (unsigned)slices);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), m, k, n, slice_slabs,
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(out), static_cast<float*>(partial));
  return (int)cudaGetLastError();
}

// the copies need 16-byte aligned bases; rows of any length (load_slab)
template <int EPI>
int launch(const void* a, const void* b, int64_t m, int k, int n, int slices, int slice_slabs,
           const void* scale, const void* shift, void* out, void* partial, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (n + kBN - 1) / kBN > 65535 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* run = k % 4 == 0 && n % 4 == 0 ? launch_mm<EPI, true> : launch_mm<EPI, false>;
  return run(a, b, m, k, n, slices, slice_slabs, scale, shift, out, partial, s);
}

}  // namespace

// y [M, N] = relu((a [M, K] @ b [K, N]) * scale [N] + shift [N]), a and b
// 16-byte aligned (else cudaErrorInvalidValue). Returns cudaGetLastError()
// after the launch.
extern "C" int ptt_conv_mm_affine_relu(const void* a, const void* b, const void* scale,
                                       const void* shift, void* y, int64_t m, int k, int n,
                                       void* stream) {
  const int slabs = (k + kBK - 1) / kBK;
  return launch<kAffineRelu>(a, b, m, k, n, 1, slabs, scale, shift, y, nullptr, stream);
}

// The same y through split-K: `slices` slices of `slice_slabs` slabs of K
// each (the last one shorter, none empty) into ws [slices, M, N], then the
// ordered sum and the affine + relu. Two launches; returns the first
// error.
extern "C" int ptt_conv_mm_affine_relu_split(const void* a, const void* b, const void* scale,
                                             const void* shift, void* y, void* ws, int64_t m,
                                             int k, int n, int slices, int slice_slabs,
                                             void* stream) {
  const int slabs = (k + kBK - 1) / kBK;
  if (slices < 1 || slices > 65535 || slice_slabs < 1 || (slices - 1) * slice_slabs >= slabs)
    return (int)cudaErrorInvalidValue;
  int err = launch<kPartial>(a, b, m, k, n, slices, slice_slabs, nullptr, nullptr, ws, nullptr,
                             stream);
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
  float* out = static_cast<float*>(y);
  if (vec)
    conv_mm_reduce_kernel<true><<<blocks, kReduceThreads, 0, s>>>(w, slices, m, n, sc, sh, out);
  else
    conv_mm_reduce_kernel<false><<<blocks, kReduceThreads, 0, s>>>(w, slices, m, n, sc, sh, out);
  return (int)cudaGetLastError();
}

// co [M, N] = a @ b, and partial [ceil(M / 128), N] holding each 128-row
// tile's column sums of co. Returns cudaGetLastError() after the launch.
extern "C" int ptt_conv_mm_stats(const void* a, const void* b, void* co, void* partial,
                                 int64_t m, int k, int n, void* stream) {
  const int slabs = (k + kBK - 1) / kBK;
  return launch<kStats>(a, b, m, k, n, 1, slabs, nullptr, nullptr, co, partial, stream);
}

// Rows of one partial-sum tile, for the wrapper's allocation.
extern "C" int ptt_conv_mm_tile_rows() { return kBM; }
