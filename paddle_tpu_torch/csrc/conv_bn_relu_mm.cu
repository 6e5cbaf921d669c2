// Conv-as-matmul with a fused batch-norm epilogue, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/conv_bn_relu.py _mm_affine_relu (eval:
// y = relu((p2 @ w2) * scale + shift), the pre-activation never stored)
// and _mm_stats (training: co = p2 @ w2 plus per-tile channel sums of co).
// p2 [M, K] are the conv's patches (or its channels-last input for a 1x1
// stride-1 conv), w2 [K, N] its weight, N = Cout; all float32, row-major.
//
// Bound on the H100: operations. On ResNet-50 a 3x3 conv does 2*K flops
// per output for 4*(K + 1) bytes of patches read once (K = 576: ~0.5
// flop/byte of p2 per column tile, but 64-512 output columns share each
// patch row), so the FP32 units, not the memory, set the pace.
//
// Design: one block of 256 threads per 128 x 64 output tile. A 128 x 16
// slab of p2 (stored transposed) and a 16 x 64 slab of w2 sit in shared
// memory; each thread owns an 8 x 4 register block of outputs and runs the
// K loop as FP32 FMAs. The next slabs are fetched into registers while the
// current ones are multiplied. Loads are scalar and masked, so any M, K
// and N work: the stem's K = 3*7*7 = 147 leaves p2's rows unaligned for
// vector loads. The epilogue is a template parameter:
//   kAffineRelu: y = relu(acc * scale + shift), rounded as __fmul_rn then
//                __fadd_rn, the way the plain version and the training
//                kernels round the same pre-activation;
//   kStats:      store co = acc, and one [tiles, N] row of channel sums per
//                block (rows >= M masked), which the wrapper adds up with
//                torch.sum. No atomics, so the sums repeat bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output rows a block
constexpr int kBN = 64;       // output columns a block
constexpr int kBK = 16;       // depth of one shared-memory slab
constexpr int kThreads = 256;
constexpr int kTM = 8;        // output rows a thread
constexpr int kTN = 4;        // output columns a thread
constexpr int kPadA = 4;      // keeps float4 reads aligned, stores at 2-way conflicts
constexpr int kALoads = kBM * kBK / kThreads;  // 8 p2 values a thread a slab
constexpr int kBLoads = kBK * kBN / kThreads;  // 4 w2 values a thread a slab

enum Epilogue { kAffineRelu = 0, kStats = 1 };

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    conv_mm_kernel(const float* __restrict__ a, const float* __restrict__ b, int64_t m, int k,
                   int n, const float* __restrict__ scale, const float* __restrict__ shift,
                   float* __restrict__ out, float* __restrict__ partial) {
  __shared__ __align__(16) float as[kBK][kBM + kPadA];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // columns tx*4 .. tx*4+3 of the tile
  const int ty = tid / (kBN / kTN);  // rows ty*8 .. ty*8+7 of the tile
  const int64_t row0 = (int64_t)blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  // slab loads: 16 neighbouring threads read 16 neighbouring k of one p2 row,
  // 64 neighbouring threads one w2 row
  const int a_k = tid % kBK;
  const int a_r = tid / kBK;
  const int b_n = tid % kBN;
  const int b_k = tid / kBN;
  float a_reg[kALoads], b_reg[kBLoads];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int64_t gr = row0 + a_r + (kThreads / kBK) * i;
      const int gk = k0 + a_k;
      a_reg[i] = (gr < m && gk < k) ? a[gr * k + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int gk = k0 + b_k + (kThreads / kBN) * i;
      const int gc = col0 + b_n;
      b_reg[i] = (gk < k && gc < n) ? b[(int64_t)gk * n + gc] : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) as[a_k][a_r + (kThreads / kBK) * i] = a_reg[i];
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) bs[b_k + (kThreads / kBN) * i][b_n] = b_reg[i];
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < k; k0 += kBK) {
    stash();
    __syncthreads();
    if (k0 + kBK < k) fetch(k0 + kBK);  // in flight while this slab is multiplied
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * kTM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * kTN]);
      const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int c = col0 + tx * kTN;
  float sc[kTN], sh[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    sc[j] = (EPI == kAffineRelu && c + j < n) ? scale[c + j] : 0.f;
    sh[j] = (EPI == kAffineRelu && c + j < n) ? shift[c + j] : 0.f;
  }
  float colsum[kTN] = {0.f, 0.f, 0.f, 0.f};
  const bool vec = (n % 4 == 0) && (c + kTN <= n);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t r = row0 + ty * kTM + i;
    if (r >= m) continue;
    float v[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      if (EPI == kAffineRelu) {
        v[j] = fmaxf(__fadd_rn(__fmul_rn(acc[i][j], sc[j]), sh[j]), 0.f);
      } else {
        v[j] = acc[i][j];
        colsum[j] += acc[i][j];
      }
    }
    float* dst = out + r * n + c;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (c + j < n) dst[j] = v[j];
    }
  }

  if (EPI == kStats) {
    // the 16 row groups of a column meet in shared memory (the p2 slab's
    // space, free after the last __syncthreads) and are added in order
    float* red = &as[0][0];
#pragma unroll
    for (int j = 0; j < kTN; ++j) red[ty * kBN + tx * kTN + j] = colsum[j];
    __syncthreads();
    if (tid < kBN && col0 + tid < n) {
      float s = 0.f;
      for (int t = 0; t < kThreads / (kBN / kTN); ++t) s += red[t * kBN + tid];
      partial[(int64_t)blockIdx.x * n + col0 + tid] = s;
    }
  }
}

dim3 grid_of(int64_t m, int n) {
  return dim3((unsigned)((m + kBM - 1) / kBM), (unsigned)((n + kBN - 1) / kBN));
}

}  // namespace

// y [M, N] = relu((a [M, K] @ b [K, N]) * scale [N] + shift [N]).
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_conv_mm_affine_relu(const void* a, const void* b, const void* scale,
                                       const void* shift, void* y, int64_t m, int k, int n,
                                       void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (n + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidValue;
  conv_mm_kernel<kAffineRelu><<<grid_of(m, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), m, k, n,
      static_cast<const float*>(scale), static_cast<const float*>(shift), static_cast<float*>(y),
      nullptr);
  return (int)cudaGetLastError();
}

// co [M, N] = a @ b, and partial [ceil(M / 128), N] holding each 128-row
// tile's column sums of co. Returns cudaGetLastError() after the launch.
extern "C" int ptt_conv_mm_stats(const void* a, const void* b, void* co, void* partial,
                                 int64_t m, int k, int n, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (n + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidValue;
  conv_mm_kernel<kStats><<<grid_of(m, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), m, k, n, nullptr, nullptr,
      static_cast<float*>(co), static_cast<float*>(partial));
  return (int)cudaGetLastError();
}

// Rows of one partial-sum tile, for the wrapper's allocation.
extern "C" int ptt_conv_mm_tile_rows() { return kBM; }
