// Fused residual-add + LayerNorm forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/layernorm_residual.py _fwd_kernel /
// _pallas_fwd: y = LayerNorm(x + res) * w + b over the last dim, plus the
// f32 per-row mean and rstd the backward reuses.
//
// Bound on the H100: device memory. Each element is read twice (x, res)
// and written once (y) with ~10 flops in between, far below the ~20
// flop/byte an f32 kernel needs to leave the memory roof.
//
// Design: one block per row. The row lives in registers (up to
// kMaxPerThread values a thread), so x and res are read from device
// memory exactly once and the sum is never stored. Neighbouring threads
// touch neighbouring elements (coalesced). The statistics are two-pass
// over the registers: mean first, then the mean of (a - mean)^2, which
// stays exact for rows with a large mean where E[a^2] - mean^2 cancels.
// The residual add happens in the input dtype (a bf16 sum rounds to bf16)
// before the f32 statistics, as the TPU kernel and the unfused path do.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPerThread = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block; every thread gets the result. `scratch` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? scratch[lane] : 0.f;
  return warp_sum(t);
}

// x + res in the input dtype, widened to f32
__device__ __forceinline__ float add_in_dtype(const float* x, const float* r, int64_t i) {
  return x[i] + r[i];
}
__device__ __forceinline__ float add_in_dtype(const __nv_bfloat16* x, const __nv_bfloat16* r,
                                              int64_t i) {
  return __bfloat162float(__hadd(x[i], r[i]));
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void layernorm_residual_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                                              const float* __restrict__ w,
                                              const float* __restrict__ b, T* __restrict__ y,
                                              float* __restrict__ mean_out,
                                              float* __restrict__ rstd_out, int h, float eps) {
  __shared__ float scratch[32];
  const int64_t row = blockIdx.x;
  const int64_t base = row * (int64_t)h;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  float a[kMaxPerThread];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int c = tid + k * nt;
    a[k] = c < h ? add_in_dtype(x, res, base + c) : 0.f;
    s += a[k];
  }
  const float mean = block_sum(s, scratch) / (float)h;

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int c = tid + k * nt;
    if (c < h) {
      const float d = a[k] - mean;
      ss += d * d;
    }
  }
  const float var = block_sum(ss, scratch) / (float)h;
  const float rstd = 1.0f / sqrtf(var + eps);

#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int c = tid + k * nt;
    if (c < h) store(y, base + c, (a[k] - mean) * rstd * w[c] + b[c]);
  }
  if (tid == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* w, const void* b, void* y, void* mean,
           void* rstd, int64_t rows, int h, float eps, cudaStream_t stream) {
  // fewest threads (a multiple of 32) that keep each thread at or under
  // kMaxPerThread values; the wrapper has already refused h > 16384
  int threads = (h + kMaxPerThread - 1) / kMaxPerThread;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    layernorm_residual_fwd_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<T*>(y), static_cast<float*>(mean),
        static_cast<float*>(rstd), h, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int ptt_layernorm_residual_fwd(const void* x, const void* res, const void* w,
                                          const void* b, void* y, void* mean, void* rstd,
                                          int64_t rows, int h, float eps, int dtype,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, res, w, b, y, mean, rstd, rows, h, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, res, w, b, y, mean, rstd, rows, h, eps, s);
  return (int)cudaErrorInvalidValue;
}
