// Fused residual-add + LayerNorm backward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/layernorm_residual.py _bwd_kernel /
// _pallas_bwd: from the saved inputs and the forward's f32 per-row mean
// and rstd it recomputes a = x + res (in the input dtype) and
// x^ = (a - mean) * rstd, then writes
//   da  = rstd * (w*dy - mean(w*dy) - x^ * mean(w*dy * x^))   (= dx = dres)
// and per-block partial sums dw_p = sum(dy * x^), db_p = sum(dy) over the
// block's rows, shape [nblocks, H]. The caller sums the partials, as the
// JAX package sums its per-tile partials outside the kernel.
//
// Bound on the H100: device memory. Each element reads x, res and dy and
// writes da with ~12 flops in between; the partials add 8*nblocks*H bytes.
//
// Design: one block per run of `rows_per_block` consecutive rows, the
// row's H values spread over the block's threads (up to kMaxPerThread a
// thread, as in the forward), so x, res and dy are read once. The two row
// means come from one block-wide reduction of a float2. Each thread keeps
// the dw/db partials of its own columns in registers across the block's
// rows and writes them once at the end: no atomics, so the sums are taken
// in one fixed order and gradients repeat bit for bit from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPerThread = 16;

__device__ __forceinline__ float2 warp_sum2(float2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// Sum over the block; every thread gets the result. `scratch` holds 32 float2.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum2(v);
  __syncthreads();  // scratch may still be read by the previous row
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float2 t = lane < nwarps ? scratch[lane] : make_float2(0.f, 0.f);
  return warp_sum2(t);
}

__device__ __forceinline__ float add_in_dtype(const float* x, const float* r, int64_t i) {
  return x[i] + r[i];
}
__device__ __forceinline__ float add_in_dtype(const __nv_bfloat16* x, const __nv_bfloat16* r,
                                              int64_t i) {
  return __bfloat162float(__hadd(x[i], r[i]));
}
__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void layernorm_residual_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ w,
    const float* __restrict__ mean, const float* __restrict__ rstd, const T* __restrict__ dy,
    T* __restrict__ da, float* __restrict__ dwp, float* __restrict__ dbp, int64_t rows, int h,
    int rows_per_block) {
  __shared__ float2 scratch[32];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(rows, r0 + rows_per_block);
  const float inv_h = 1.0f / (float)h;

  float wv[kMaxPerThread], dw[kMaxPerThread], db[kMaxPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int c = tid + k * nt;
    wv[k] = c < h ? w[c] : 0.f;
    dw[k] = 0.f;
    db[k] = 0.f;
  }

  for (int64_t row = r0; row < r1; ++row) {
    const int64_t base = row * (int64_t)h;
    const float mu = mean[row];
    const float rs = rstd[row];
    float xh[kMaxPerThread], g[kMaxPerThread];
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int c = tid + k * nt;
      xh[k] = 0.f;
      g[k] = 0.f;
      if (c < h) {
        xh[k] = (add_in_dtype(x, res, base + c) - mu) * rs;
        const float d = load(dy, base + c);
        g[k] = d * wv[k];
        s.x += g[k];
        s.y += g[k] * xh[k];
        dw[k] += d * xh[k];
        db[k] += d;
      }
    }
    s = block_sum2(s, scratch);
    const float c1 = s.x * inv_h;
    const float c2 = s.y * inv_h;
#pragma unroll
    for (int k = 0; k < kMaxPerThread; ++k) {
      const int c = tid + k * nt;
      if (c < h) store(da, base + c, rs * (g[k] - c1 - xh[k] * c2));
    }
  }

  float* dw_out = dwp + (int64_t)blockIdx.x * h;
  float* db_out = dbp + (int64_t)blockIdx.x * h;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int c = tid + k * nt;
    if (c < h) {
      dw_out[c] = dw[k];
      db_out[c] = db[k];
    }
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* w, const void* mean, const void* rstd,
           const void* dy, void* da, void* dwp, void* dbp, int64_t rows, int h,
           int rows_per_block, cudaStream_t stream) {
  // the forward's block shape: fewest threads (a multiple of 32, at least
  // 128) that keep each thread at or under kMaxPerThread values
  int threads = (h + kMaxPerThread - 1) / kMaxPerThread;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  if (threads > 1024 || rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0) {
    layernorm_residual_bwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(w),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<const T*>(dy), static_cast<T*>(da), static_cast<float*>(dwp),
        static_cast<float*>(dbp), rows, h, rows_per_block);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x/res/dy/da [rows, H] in `dtype` (0 = float32, 1 = bfloat16), w [H] and
// mean/rstd [rows] float32, dwp/dbp [ceil(rows / rows_per_block), H]
// float32; all contiguous. Returns cudaGetLastError() after the launch.
extern "C" int ptt_layernorm_residual_bwd(const void* x, const void* res, const void* w,
                                          const void* mean, const void* rstd, const void* dy,
                                          void* da, void* dwp, void* dbp, int64_t rows, int h,
                                          int rows_per_block, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, res, w, mean, rstd, dy, da, dwp, dbp, rows, h, rows_per_block, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, res, w, mean, rstd, dy, da, dwp, dbp, rows, h,
                                 rows_per_block, s);
  return (int)cudaErrorInvalidValue;
}
