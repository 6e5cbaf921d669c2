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
// Three instances of one template: f32 (x, res, y f32), bf16 (all bf16;
// the add rounds to bf16 before the f32 statistics, as the TPU kernel and
// the unfused path do) and mixed (a bf16 x on an f32 residual, the first
// encoder layer's case under AMP: bf16 x widened and added to the f32
// residual in f32, f32 statistics, y rounded to bf16 once, as the JAX
// package's _reference promotes the sum and returns x's dtype).
//
// Two variants; the entry takes the first that fits H, and the wrapper
// (ops/cuda/layernorm_residual.py _fwd_plan) mirrors the rule.
//
// Row variant (H a multiple of 32 lanes x 16 bytes of x, up to kRowMaxH):
// one warp a row. A lane holds H/32 values in registers, read by 16-byte
// loads (neighbouring lanes on neighbouring 16 bytes; the mixed residual
// takes two 16-byte loads for x's one) and written the same way. The mean
// (taken about the row's first value, so a row far from 0 sums small exact
// differences), then the mean of (a - mean)^2, are warp-shuffle sums over
// the registers: two-pass, so rows with a large mean keep their variance,
// and no barrier.
// A block is kRowWarps warps; each warp walks rows blockIdx.x * kRowWarps
// + warp, then a grid's worth of warps further on, with the next row's
// loads in flight while the current one is reduced, and keeps its lanes'
// w and b in registers across its rows. The grid is what the card holds
// at once (the occupancy the compiler's registers allow) and no more.
//
// Block variant (any other H up to 16384): one block a row, the row's
// values spread over the block's threads (up to kMaxPerThread a thread),
// the two sums block-wide.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPerThread = 16;  // block variant: values a thread
constexpr int kRowWarps = 8;       // row variant: warps a block, one row each at a time
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kRowMaxH = 1024;     // row variant: widest row

typedef __nv_bfloat16 bf16;

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

// x + res as the instance adds it, widened to f32
__device__ __forceinline__ float add(const float* x, const float* r, int64_t i) {
  return x[i] + r[i];
}
__device__ __forceinline__ float add(const bf16* x, const bf16* r, int64_t i) {
  return __bfloat162float(__hadd(x[i], r[i]));
}
__device__ __forceinline__ float add(const bf16* x, const float* r, int64_t i) {
  return __bfloat162float(x[i]) + r[i];
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(bf16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// -- block variant ----------------------------------------------------------------

template <typename TX, typename TR>
__global__ void layernorm_residual_fwd_kernel(const TX* __restrict__ x, const TR* __restrict__ res,
                                              const float* __restrict__ w,
                                              const float* __restrict__ b, TX* __restrict__ y,
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
    a[k] = c < h ? add(x, res, base + c) : 0.f;
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

// -- row variant ------------------------------------------------------------------

// A lane's chunk of a row: 16 bytes of x, kN values, with the residual's
// kN values (16 bytes, or 32 for an f32 residual under a bf16 x)
template <typename TX, typename TR>
struct Chunk;

template <>
struct Chunk<float, float> {
  static constexpr int kN = 4, kRes = 1;  // values; 16-byte loads of the residual
  static __device__ __forceinline__ void add(uint4 x, const uint4 (&r)[kRes], float* a) {
    a[0] = __uint_as_float(x.x) + __uint_as_float(r[0].x);
    a[1] = __uint_as_float(x.y) + __uint_as_float(r[0].y);
    a[2] = __uint_as_float(x.z) + __uint_as_float(r[0].z);
    a[3] = __uint_as_float(x.w) + __uint_as_float(r[0].w);
  }
  static __device__ __forceinline__ uint4 narrow(const float* a) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
                      __float_as_uint(a[3]));
  }
};

__device__ __forceinline__ __nv_bfloat162 bf16_pair(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__device__ __forceinline__ uint4 narrow_bf16(const float* a) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

template <>
struct Chunk<bf16, bf16> {
  static constexpr int kN = 8, kRes = 1;
  // x + res rounded to bf16 (as the block variant's __hadd), widened
  static __device__ __forceinline__ void add(uint4 x, const uint4 (&r)[kRes], float* a) {
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, rs[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(__hadd2(bf16_pair(xs[i]), bf16_pair(rs[i])));
      a[2 * i] = f.x;
      a[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 narrow(const float* a) { return narrow_bf16(a); }
};

template <>
struct Chunk<bf16, float> {
  static constexpr int kN = 8, kRes = 2;
  // bf16 x widened, plus the f32 residual, in f32
  static __device__ __forceinline__ void add(uint4 x, const uint4 (&r)[kRes], float* a) {
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    const float rs[8] = {__uint_as_float(r[0].x), __uint_as_float(r[0].y),
                         __uint_as_float(r[0].z), __uint_as_float(r[0].w),
                         __uint_as_float(r[1].x), __uint_as_float(r[1].y),
                         __uint_as_float(r[1].z), __uint_as_float(r[1].w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(bf16_pair(xs[i]));
      a[2 * i] = f.x + rs[2 * i];
      a[2 * i + 1] = f.y + rs[2 * i + 1];
    }
  }
  static __device__ __forceinline__ uint4 narrow(const float* a) { return narrow_bf16(a); }
};

// NV chunks a lane: H = 32 * NV * kN
template <typename TX, typename TR, int NV>
__global__ void __launch_bounds__(kRowThreads) layernorm_residual_fwd_row_kernel(
    const TX* __restrict__ x, const TR* __restrict__ res, const float* __restrict__ w,
    const float* __restrict__ b, TX* __restrict__ y, float* __restrict__ mean_out,
    float* __restrict__ rstd_out, int64_t rows, float eps) {
  using V = Chunk<TX, TR>;
  constexpr int VPC = V::kN;   // values a chunk
  constexpr int C = NV * VPC;  // values a lane
  constexpr int H = 32 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t step = (int64_t)gridDim.x * kRowWarps;

  // lane's chunk j covers columns (32 j + lane) * VPC ... + VPC - 1
  float wv[C], bv[C];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < VPC; i += 4) {
      const int col = (32 * j + lane) * VPC + i;
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(w + col));
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(b + col));
      float* wc = wv + j * VPC + i;
      float* bc = bv + j * VPC + i;
      wc[0] = w4.x;
      wc[1] = w4.y;
      wc[2] = w4.z;
      wc[3] = w4.w;
      bc[0] = b4.x;
      bc[1] = b4.y;
      bc[2] = b4.z;
      bc[3] = b4.w;
    }

  uint4 xn[NV], rn[NV][V::kRes];  // the next row, in flight
  auto fetch = [&](int64_t row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * H) + lane;
    const uint4* rr = reinterpret_cast<const uint4*>(res + row * H) + V::kRes * lane;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      xn[j] = __ldg(xr + 32 * j);
#pragma unroll
      for (int q = 0; q < V::kRes; ++q) rn[j][q] = __ldg(rr + 32 * V::kRes * j + q);
    }
  };
  int64_t row = (int64_t)blockIdx.x * kRowWarps + warp;
  if (row < rows) fetch(row);
  for (; row < rows; row += step) {
    float a[C];
#pragma unroll
    for (int j = 0; j < NV; ++j) V::add(xn[j], rn[j], a + j * VPC);
    if (row + step < rows) fetch(row + step);  // in flight while this row is reduced

    // the mean about the row's first value: rows far from 0 sum their small,
    // exact differences, and the mean rounds once when the pivot is added back
    const float pivot = __shfl_sync(0xffffffffu, a[0], 0);
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) s += a[c] - pivot;
    const float mean = pivot + warp_sum(s) / (float)H;
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float d = a[c] - mean;
      ss += d * d;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(ss) / (float)H + eps);
    uint4* out = reinterpret_cast<uint4*>(y + row * H) + lane;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float o[VPC];
#pragma unroll
      for (int i = 0; i < VPC; ++i) {
        const int c = j * VPC + i;
        o[i] = (a[c] - mean) * rstd * wv[c] + bv[c];
      }
      out[32 * j] = V::narrow(o);
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// 16-byte chunks a lane of the row variant holds for a row of h values, or
// 0 when the row variant does not take h
template <typename TX, typename TR>
int row_chunks(int h) {
  constexpr int kWarpRow = 32 * Chunk<TX, TR>::kN;  // values one load of every lane covers
  return h % kWarpRow == 0 && h <= kRowMaxH ? h / kWarpRow : 0;
}

struct Args {
  const void *x, *res, *w, *b;
  void *y, *mean, *rstd;
  int64_t rows;
  int h;
  float eps;
};

template <typename TX, typename TR, int NV>
int launch_row(const Args& a, cudaStream_t stream) {
  auto* kernel = layernorm_residual_fwd_row_kernel<TX, TR, NV>;
  // the blocks the card holds at once; each warp walks its share of the rows
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaGetLastError();
  const int64_t want = (a.rows + kRowWarps - 1) / kRowWarps;
  const int64_t blocks = want < (int64_t)per_sm * sms ? want : (int64_t)per_sm * sms;
  kernel<<<(unsigned)blocks, kRowThreads, 0, stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TR*>(a.res), static_cast<const float*>(a.w),
      static_cast<const float*>(a.b), static_cast<TX*>(a.y), static_cast<float*>(a.mean),
      static_cast<float*>(a.rstd), a.rows, a.eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TR>
int launch_rows(int nv, const Args& a, cudaStream_t s) {
  if constexpr (Chunk<TX, TR>::kN == 4) {  // f32: H = 128 ... 1024
    switch (nv) {
      case 1: return launch_row<TX, TR, 1>(a, s);
      case 2: return launch_row<TX, TR, 2>(a, s);
      case 3: return launch_row<TX, TR, 3>(a, s);
      case 4: return launch_row<TX, TR, 4>(a, s);
      case 5: return launch_row<TX, TR, 5>(a, s);
      case 6: return launch_row<TX, TR, 6>(a, s);
      case 7: return launch_row<TX, TR, 7>(a, s);
      case 8: return launch_row<TX, TR, 8>(a, s);
    }
  } else {  // bf16 and mixed: H = 256 ... 1024
    switch (nv) {
      case 1: return launch_row<TX, TR, 1>(a, s);
      case 2: return launch_row<TX, TR, 2>(a, s);
      case 3: return launch_row<TX, TR, 3>(a, s);
      case 4: return launch_row<TX, TR, 4>(a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TX, typename TR>
int launch(const Args& a, cudaStream_t stream) {
  if (a.rows <= 0) return (int)cudaGetLastError();
  const int nv = row_chunks<TX, TR>(a.h);
  if (nv > 0) return launch_rows<TX, TR>(nv, a, stream);
  // the block variant: fewest threads (a multiple of 32, at least 128) that
  // keep each thread at or under kMaxPerThread values; the wrapper has
  // already refused h > 16384
  int threads = (a.h + kMaxPerThread - 1) / kMaxPerThread;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  layernorm_residual_fwd_kernel<TX, TR><<<(unsigned)a.rows, threads, 0, stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TR*>(a.res), static_cast<const float*>(a.w),
      static_cast<const float*>(a.b), static_cast<TX*>(a.y), static_cast<float*>(a.mean),
      static_cast<float*>(a.rstd), a.h, a.eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x/y [rows, H] and res [rows, H] in `dtype`: 0 = all float32, 1 = all
// bfloat16, 2 = mixed (x and y bfloat16, res float32); w/b [H] and
// mean/rstd [rows] float32; all contiguous, and 16-byte aligned where the
// row variant takes H. Returns cudaGetLastError() after the launch.
extern "C" int ptt_layernorm_residual_fwd(const void* x, const void* res, const void* w,
                                          const void* b, void* y, void* mean, void* rstd,
                                          int64_t rows, int h, float eps, int dtype,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, res, w, b, y, mean, rstd, rows, h, eps};
  if (dtype == 0) return launch<float, float>(a, s);
  if (dtype == 1) return launch<bf16, bf16>(a, s);
  if (dtype == 2) return launch<bf16, float>(a, s);
  return (int)cudaErrorInvalidValue;
}
