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
// Two variants of one kernel; the entry takes the first that fits H, and
// the wrapper (ops/cuda/layernorm_residual.py _bwd_plan) mirrors the rule
// to size the grid.
//
// Three instances of each variant: f32, bf16 and fp16 (da in the input type,
// rounded to nearest even once; in fp16 past 65504 to inf, so an overflowing
// loss-scaled gradient stays non-finite; the dw/db partials f32 in all).
//
// Row variant (H a multiple of 128 in f32 or 256 in bf16 and fp16, up to kRowMaxH):
// one warp a row. Each lane holds H/32 columns, read and written 16 bytes
// at a time (neighbouring lanes on neighbouring 16 bytes), and the two row
// means are warp-shuffle sums, so the row loop has no block barrier. Each
// warp keeps two rows in flight: the next row's x, res, dy, mean and rstd
// are loaded before the current row is reduced. A block is kRowWarps warps
// over a run of `rows_per_block` consecutive rows (warp i takes rows i,
// i + kRowWarps, ...); the grid is fixed by the wrapper at a few blocks an
// SM. Each lane keeps the dw/db partials of its columns across its rows in
// its warp's slots of shared memory (registers hold the two rows in
// flight); at the end the block adds its warps' partials, warp 0 to the
// last, and writes one [H] pair.
//
// Block variant (any other H up to 16384): one block per run of
// `rows_per_block` consecutive rows, the row's H values spread over the
// block's threads (up to kMaxPerThread a thread, as in the forward), the
// two row means from one block-wide reduction of a float2, and each
// thread's dw/db partials in registers across the block's rows.
//
// Neither uses atomics: every sum is taken in one fixed order, so the
// gradients repeat bit for bit from run to run.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPerThread = 16;  // block variant: values a thread
constexpr int kRowWarps = 8;       // row variant: warps a block, one row each at a time
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kRowMaxH = 1024;     // row variant: widest row, 32 f32 values a lane

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
__device__ __forceinline__ float add_in_dtype(const __half* x, const __half* r, int64_t i) {
  return __half2float(__hadd(x[i], r[i]));
}
__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load(const __half* p, int64_t i) { return __half2float(p[i]); }
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, int64_t i, float v) { p[i] = __float2half_rn(v); }

// -- block variant ----------------------------------------------------------------

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

// -- row variant ------------------------------------------------------------------

// 16 bytes of a row as f32 values: kN of T
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  // x + res in f32
  static __device__ __forceinline__ void add(uint4 x, uint4 r, float* a) {
    a[0] = __uint_as_float(x.x) + __uint_as_float(r.x);
    a[1] = __uint_as_float(x.y) + __uint_as_float(r.y);
    a[2] = __uint_as_float(x.z) + __uint_as_float(r.z);
    a[3] = __uint_as_float(x.w) + __uint_as_float(r.w);
  }
  static __device__ __forceinline__ void widen(uint4 v, float* a) {
    a[0] = __uint_as_float(v.x);
    a[1] = __uint_as_float(v.y);
    a[2] = __uint_as_float(v.z);
    a[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 narrow(const float* a) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
                      __float_as_uint(a[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ __nv_bfloat162 pair(uint32_t u) {
    return *reinterpret_cast<__nv_bfloat162*>(&u);
  }
  // x + res rounded to bf16 (as the block variant's __hadd), widened
  static __device__ __forceinline__ void add(uint4 x, uint4 r, float* a) {
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, rs[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(__hadd2(pair(xs[i]), pair(rs[i])));
      a[2 * i] = f.x;
      a[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void widen(uint4 v, float* a) {
    const uint32_t vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pair(vs[i]));
      a[2 * i] = f.x;
      a[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 narrow(const float* a) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

template <>
struct Vec16<__half> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ __half2 pair(uint32_t u) {
    return *reinterpret_cast<__half2*>(&u);
  }
  // x + res rounded to fp16 (as the block variant's __hadd), widened
  static __device__ __forceinline__ void add(uint4 x, uint4 r, float* a) {
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, rs[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(__hadd2(pair(xs[i]), pair(rs[i])));
      a[2 * i] = f.x;
      a[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void widen(uint4 v, float* a) {
    const uint32_t vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(pair(vs[i]));
      a[2 * i] = f.x;
      a[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 narrow(const float* a) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __floats2half2_rn(a[2 * i], a[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

template <typename T, int NV>
__global__ void __launch_bounds__(kRowThreads) layernorm_residual_bwd_row_kernel(
    const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ w,
    const float* __restrict__ mean, const float* __restrict__ rstd, const T* __restrict__ dy,
    T* __restrict__ da, float* __restrict__ dwp, float* __restrict__ dbp, int64_t rows,
    int rows_per_block) {
  using V = Vec16<T>;
  constexpr int VPC = V::kN;    // values in 16 bytes
  constexpr int C = NV * VPC;   // values a lane
  constexpr int H = 32 * C;
  // dynamic shared memory: w, then each warp's dw and db partials ([H] each)
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* pdw = ws + H + warp * 2 * H;  // this warp's partials, each lane its own columns
  float* pdb = pdw + H;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(rows, r0 + rows_per_block);
  const float inv_h = 1.0f / (float)H;
  for (int i = threadIdx.x; i < H / 4; i += kRowThreads)
    smem4[i] = reinterpret_cast<const float4*>(w)[i];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < VPC; i += 4) {
      const int col = (32 * j + lane) * VPC + i;  // lane's chunk j starts here
      *reinterpret_cast<float4*>(pdw + col) = zero;
      *reinterpret_cast<float4*>(pdb + col) = zero;
    }

  uint4 xn[NV], rn[NV], dn[NV];  // the next row, in flight
  float mu_n = 0.f, rs_n = 0.f;
  auto fetch = [&](int64_t row) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * H) + lane;
    const uint4* rr = reinterpret_cast<const uint4*>(res + row * H) + lane;
    const uint4* dr = reinterpret_cast<const uint4*>(dy + row * H) + lane;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      xn[j] = __ldg(xr + 32 * j);
      rn[j] = __ldg(rr + 32 * j);
      dn[j] = __ldg(dr + 32 * j);
    }
    mu_n = __ldg(mean + row);
    rs_n = __ldg(rstd + row);
  };
  int64_t row = r0 + warp;
  if (row < r1) fetch(row);
  __syncthreads();  // w is staged

  for (; row < r1; row += kRowWarps) {
    float xh[C], g[C];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      V::add(xn[j], rn[j], xh + j * VPC);
      V::widen(dn[j], g + j * VPC);
    }
    const float mu = mu_n, rs = rs_n;
    if (row + kRowWarps < r1) fetch(row + kRowWarps);  // in flight while this row is reduced

    float2 s = make_float2(0.f, 0.f);  // sums of w*dy and w*dy * x^
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int i = 0; i < VPC; i += 4) {
        const int col = (32 * j + lane) * VPC + i;
        const float4 wv = *reinterpret_cast<const float4*>(ws + col);
        const float4 dw4 = *reinterpret_cast<const float4*>(pdw + col);
        const float4 db4 = *reinterpret_cast<const float4*>(pdb + col);
        const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
        float dwa[4] = {dw4.x, dw4.y, dw4.z, dw4.w};
        float dba[4] = {db4.x, db4.y, db4.z, db4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * VPC + i + e;
          const float d = g[c];
          xh[c] = (xh[c] - mu) * rs;
          dwa[e] += d * xh[c];
          dba[e] += d;
          g[c] = d * wa[e];
          s.x += g[c];
          s.y += g[c] * xh[c];
        }
        *reinterpret_cast<float4*>(pdw + col) = make_float4(dwa[0], dwa[1], dwa[2], dwa[3]);
        *reinterpret_cast<float4*>(pdb + col) = make_float4(dba[0], dba[1], dba[2], dba[3]);
      }
    }
    s = warp_sum2(s);
    const float c1 = s.x * inv_h;
    const float c2 = s.y * inv_h;
    uint4* out = reinterpret_cast<uint4*>(da + row * H) + lane;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float o[VPC];
#pragma unroll
      for (int i = 0; i < VPC; ++i) {
        const int c = j * VPC + i;
        o[i] = rs * (g[c] - c1 - xh[c] * c2);
      }
      out[32 * j] = V::narrow(o);
    }
  }

  // the block's partials: thread i adds column i over warps 0..kRowWarps-1
  __syncthreads();
  float* dw_out = dwp + (int64_t)blockIdx.x * H;
  float* db_out = dbp + (int64_t)blockIdx.x * H;
  for (int col = threadIdx.x; col < H; col += kRowThreads) {
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kRowWarps; ++w8) {
      sw += ws[H + w8 * 2 * H + col];
      sb += ws[2 * H + w8 * 2 * H + col];
    }
    dw_out[col] = sw;
    db_out[col] = sb;
  }
}

// dynamic shared memory of the row variant at width h: w and each warp's
// dw and db partials
constexpr size_t row_smem_bytes(int h) {
  return (size_t)(1 + 2 * kRowWarps) * h * sizeof(float);
}

// 16-byte chunks a lane of the row variant holds for a row of h values of
// T, or 0 when the row variant does not take h
template <typename T>
int row_chunks(int h) {
  constexpr int kWarpRow = 32 * Vec16<T>::kN;  // values one 16-byte load of every lane covers
  return h % kWarpRow == 0 && h <= kRowMaxH ? h / kWarpRow : 0;
}

template <typename T, int NV>
int launch_row(const void* x, const void* res, const void* w, const void* mean, const void* rstd,
               const void* dy, void* da, void* dwp, void* dbp, int64_t rows, int rows_per_block,
               cudaStream_t stream) {
  constexpr size_t smem = row_smem_bytes(32 * NV * Vec16<T>::kN);
  auto* kernel = layernorm_residual_bwd_row_kernel<T, NV>;
  // above 48 KB a kernel's dynamic shared memory must be allowed first
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  kernel<<<(unsigned)blocks, kRowThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(da), static_cast<float*>(dwp),
      static_cast<float*>(dbp), rows, rows_per_block);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(int nv, const void* x, const void* res, const void* w, const void* mean,
                const void* rstd, const void* dy, void* da, void* dwp, void* dbp, int64_t rows,
                int rows_per_block, cudaStream_t s) {
#define PTT_ROW_CASE(NV)                                                                     \
  case NV:                                                                                   \
    return launch_row<T, NV>(x, res, w, mean, rstd, dy, da, dwp, dbp, rows, rows_per_block, s);
  if constexpr (Vec16<T>::kN == 4) {  // f32: H = 128 ... 1024
    switch (nv) {
      PTT_ROW_CASE(1)
      PTT_ROW_CASE(2)
      PTT_ROW_CASE(3)
      PTT_ROW_CASE(4)
      PTT_ROW_CASE(5)
      PTT_ROW_CASE(6)
      PTT_ROW_CASE(7)
      PTT_ROW_CASE(8)
    }
  } else {  // bf16 and fp16: H = 256 ... 1024
    switch (nv) {
      PTT_ROW_CASE(1)
      PTT_ROW_CASE(2)
      PTT_ROW_CASE(3)
      PTT_ROW_CASE(4)
    }
  }
#undef PTT_ROW_CASE
  return (int)cudaErrorInvalidValue;
}

// -- launch ------------------------------------------------------------------------

template <typename T>
int launch(const void* x, const void* res, const void* w, const void* mean, const void* rstd,
           const void* dy, void* da, void* dwp, void* dbp, int64_t rows, int h,
           int rows_per_block, cudaStream_t stream) {
  if (rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  const int nv = row_chunks<T>(h);
  if (nv > 0)
    return launch_rows<T>(nv, x, res, w, mean, rstd, dy, da, dwp, dbp, rows, rows_per_block,
                          stream);
  // the block variant, in the forward's block shape: fewest threads (a
  // multiple of 32, at least 128) that keep each thread at or under
  // kMaxPerThread values
  int threads = (h + kMaxPerThread - 1) / kMaxPerThread;
  threads = ((threads + 31) / 32) * 32;
  if (threads < 128) threads = 128;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  layernorm_residual_bwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(da), static_cast<float*>(dwp),
      static_cast<float*>(dbp), rows, h, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// x/res/dy/da [rows, H] in `dtype` (0 = float32, 1 = bfloat16, 2 = float16), w [H] and
// mean/rstd [rows] float32, dwp/dbp [ceil(rows / rows_per_block), H]
// float32; all contiguous, and 16-byte aligned where the row variant takes
// H. Returns cudaGetLastError() after the launch.
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
  if (dtype == 2)
    return launch<__half>(x, res, w, mean, rstd, dy, da, dwp, dbp, rows, h, rows_per_block, s);
  return (int)cudaErrorInvalidValue;
}
