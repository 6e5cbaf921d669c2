// The batch-norm passes of the fused conv + batch_norm + relu, for Hopper (sm_90a).
//
// Replaces four kernels of paddle_tpu/ops/pallas/conv_bn_relu.py, each a
// pass over the conv output co [M, N] (channels last, row-major; N = Cout;
// float32, or bf16 or fp16 under AMP) with float32 per-channel vectors of length N:
//   _centered_sumsq   (training fwd): per-block partials of sum((co - mean)^2)
//   _bn_relu          (training fwd): y = relu(co * scale + shift)
//   _bn_bwd_partials  (training bwd): per-block partials of sum(dy_relu) and
//                     sum(dy_relu * co), the relu gate recomputed from co
//   _bn_bwd_dco       (training bwd): d_co = scale * dy_relu - k3 * co - b0
//
// Bound on the H100: device memory. Each pass reads co (and dy) once and
// writes at most one [M, N] tensor, with a handful of flops an element.
//
// bf16 (the TPU kernels' bf16 forms): co and dy are bf16, every sum, the
// statistics, scale and shift stay float32, and each value is widened to
// float32 as it is read; bn_relu rounds its output to bf16 once and bn_bwd_dco
// writes float32, as _bn_bwd_dco does (conv_bn_relu.py:501). Each kernel is a
// template on the element type; the float32 instances are the kernels as they
// were.
//
// fp16 (O1 float16 autocast; the _f16 entries): the TPU kernels never took
// fp16, and the JAX package's fp16 conv goes through its unfused reference,
// whose batch-norm backward rounds d_co to fp16 (ops/kernels.py
// _bn_train_bwd). So the fp16 instances read and round as the bf16 ones,
// except that bn_bwd_dco writes d_co in fp16, rounded once to nearest even.
// Every fp16 rounding goes to inf past 65504 and is never clamped: a
// loss-scaled gradient that overflows stays non-finite for the scaler.
//
// Design. The two reductions give each block 32 channels (one warp's
// width, so a warp reads 128 contiguous bytes of a row) and a run of rows
// that its 8 warps stride through; the warps' sums meet in shared memory
// in a fixed order and each block writes one row of a [blocks, N]
// partial, which the wrapper adds up with torch.sum. No atomics, so the
// sums repeat bit for bit. In bf16 a lane takes two neighbouring channels
// (a bf16 pair, when N is even) so that a warp still reads 128 bytes of a
// row. The variance stays two-pass and centred: the
// one-pass E[co^2] - mean^2 loses the whole variance of a channel with
// mean 100 and std 0.1 to float32 cancellation. The elementwise passes
// read and write 16 bytes a thread when N is a multiple of 4. Rows are
// not padded: every pass masks its own edges. The elementwise passes' bf16
// loads are 16 bytes too, 8 values, when N is a multiple of 8.
//
// The relu gate: pre = co * scale + shift is rounded as __fmul_rn then
// __fadd_rn in the forward, in both backward passes and (as two torch ops)
// in the plain version, so a pre-activation near 0 takes the same side of
// the gate everywhere and the gradient matches the output it belongs to.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // lanes across the channels of a reduction block
constexpr int kWarps = 8;   // rows in flight a reduction block
constexpr int kThreads = 256;

__device__ __forceinline__ float pre_act(float co, float s, float b) {
  return __fadd_rn(__fmul_rn(co, s), b);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// V neighbouring values from p (V = 2: a 16-bit pair, 4-byte aligned), widened
template <int V>
__device__ __forceinline__ void load_run(const float* p, float (&v)[V]) {
  static_assert(V == 1, "float32 lanes take one channel");
  v[0] = *p;
}
template <int V>
__device__ __forceinline__ void load_run(const __nv_bfloat16* p, float (&v)[V]) {
  if (V == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[V - 1] = f.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int V>
__device__ __forceinline__ void load_run(const __half* p, float (&v)[V]) {
  if (V == 2) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(p));
    v[0] = f.x;
    v[V - 1] = f.y;
  } else {
    v[0] = __half2float(*p);
  }
}

// kind 0: partial[blk, c] = sum over the block's rows of (co - mean[c])^2
// kind 1: partial[blk, c] = sum of dy_relu, partial2[blk, c] = sum of dy_relu * co
// A lane takes V neighbouring channels (n % V == 0).
template <int KIND, typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_reduce_kernel(const T* __restrict__ co, const T* __restrict__ dy, int64_t m, int n,
                     int64_t rows_per_block, const float* __restrict__ v0,
                     const float* __restrict__ v1, float* __restrict__ partial,
                     float* __restrict__ partial2) {
  __shared__ float red[2][kWarps][kCols * V];
  const int lane = threadIdx.x % kCols;
  const int warp = threadIdx.x / kCols;
  const int c = (blockIdx.y * kCols + lane) * V;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  int64_t r1 = r0 + rows_per_block;
  if (r1 > m) r1 = m;
  float s0[V], s1[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s0[e] = s1[e] = 0.f;
  if (c < n) {
    float a[V], b[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      a[e] = v0[c + e];
      b[e] = KIND == 1 ? v1[c + e] : 0.f;
    }
    for (int64_t r = r0 + warp; r < r1; r += kWarps) {
      float x[V];
      load_run<V>(co + r * n + c, x);
      if (KIND == 0) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = x[e] - a[e];
          s0[e] += d * d;
        }
      } else {
        float gy[V];
        load_run<V>(dy + r * n + c, gy);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float g = pre_act(x[e], a[e], b[e]) > 0.f ? gy[e] : 0.f;
          s0[e] += g;
          s1[e] += g * x[e];
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    red[0][warp][lane * V + e] = s0[e];
    red[1][warp][lane * V + e] = s1[e];
  }
  __syncthreads();
  if (warp == 0 && c < n) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float t0 = 0.f, t1 = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        t0 += red[0][w][lane * V + e];
        t1 += red[1][w][lane * V + e];
      }
      partial[(int64_t)blockIdx.x * n + c + e] = t0;
      if (KIND == 1) partial2[(int64_t)blockIdx.x * n + c + e] = t1;
    }
  }
}

// kind 0: y = relu(pre);  kind 1: d_co = scale * (pre > 0 ? dy : 0) - k3 * co - b0
template <int KIND>
__device__ __forceinline__ float elementwise(float x, float g, float s, float b, float k3,
                                             float b0) {
  const float p = pre_act(x, s, b);
  if (KIND == 0) return fmaxf(p, 0.f);
  const float gr = p > 0.f ? g : 0.f;
  return __fsub_rn(__fsub_rn(__fmul_rn(s, gr), __fmul_rn(k3, x)), b0);
}

// E neighbouring values from p, widened: 16 bytes when E * sizeof(T) == 16
template <int E>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[E]) {
  if (E == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1 % E] = f.y, v[2 % E] = f.z, v[3 % E] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = p[e];
  }
}
template <int E>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[E]) {
  if (E == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[(2 * i) % E] = f.x;
      v[(2 * i + 1) % E] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = __bfloat162float(p[e]);
  }
}
template <int E>
__device__ __forceinline__ void load_vec(const __half* p, float (&v)[E]) {
  if (E == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      v[(2 * i) % E] = f.x;
      v[(2 * i + 1) % E] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = __half2float(p[e]);
  }
}

// E values to p: float32 in 16-byte stores (E = 4 or 8), bf16 or fp16
// rounded once to nearest even in one 16-byte store (E = 8)
template <int E>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[E]) {
  if (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 4)
      reinterpret_cast<float4*>(p)[i / 4] =
          make_float4(v[i], v[(i + 1) % E], v[(i + 2) % E], v[(i + 3) % E]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = v[e];
  }
}
template <int E>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[E]) {
  if (E == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[(2 * i) % E], v[(2 * i + 1) % E]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = __float2bfloat16_rn(v[e]);
  }
}
template <int E>
__device__ __forceinline__ void store_vec(__half* p, const float (&v)[E]) {
  if (E == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __floats2half2_rn(v[(2 * i) % E], v[(2 * i + 1) % E]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = __float2half_rn(v[e]);
  }
}

// co and dy of type T, out of type O; VEC: 16 bytes of co a thread
// (n a multiple of 16 / sizeof(T)), else one element
template <int KIND, typename T, typename O, bool VEC>
__global__ void __launch_bounds__(kThreads)
    bn_elementwise_kernel(const T* __restrict__ co, const T* __restrict__ dy, int64_t m, int n,
                          const float* __restrict__ scale, const float* __restrict__ shift,
                          const float* __restrict__ k3, const float* __restrict__ b0,
                          O* __restrict__ out) {
  constexpr int E = VEC ? 16 / (int)sizeof(T) : 1;
  const int64_t total = m * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < total / E; q += stride) {
    const int c = (int)((q * E) % n);  // E neighbours share a row
    float x[E], g[E], y[E];
    load_vec<E>(co + q * E, x);
    if (KIND == 1) load_vec<E>(dy + q * E, g);
#pragma unroll
    for (int e = 0; e < E; ++e)
      y[e] = elementwise<KIND>(x[e], KIND == 1 ? g[e] : 0.f, scale[c + e], shift[c + e],
                               KIND ? k3[c + e] : 0.f, KIND ? b0[c + e] : 0.f);
    store_vec<E>(out + q * E, y);
  }
}

template <int KIND, typename T>
int launch_reduce(const void* co, const void* dy, int64_t m, int n, int64_t rows_per_block,
                  const void* v0, const void* v1, void* partial, void* partial2,
                  cudaStream_t stream) {
  if (m <= 0 || n <= 0 || rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (m + rows_per_block - 1) / rows_per_block;
  // 16-bit lanes take a pair of channels when the pairs stay aligned
  const bool pairs = sizeof(T) == 2 && n % 2 == 0;
  const int per_block = kCols * (pairs ? 2 : 1);
  const int col_tiles = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffff || col_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, col_tiles);
  auto* c = static_cast<const T*>(co);
  auto* g = static_cast<const T*>(dy);
  auto* a = static_cast<const float*>(v0);
  auto* b = static_cast<const float*>(v1);
  auto* p = static_cast<float*>(partial);
  auto* p2 = static_cast<float*>(partial2);
  if constexpr (sizeof(T) == 2) {
    if (pairs) {
      bn_reduce_kernel<KIND, T, 2><<<grid, kThreads, 0, stream>>>(c, g, m, n, rows_per_block, a,
                                                                  b, p, p2);
      return (int)cudaGetLastError();
    }
  }
  bn_reduce_kernel<KIND, T, 1><<<grid, kThreads, 0, stream>>>(c, g, m, n, rows_per_block, a, b,
                                                              p, p2);
  return (int)cudaGetLastError();
}

template <int KIND, typename T, typename O>
int launch_elementwise(const void* co, const void* dy, int64_t m, int n, const void* scale,
                       const void* shift, const void* k3, const void* b0, void* out,
                       cudaStream_t stream) {
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = n % (16 / (int)sizeof(T)) == 0;
  const int64_t work = vec ? m * n / (16 / (int)sizeof(T)) : m * n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // the rest by the grid-stride loop
  auto* c = static_cast<const T*>(co);
  auto* g = static_cast<const T*>(dy);
  auto* s = static_cast<const float*>(scale);
  auto* b = static_cast<const float*>(shift);
  auto* k = static_cast<const float*>(k3);
  auto* z = static_cast<const float*>(b0);
  auto* o = static_cast<O*>(out);
  if (vec)
    bn_elementwise_kernel<KIND, T, O, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        c, g, m, n, s, b, k, z, o);
  else
    bn_elementwise_kernel<KIND, T, O, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        c, g, m, n, s, b, k, z, o);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch. The partials have
// ceil(m / rows_per_block) rows of n. The _bf16 entries take bf16 co and dy
// (bn_relu's y in bf16, bn_bwd_dco's d_co in float32); the _f16 entries fp16
// co and dy (y and d_co in fp16).
extern "C" int ptt_bn_centered_sumsq(const void* co, int64_t m, int n, int64_t rows_per_block,
                                     const void* mean, void* partial, void* stream) {
  return launch_reduce<0, float>(co, nullptr, m, n, rows_per_block, mean, nullptr, partial,
                                 nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_bwd_partials(const void* co, const void* dy, int64_t m, int n,
                                   int64_t rows_per_block, const void* scale, const void* shift,
                                   void* partial_dy, void* partial_dyco, void* stream) {
  return launch_reduce<1, float>(co, dy, m, n, rows_per_block, scale, shift, partial_dy,
                                 partial_dyco, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_relu(const void* co, int64_t m, int n, const void* scale, const void* shift,
                           void* y, void* stream) {
  return launch_elementwise<0, float, float>(co, nullptr, m, n, scale, shift, nullptr, nullptr,
                                             y, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_bwd_dco(const void* co, const void* dy, int64_t m, int n, const void* scale,
                              const void* shift, const void* k3, const void* b0, void* dco,
                              void* stream) {
  return launch_elementwise<1, float, float>(co, dy, m, n, scale, shift, k3, b0, dco,
                                             static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_centered_sumsq_bf16(const void* co, int64_t m, int n,
                                          int64_t rows_per_block, const void* mean,
                                          void* partial, void* stream) {
  return launch_reduce<0, __nv_bfloat16>(co, nullptr, m, n, rows_per_block, mean, nullptr,
                                         partial, nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_bwd_partials_bf16(const void* co, const void* dy, int64_t m, int n,
                                        int64_t rows_per_block, const void* scale,
                                        const void* shift, void* partial_dy, void* partial_dyco,
                                        void* stream) {
  return launch_reduce<1, __nv_bfloat16>(co, dy, m, n, rows_per_block, scale, shift, partial_dy,
                                         partial_dyco, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_relu_bf16(const void* co, int64_t m, int n, const void* scale,
                                const void* shift, void* y, void* stream) {
  return launch_elementwise<0, __nv_bfloat16, __nv_bfloat16>(
      co, nullptr, m, n, scale, shift, nullptr, nullptr, y, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_bwd_dco_bf16(const void* co, const void* dy, int64_t m, int n,
                                   const void* scale, const void* shift, const void* k3,
                                   const void* b0, void* dco, void* stream) {
  return launch_elementwise<1, __nv_bfloat16, float>(co, dy, m, n, scale, shift, k3, b0, dco,
                                                     static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_centered_sumsq_f16(const void* co, int64_t m, int n,
                                         int64_t rows_per_block, const void* mean,
                                         void* partial, void* stream) {
  return launch_reduce<0, __half>(co, nullptr, m, n, rows_per_block, mean, nullptr, partial,
                                  nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_bwd_partials_f16(const void* co, const void* dy, int64_t m, int n,
                                       int64_t rows_per_block, const void* scale,
                                       const void* shift, void* partial_dy, void* partial_dyco,
                                       void* stream) {
  return launch_reduce<1, __half>(co, dy, m, n, rows_per_block, scale, shift, partial_dy,
                                  partial_dyco, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_relu_f16(const void* co, int64_t m, int n, const void* scale,
                               const void* shift, void* y, void* stream) {
  return launch_elementwise<0, __half, __half>(co, nullptr, m, n, scale, shift, nullptr, nullptr,
                                               y, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_bwd_dco_f16(const void* co, const void* dy, int64_t m, int n,
                                  const void* scale, const void* shift, const void* k3,
                                  const void* b0, void* dco, void* stream) {
  return launch_elementwise<1, __half, __half>(co, dy, m, n, scale, shift, k3, b0, dco,
                                               static_cast<cudaStream_t>(stream));
}
