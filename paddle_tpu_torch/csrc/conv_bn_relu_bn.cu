// The batch-norm passes of the fused conv + batch_norm + relu, for Hopper (sm_90a).
//
// Replaces four kernels of paddle_tpu/ops/pallas/conv_bn_relu.py, each a
// pass over the conv output co [M, N] (channels last, float32, row-major;
// N = Cout) with per-channel vectors of length N:
//   _centered_sumsq   (training fwd): per-block partials of sum((co - mean)^2)
//   _bn_relu          (training fwd): y = relu(co * scale + shift)
//   _bn_bwd_partials  (training bwd): per-block partials of sum(dy_relu) and
//                     sum(dy_relu * co), the relu gate recomputed from co
//   _bn_bwd_dco       (training bwd): d_co = scale * dy_relu - k3 * co - b0
//
// Bound on the H100: device memory. Each pass reads co (and dy) once and
// writes at most one [M, N] tensor, with a handful of flops an element.
//
// Design. The two reductions give each block 32 channels (one warp's
// width, so a warp reads 128 contiguous bytes of a row) and a run of rows
// that its 8 warps stride through; the warps' sums meet in shared memory
// in a fixed order and each block writes one row of a [blocks, N]
// partial, which the wrapper adds up with torch.sum. No atomics, so the
// sums repeat bit for bit. The variance stays two-pass and centred: the
// one-pass E[co^2] - mean^2 loses the whole variance of a channel with
// mean 100 and std 0.1 to float32 cancellation. The elementwise passes
// read and write 16 bytes a thread when N is a multiple of 4. Rows are
// not padded: every pass masks its own edges.
//
// The relu gate: pre = co * scale + shift is rounded as __fmul_rn then
// __fadd_rn in the forward, in both backward passes and (as two torch ops)
// in the plain version, so a pre-activation near 0 takes the same side of
// the gate everywhere and the gradient matches the output it belongs to.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // channels a reduction block
constexpr int kWarps = 8;   // rows in flight a reduction block
constexpr int kThreads = 256;

__device__ __forceinline__ float pre_act(float co, float s, float b) {
  return __fadd_rn(__fmul_rn(co, s), b);
}

// kind 0: partial[blk, c] = sum over the block's rows of (co - mean[c])^2
// kind 1: partial[blk, c] = sum of dy_relu, partial2[blk, c] = sum of dy_relu * co
template <int KIND>
__global__ void __launch_bounds__(kThreads)
    bn_reduce_kernel(const float* __restrict__ co, const float* __restrict__ dy, int64_t m, int n,
                     int64_t rows_per_block, const float* __restrict__ v0,
                     const float* __restrict__ v1, float* __restrict__ partial,
                     float* __restrict__ partial2) {
  __shared__ float red[2][kWarps][kCols];
  const int lane = threadIdx.x % kCols;
  const int warp = threadIdx.x / kCols;
  const int c = blockIdx.y * kCols + lane;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  int64_t r1 = r0 + rows_per_block;
  if (r1 > m) r1 = m;
  float s0 = 0.f, s1 = 0.f;
  if (c < n) {
    const float a = v0[c];
    const float b = KIND == 1 ? v1[c] : 0.f;
    for (int64_t r = r0 + warp; r < r1; r += kWarps) {
      const float x = co[r * n + c];
      if (KIND == 0) {
        const float d = x - a;
        s0 += d * d;
      } else {
        const float g = pre_act(x, a, b) > 0.f ? dy[r * n + c] : 0.f;
        s0 += g;
        s1 += g * x;
      }
    }
  }
  red[0][warp][lane] = s0;
  red[1][warp][lane] = s1;
  __syncthreads();
  if (warp == 0 && c < n) {
    float t0 = 0.f, t1 = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      t0 += red[0][w][lane];
      t1 += red[1][w][lane];
    }
    partial[(int64_t)blockIdx.x * n + c] = t0;
    if (KIND == 1) partial2[(int64_t)blockIdx.x * n + c] = t1;
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

template <int KIND, bool VEC>
__global__ void __launch_bounds__(kThreads)
    bn_elementwise_kernel(const float* __restrict__ co, const float* __restrict__ dy, int64_t m,
                          int n, const float* __restrict__ scale, const float* __restrict__ shift,
                          const float* __restrict__ k3, const float* __restrict__ b0,
                          float* __restrict__ out) {
  const int64_t total = m * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (VEC) {  // n % 4 == 0: four neighbours share a row
    for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < total / 4; q += stride) {
      const int c = (int)((q * 4) % n);
      const float4 x = reinterpret_cast<const float4*>(co)[q];
      const float4 g = KIND == 1 ? reinterpret_cast<const float4*>(dy)[q] : x;
      float4 y;
      y.x = elementwise<KIND>(x.x, g.x, scale[c], shift[c], KIND ? k3[c] : 0.f, KIND ? b0[c] : 0.f);
      y.y = elementwise<KIND>(x.y, g.y, scale[c + 1], shift[c + 1], KIND ? k3[c + 1] : 0.f,
                              KIND ? b0[c + 1] : 0.f);
      y.z = elementwise<KIND>(x.z, g.z, scale[c + 2], shift[c + 2], KIND ? k3[c + 2] : 0.f,
                              KIND ? b0[c + 2] : 0.f);
      y.w = elementwise<KIND>(x.w, g.w, scale[c + 3], shift[c + 3], KIND ? k3[c + 3] : 0.f,
                              KIND ? b0[c + 3] : 0.f);
      reinterpret_cast<float4*>(out)[q] = y;
    }
  } else {
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
      const int c = (int)(i % n);
      out[i] = elementwise<KIND>(co[i], KIND == 1 ? dy[i] : 0.f, scale[c], shift[c],
                                 KIND ? k3[c] : 0.f, KIND ? b0[c] : 0.f);
    }
  }
}

template <int KIND>
int launch_reduce(const void* co, const void* dy, int64_t m, int n, int64_t rows_per_block,
                  const void* v0, const void* v1, void* partial, void* partial2,
                  cudaStream_t stream) {
  if (m <= 0 || n <= 0 || rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (m + rows_per_block - 1) / rows_per_block;
  const int col_tiles = (n + kCols - 1) / kCols;
  if (blocks > 0x7fffffff || col_tiles > 65535) return (int)cudaErrorInvalidValue;
  bn_reduce_kernel<KIND><<<dim3((unsigned)blocks, col_tiles), kThreads, 0, stream>>>(
      static_cast<const float*>(co), static_cast<const float*>(dy), m, n, rows_per_block,
      static_cast<const float*>(v0), static_cast<const float*>(v1), static_cast<float*>(partial),
      static_cast<float*>(partial2));
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_elementwise(const void* co, const void* dy, int64_t m, int n, const void* scale,
                       const void* shift, const void* k3, const void* b0, void* out,
                       cudaStream_t stream) {
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0;
  const int64_t work = vec ? m * n / 4 : m * n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // the rest by the grid-stride loop
  auto* c = static_cast<const float*>(co);
  auto* g = static_cast<const float*>(dy);
  auto* s = static_cast<const float*>(scale);
  auto* b = static_cast<const float*>(shift);
  auto* k = static_cast<const float*>(k3);
  auto* z = static_cast<const float*>(b0);
  auto* o = static_cast<float*>(out);
  if (vec)
    bn_elementwise_kernel<KIND, true><<<(unsigned)blocks, kThreads, 0, stream>>>(c, g, m, n, s, b,
                                                                                 k, z, o);
  else
    bn_elementwise_kernel<KIND, false><<<(unsigned)blocks, kThreads, 0, stream>>>(c, g, m, n, s,
                                                                                  b, k, z, o);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch. The partials have
// ceil(m / rows_per_block) rows of n.
extern "C" int ptt_bn_centered_sumsq(const void* co, int64_t m, int n, int64_t rows_per_block,
                                     const void* mean, void* partial, void* stream) {
  return launch_reduce<0>(co, nullptr, m, n, rows_per_block, mean, nullptr, partial, nullptr,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_bwd_partials(const void* co, const void* dy, int64_t m, int n,
                                   int64_t rows_per_block, const void* scale, const void* shift,
                                   void* partial_dy, void* partial_dyco, void* stream) {
  return launch_reduce<1>(co, dy, m, n, rows_per_block, scale, shift, partial_dy, partial_dyco,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_relu(const void* co, int64_t m, int n, const void* scale, const void* shift,
                           void* y, void* stream) {
  return launch_elementwise<0>(co, nullptr, m, n, scale, shift, nullptr, nullptr, y,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_bn_bwd_dco(const void* co, const void* dy, int64_t m, int n, const void* scale,
                              const void* shift, const void* k3, const void* b0, void* dco,
                              void* stream) {
  return launch_elementwise<1>(co, dy, m, n, scale, shift, k3, b0, dco,
                               static_cast<cudaStream_t>(stream));
}
