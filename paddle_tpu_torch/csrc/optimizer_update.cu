// Fused momentum + L2 weight-decay update, in place, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/optimizer_update.py _kernel /
// _pallas_update:
//     g' = grad + wd * param          (only when wd != 0)
//     v' = mu * velocity + g'
//     p' = param - lr * v'            (plain)
//        | param - lr * (g' + mu * v') (Nesterov)
// written back over param and velocity.
//
// Bound on the H100: device memory. Five float32 streams (param, grad,
// velocity read; param, velocity written) for at most 7 flops an element.
//
// Design: one pass, 16 bytes a thread per stream when all three pointers
// are 16-byte aligned, a grid-stride loop, any length (the TPU kernel's
// size >= 128 rule was its tiling's, so every parameter launches here).
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn), never contracted into an FMA, so the result equals the plain
// version's expression order bit for bit. lr is passed by value.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool WD, bool NESTEROV>
__device__ __forceinline__ void update(float& p, float g, float& v, float lr, float mu, float wd) {
  if (WD) g = __fadd_rn(g, __fmul_rn(wd, p));
  v = __fadd_rn(__fmul_rn(mu, v), g);
  p = NESTEROV ? __fsub_rn(p, __fmul_rn(lr, __fadd_rn(g, __fmul_rn(mu, v))))
               : __fsub_rn(p, __fmul_rn(lr, v));
}

template <bool WD, bool NESTEROV, bool VEC>
__global__ void __launch_bounds__(kThreads)
    momentum_kernel(float* __restrict__ param, const float* __restrict__ grad,
                    float* __restrict__ velocity, int64_t n, float lr, float mu, float wd) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (VEC) {
    for (int64_t q = t; q < n / 4; q += stride) {
      float4 p = reinterpret_cast<float4*>(param)[q];
      const float4 g = reinterpret_cast<const float4*>(grad)[q];
      float4 v = reinterpret_cast<float4*>(velocity)[q];
      update<WD, NESTEROV>(p.x, g.x, v.x, lr, mu, wd);
      update<WD, NESTEROV>(p.y, g.y, v.y, lr, mu, wd);
      update<WD, NESTEROV>(p.z, g.z, v.z, lr, mu, wd);
      update<WD, NESTEROV>(p.w, g.w, v.w, lr, mu, wd);
      reinterpret_cast<float4*>(param)[q] = p;
      reinterpret_cast<float4*>(velocity)[q] = v;
    }
    done = n / 4 * 4;
  }
  for (int64_t i = done + t; i < n; i += stride) {
    float p = param[i], v = velocity[i];
    update<WD, NESTEROV>(p, grad[i], v, lr, mu, wd);
    param[i] = p;
    velocity[i] = v;
  }
}

template <bool WD, bool NESTEROV>
void launch(float* p, const float* g, float* v, int64_t n, float lr, float mu, float wd, bool vec,
            cudaStream_t stream) {
  const int64_t work = vec ? n / 4 + 3 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // the rest by the grid-stride loop
  if (vec)
    momentum_kernel<WD, NESTEROV, true><<<(unsigned)blocks, kThreads, 0, stream>>>(p, g, v, n, lr,
                                                                                   mu, wd);
  else
    momentum_kernel<WD, NESTEROV, false><<<(unsigned)blocks, kThreads, 0, stream>>>(p, g, v, n, lr,
                                                                                    mu, wd);
}

}  // namespace

// In place on param and velocity (n float32 each). Returns
// cudaGetLastError() after the launch.
extern "C" int ptt_momentum_update(void* param, const void* grad, void* velocity, int64_t n,
                                   float lr, float mu, float wd, int nesterov, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  auto* p = static_cast<float*>(param);
  auto* g = static_cast<const float*>(grad);
  auto* v = static_cast<float*>(velocity);
  const bool vec = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wd_on = wd != 0.f;
  if (wd_on && nesterov) launch<true, true>(p, g, v, n, lr, mu, wd, vec, s);
  else if (wd_on) launch<true, false>(p, g, v, n, lr, mu, wd, vec, s);
  else if (nesterov) launch<false, true>(p, g, v, n, lr, mu, wd, vec, s);
  else launch<false, false>(p, g, v, n, lr, mu, wd, vec, s);
  return (int)cudaGetLastError();
}
