// Fused momentum + L2 weight-decay update, in place, over many tensors in
// one launch, for Hopper (sm_90a).
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
// ResNet-50's 161 parameters (25.56 M elements) move 511 MB: 0.153 ms at
// 3.35 TB/s.
//
// Design: one launch updates up to kMaxTensors tensors, as PyTorch's
// multi_tensor_apply does. The tensors' param/grad/velocity pointers, their
// sizes and the prefix sums of their block counts travel by value in the
// kernel's argument struct (TensorTable), within the classic 4 KB limit of
// kernel parameters: 110 tensors a launch, so ResNet-50's 161 take two. It
// is a __grid_constant__ parameter, so the run-time index reads it in place
// from the constant bank and can never make the compiler copy it to each
// thread's local memory. The 32 KB parameters of CUDA 12.1 are not used, so
// the source does not depend on the driver that runs it. No table goes to device memory and nothing is
// copied to the device: the gradients are new tensors every step, so the
// wrapper rebuilds the table from Python each step as one ctypes array and
// this entry unpacks it into the struct. Each block owns kChunk elements of
// one tensor and finds that tensor by a binary search over the prefix sums;
// it walks its chunk 16 bytes a thread a stream where the tensor's three
// pointers are 16-byte aligned (kChunk is a multiple of 4, so every chunk
// starts aligned then), and a scalar tail or a scalar walk elsewhere.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn), never contracted into an FMA, so the result equals the plain
// version's expression order bit for bit. lr is read from device memory
// (one float32 the caller writes before the launch, the train step's lr
// tensor), so a launch captured in a CUDA graph takes each replay's lr; mu
// and wd are constants of the optimizer and go by value.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;       // elements a block: 8 float4 a thread a stream
constexpr int kMaxTensors = 110;   // the table below fits the 4 KB of kernel parameters

struct TensorTable {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* v[kMaxTensors];
  int64_t n[kMaxTensors];
  int32_t block_start[kMaxTensors + 1];  // prefix sums of ceil(n / kChunk)
};
// the table, the count, the lr pointer and the two scalars together
static_assert(sizeof(TensorTable) + 2 * sizeof(float) + 2 * sizeof(void*) <= 4096,
              "kernel parameters exceed 4 KB");

template <bool WD, bool NESTEROV>
__device__ __forceinline__ void update(float& p, float g, float& v, float lr, float mu, float wd) {
  if (WD) g = __fadd_rn(g, __fmul_rn(wd, p));
  v = __fadd_rn(__fmul_rn(mu, v), g);
  p = NESTEROV ? __fsub_rn(p, __fmul_rn(lr, __fadd_rn(g, __fmul_rn(mu, v))))
               : __fsub_rn(p, __fmul_rn(lr, v));
}

template <bool WD, bool NESTEROV>
__global__ void __launch_bounds__(kThreads)
    momentum_kernel(const __grid_constant__ TensorTable t, int count,
                    const float* __restrict__ lr_ptr, float mu, float wd) {
  const float lr = *lr_ptr;
  // the last tensor whose first block is at or before this one
  const int blk = (int)blockIdx.x;
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.block_start[mid] <= blk) lo = mid;
    else hi = mid - 1;
  }
  float* __restrict__ param = t.p[lo];
  const float* __restrict__ grad = t.g[lo];
  float* __restrict__ velocity = t.v[lo];
  const int64_t n = t.n[lo];
  const int64_t begin = (int64_t)(blk - t.block_start[lo]) * kChunk;
  const int64_t end = begin + kChunk < n ? begin + kChunk : n;
  int64_t done = begin;
  const bool vec = ((reinterpret_cast<uintptr_t>(param) | reinterpret_cast<uintptr_t>(grad) |
                     reinterpret_cast<uintptr_t>(velocity)) & 15) == 0;
  if (vec) {
    const int64_t q_end = end / 4;  // whole float4s; begin is a multiple of 4
    for (int64_t q = begin / 4 + threadIdx.x; q < q_end; q += kThreads) {
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
    done = q_end * 4;
  }
  for (int64_t i = done + threadIdx.x; i < end; i += kThreads) {
    float p = param[i], v = velocity[i];
    update<WD, NESTEROV>(p, grad[i], v, lr, mu, wd);
    param[i] = p;
    velocity[i] = v;
  }
}

}  // namespace

extern "C" int ptt_momentum_max_tensors() { return kMaxTensors; }
extern "C" int ptt_momentum_chunk() { return kChunk; }

// One launch over `count` (1..kMaxTensors) tensors, in place on every param
// and velocity. `table` is one int64 array on the host of 5 * count + 1
// words: the count param pointers, the count grad pointers, the count
// velocity pointers, the count sizes (each > 0), then the count + 1 prefix
// sums of ceil(size / chunk) starting at 0. `lr` points to one float32 in
// device memory. Returns cudaGetLastError() after the launch.
extern "C" int ptt_momentum_update_multi(const int64_t* table, int count, const float* lr,
                                         float mu, float wd, int nesterov, void* stream) {
  if (count <= 0 || count > kMaxTensors || lr == nullptr) return (int)cudaErrorInvalidValue;
  TensorTable t;
  for (int i = 0; i < count; ++i) {
    t.p[i] = reinterpret_cast<float*>(table[i]);
    t.g[i] = reinterpret_cast<const float*>(table[count + i]);
    t.v[i] = reinterpret_cast<float*>(table[2 * count + i]);
    t.n[i] = table[3 * count + i];
    if (t.n[i] <= 0) return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i <= count; ++i) t.block_start[i] = (int32_t)table[4 * count + i];
  const unsigned blocks = (unsigned)t.block_start[count];
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wd_on = wd != 0.f;
  auto* kernel = wd_on ? (nesterov ? momentum_kernel<true, true> : momentum_kernel<true, false>)
                       : (nesterov ? momentum_kernel<false, true> : momentum_kernel<false, false>);
  kernel<<<blocks, kThreads, 0, s>>>(t, count, lr, mu, wd);
  return (int)cudaGetLastError();
}
