// Max-pool2d backward, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/pool_backward.py _pool_bwd_kernel /
// _max_pool2d_backward: dx [N, C, H, W] from x, the pooled y [N, C, OH, OW]
// and dy. A window's gradient goes to its first maximum in row-major tap
// order (first max wins); padded taps never hold it.
//
// Bound on the H100: device memory. x, y and dy are read once and dx is
// written once for a handful of compares an element.
//
// Design: a gather, so overlapping windows need no atomics and the result
// repeats bit for bit. A block of 256 threads owns a 32 x 32 tile of one
// plane of dx and works in two steps. First its threads share out the
// windows that reach into the tile and find each window's first tap that
// equals y in row-major order; the tap's number goes to shared memory. All
// taps are read, not only those up to the hit: a scan that stops makes every
// load wait for the compare before it. Then each thread takes four elements
// (h, w) of one column, walks the at most ceil(kh/sh) * ceil(kw/sw) windows
// that contain each in rising tap order (di, then dj: the order in which the
// plain version adds its taps) and adds dy[oh, ow] where the window's first
// tap is its own. Neighbouring blocks are neighbouring tiles of one plane.
// The usual geometries (3x3/2, 2x2/2, 3x3/1) are compiled with window and
// stride as constants; any other runs the same code on run-time values.
//
// How it came here, at [128, 64, 112, 112] 3x3/2/1 on an H100 at 700 W
// against a bound of 0.31 ms: one thread per element that re-read its
// windows' earlier taps took 2.5-2.9 ms, bound by its instructions (every
// warp walks the longest path of its lanes); finding each window's first tap
// once per block 1.96 ms; reading all taps at once and ordering the blocks
// along memory 1.64 ms; 32 x 32 tiles with four elements a thread 1.19 ms
// (a block is three dependent reads long, y, x, dy, so fewer and larger
// blocks wait less). The TPU kernel's one-hot matmuls, H phase splits and
// -1e38 padding were work-arounds for its compiler and have no counterpart
// here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kRows = 4;  // rows of the tile a thread takes, kTileH / kRows apart
constexpr int kThreads = kTileW * kTileH / kRows;
constexpr unsigned kNoTap = 0xffff;  // no tap equals y (a NaN window)

struct Geometry {
  int h, w, oh, ow, kh, kw, sh, sw, ph, pw;
};

// first window that reaches position lo of the padded axis: ceil((lo - k + 1) / s), at least 0
__device__ __forceinline__ int first_window(int lo, int k, int s) {
  const int a = lo - k + 1;
  return a <= 0 ? 0 : (a + s - 1) / s;
}

// KH, KW, SH, SW: the window and stride at compile time, or 0 to read g's
template <int KH, int KW, int SH, int SW>
__global__ void __launch_bounds__(kThreads)
    max_pool_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                        const float* __restrict__ dy, float* __restrict__ dx, Geometry g) {
  extern __shared__ uint16_t first_tap[];  // [windows down the tile][windows across it]
  const int kh = KH ? KH : g.kh, kw = KW ? KW : g.kw;
  const int sh = SH ? SH : g.sh, sw = SW ? SW : g.sw;
  // neighbouring blocks are neighbouring tiles of one plane, so the card
  // reads and writes memory in order
  const int h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;
  const int64_t plane = blockIdx.z;
  const float* xp = x + plane * g.h * g.w;
  const float* yp = y + plane * g.oh * g.ow;
  const float* dyp = dy + plane * g.oh * g.ow;

  // the windows that reach into this tile
  const int oh_lo = first_window(h0 + g.ph, kh, sh);
  const int ow_lo = first_window(w0 + g.pw, kw, sw);
  const int oh_hi = min(g.oh - 1, (h0 + kTileH - 1 + g.ph) / sh);
  const int ow_hi = min(g.ow - 1, (w0 + kTileW - 1 + g.pw) / sw);
  const int ch = max(oh_hi - oh_lo + 1, 0), cw = max(ow_hi - ow_lo + 1, 0);
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < ch * cw; i += kThreads) {
    const int oh = oh_lo + i / cw, ow = ow_lo + i % cw;
    const float yv = yp[oh * g.ow + ow];
    const int hh0 = oh * sh - g.ph, ww0 = ow * sw - g.pw;
    // every tap is read whether or not an earlier one hit, last to first, so
    // that the loads do not wait for each other's compares and the first
    // hit in row-major order is what remains
    unsigned tap = kNoTap;
#pragma unroll
    for (int di = kh - 1; di >= 0; --di) {
      const int hh = hh0 + di;
#pragma unroll
      for (int dj = kw - 1; dj >= 0; --dj) {
        const int ww = ww0 + dj;
        // padding never holds the maximum
        if (hh >= 0 && hh < g.h && ww >= 0 && ww < g.w && xp[hh * g.w + ww] == yv)
          tap = di * kw + dj;
      }
    }
    first_tap[i] = (uint16_t)tap;
  }
  __syncthreads();

  const int w = w0 + threadIdx.x;
  if (w >= g.w) return;
  const int wq = w + g.pw;  // position in the padded plane
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int h = h0 + threadIdx.y + r * (kTileH / kRows);
    if (h >= g.h) break;
    const int hq = h + g.ph;
    float acc = 0.f;
    for (int di = hq % sh; di < kh && di <= hq; di += sh) {
      const int oh = (hq - di) / sh;
      if (oh >= g.oh) continue;
      for (int dj = wq % sw; dj < kw && dj <= wq; dj += sw) {
        const int ow = (wq - dj) / sw;
        if (ow >= g.ow) continue;
        if (first_tap[(oh - oh_lo) * cw + (ow - ow_lo)] == di * kw + dj)
          acc = __fadd_rn(acc, dyp[oh * g.ow + ow]);
      }
    }
    dx[plane * g.h * g.w + h * g.w + w] = acc;
  }
}

}  // namespace

// dx [planes, H, W] from x [planes, H, W] and y, dy [planes, OH, OW], all
// float32 and contiguous. Returns cudaGetLastError() after the launch.
extern "C" int ptt_max_pool2d_backward(const void* x, const void* y, const void* dy, void* dx,
                                       int64_t planes, int h, int w, int oh, int ow, int kh,
                                       int kw, int sh, int sw, int ph, int pw, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || kh <= 0 || kw <= 0 || sh <= 0 ||
      sw <= 0 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles_h = (h + kTileH - 1) / kTileH, tiles_w = (w + kTileW - 1) / kTileW;
  // one 16-bit tap number for every window that can reach into a tile
  const int64_t windows = (int64_t)((kTileH + kh - 2) / sh + 1) * ((kTileW + kw - 2) / sw + 1);
  if (tiles_h > 65535 || (int64_t)kh * kw >= (int64_t)kNoTap || windows * 2 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const Geometry g{h, w, oh, ow, kh, kw, sh, sw, ph, pw};
  const dim3 block(kTileW, kTileH / kRows);
  const size_t smem = (size_t)windows * 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the grid's z axis takes at most 65535 planes: more go in further launches
  for (int64_t p0 = 0; p0 < planes; p0 += 65535) {
    const int64_t count = planes - p0 < 65535 ? planes - p0 : 65535;
    const dim3 grid((unsigned)tiles_w, (unsigned)tiles_h, (unsigned)count);
    const auto* xp = static_cast<const float*>(x) + p0 * h * w;
    const auto* yp = static_cast<const float*>(y) + p0 * oh * ow;
    const auto* dyp = static_cast<const float*>(dy) + p0 * oh * ow;
    auto* dxp = static_cast<float*>(dx) + p0 * h * w;
    if (kh == 3 && kw == 3 && sh == 2 && sw == 2)
      max_pool_bwd_kernel<3, 3, 2, 2><<<grid, block, smem, s>>>(xp, yp, dyp, dxp, g);
    else if (kh == 2 && kw == 2 && sh == 2 && sw == 2)
      max_pool_bwd_kernel<2, 2, 2, 2><<<grid, block, smem, s>>>(xp, yp, dyp, dxp, g);
    else if (kh == 3 && kw == 3 && sh == 1 && sw == 1)
      max_pool_bwd_kernel<3, 3, 1, 1><<<grid, block, smem, s>>>(xp, yp, dyp, dxp, g);
    else
      max_pool_bwd_kernel<0, 0, 0, 0><<<grid, block, smem, s>>>(xp, yp, dyp, dxp, g);
  }
  return (int)cudaGetLastError();
}
