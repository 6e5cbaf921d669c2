// Max-pool2d backward, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/pool_backward.py _pool_bwd_kernel /
// _max_pool2d_backward: dx from x, the pooled y and dy. A window's gradient
// goes to its first maximum in row-major tap order (first max wins);
// padded taps never hold it.
//
// Bound on the H100: device memory. x, y and dy are read once and dx is
// written once for a handful of compares an element.
//
// float32 or bf16 (the stem's pool under AMP): x, y, dy and dx share one type.
// bf16 taps are compared exactly (widened to float32, which changes no value),
// the taps an element won are added in float32 and the sum is rounded once to
// bf16 at the store, as the TPU kernel computes in float32 and rounds at its
// store (pool_backward.py:131-135, :196). bf16 stages its quads of 4 values
// with 8-byte copies, and copies element by element where float32 copies 4
// bytes (cp.async copies no 2-byte piece).
//
// Two layouts, one rule. x, y, dy (and the dx written) are either NCHW
// (the JAX package's layout) or channels-last, the NCHW view of an NHWC
// buffer: the layout in which the fused conv of ResNet's stem hands its
// output to the pool, and in which its backward wants the gradient back.
//
// Design: a gather, so overlapping windows need no atomics and the result
// repeats bit for bit. A block owns a tile of dx and works in three steps,
// all from shared memory:
//   1. it copies the x the tile's windows read (the tile with its halo)
//      and the y and dy of those windows into shared memory by cp.async,
//      16 bytes a copy, all in flight at once;
//   2. its threads share out the windows and find each window's first tap
//      that equals y (all taps are compared, last to first, so no compare
//      waits for another; the first hit in row-major order is what stays);
//      the tap's number goes to shared memory;
//   3. each thread takes four elements of dx, walks the at most
//      ceil(kh/sh) * ceil(kw/sw) windows that contain each in rising tap
//      order (di, then dj: the order in which the plain version adds its
//      taps), adds dy where the window's first tap is its own, and writes
//      the four with one 16-byte store.
// NCHW: a 32 x 32 tile of four planes, a thread four neighbouring columns
// of a row in each (the index arithmetic is shared by the planes).
// Channels-last: an 8 x 16 tile of pixels and 32 channels, a thread
// four neighbouring channels of a pixel; neighbouring threads take
// neighbouring channels, so every copy and store is contiguous with no
// transpose (C = 64 is 256 bytes a pixel). 16-byte copies need W and OW
// (NCHW), or C (channels-last), to be multiples of 4 and 16-byte aligned
// tensors; otherwise the same code copies 4 bytes at a time and stores
// element by element. The usual geometries (3x3/2, 2x2/2, 3x3/1) are
// compiled with window and stride as constants; any other runs the same
// code on run-time values.
//
// Why shared memory: a block that read x from device memory a 4-byte tap
// at a time per window, and dy by scattered gathers, was three dependent
// reads long and ran at a quarter of the card's memory rate; staging the
// tile once keeps every read 16 bytes and in flight at once. Why two
// layouts: converting the stem's channels-last tensors to NCHW and the
// gradient back moved about 2 GB around the kernel. The TPU kernel's
// one-hot matmuls, H phase splits and -1e38 padding were work-arounds for
// its compiler and have no counterpart here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlaneTH = 32, kPlaneTW = 32;     // NCHW tile: rows, columns of a plane
constexpr int kPlanes = 4;                      // NCHW planes a block
constexpr int kPixTH = 8, kPixTW = 16, kCB = 32;  // channels-last tile: rows, columns, channels
constexpr unsigned kNoTap = 0xffff;             // no tap equals y (a NaN window)
constexpr int kMaxSmem = 227 * 1024;

struct Geometry {
  int n, c, h, w, oh, ow, kh, kw, sh, sw, ph, pw;
};

// windows of stride s and extent k that can reach a run of `tile` positions
__host__ __device__ constexpr int windows_across(int tile, int k, int s) {
  return (tile + k - 2) / s + 1;
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// shared memory of a block, elements of `es` bytes: NCHW kPlanes times x
// [XR][XS], y and dy [WH][YS] elements and the taps [WH * WW]; channels-last
// x [XR * XC][kCB], y and dy [WH * WW][kCB] elements and the taps [WH * WW][kCB]
__host__ __device__ constexpr int smem_bytes(bool channels_last, int kh, int kw, int sh, int sw,
                                             int es) {
  return channels_last
             ? es * kCB *
                       (((windows_across(kPixTH, kh, sh) - 1) * sh + kh) *
                            ((windows_across(kPixTW, kw, sw) - 1) * sw + kw) +
                        2 * windows_across(kPixTH, kh, sh) * windows_across(kPixTW, kw, sw)) +
                   2 * kCB * windows_across(kPixTH, kh, sh) * windows_across(kPixTW, kw, sw)
             : kPlanes * (es * (((windows_across(kPlaneTH, kh, sh) - 1) * sh + kh) *
                                    round4((windows_across(kPlaneTW, kw, sw) - 1) * sw + kw + 3) +
                                2 * windows_across(kPlaneTH, kh, sh) *
                                    round4(windows_across(kPlaneTW, kw, sw) + 3)) +
                          2 * windows_across(kPlaneTH, kh, sh) * windows_across(kPlaneTW, kw, sw));
}

// first window that reaches position lo of the padded axis: ceil((lo - k + 1) / s), at least 0
__device__ __forceinline__ int first_window(int lo, int k, int s) {
  const int a = lo - k + 1;
  return a <= 0 ? 0 : (a + s - 1) / s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from device memory to shared memory, of which the first
// `bytes` are read and the rest filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// four neighbouring elements (16 or 8 bytes), zeros where !in
__device__ __forceinline__ void copy_quad(float* dst, const float* src, bool in) {
  cp_async16(dst, src, in ? 16 : 0);
}
__device__ __forceinline__ void copy_quad(__nv_bfloat16* dst, const __nv_bfloat16* src, bool in) {
  cp_async8(dst, src, in ? 8 : 0);
}

// one element, a zero where !in; cp.async has no 2-byte copy, so bf16 loads
// and stores it
__device__ __forceinline__ void copy_one(float* dst, const float* src, bool in) {
  cp_async4(dst, src, in ? 4 : 0);
}
__device__ __forceinline__ void copy_one(__nv_bfloat16* dst, const __nv_bfloat16* src, bool in) {
  *dst = in ? *src : __ushort_as_bfloat16(0);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// four neighbouring elements from shared memory (16- or 8-byte aligned), widened
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// four float32 sums to device memory in one store, rounded once to T
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The windows that reach a tile [h0, h0 + th) x [w0, w0 + tw): rows oh_lo
// .. oh_lo + wh - 1, columns ow_lo .. ow_lo + ww - 1; the x they read,
// inside the plane: rows [xr0, xr1), columns [xc0, xc1); hb, wb: the
// padded region's first row and column (the origin of the staged x).
struct Reach {
  int oh_lo, ow_lo, wh, ww, hb, wb, xr0, xr1, xc0, xc1;
  __device__ Reach(const Geometry& g, int h0, int w0, int th, int tw, int kh, int kw, int sh,
                   int sw) {
    oh_lo = first_window(h0 + g.ph, kh, sh);
    ow_lo = first_window(w0 + g.pw, kw, sw);
    const int oh_hi = min(g.oh - 1, (h0 + th - 1 + g.ph) / sh);
    const int ow_hi = min(g.ow - 1, (w0 + tw - 1 + g.pw) / sw);
    wh = max(oh_hi - oh_lo + 1, 0);
    ww = max(ow_hi - ow_lo + 1, 0);
    hb = oh_lo * sh - g.ph;
    wb = ow_lo * sw - g.pw;
    xr0 = max(hb, 0);
    xr1 = min(g.h, oh_hi * sh - g.ph + kh);
    xc0 = max(wb, 0);
    xc1 = min(g.w, ow_hi * sw - g.pw + kw);
  }
};

// NCHW, kPlanes planes a block, elements of type T. KH, KW, SH, SW: the
// window and stride at compile time, or 0 to read g's. VEC: W and OW
// multiples of 4, tensors 16-byte aligned.
template <typename T, int KH, int KW, int SH, int SW, bool VEC>
__global__ void __launch_bounds__(kThreads)
    pool_bwd_nchw_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ dy, T* __restrict__ dx, Geometry g,
                         int64_t plane0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int kh = KH ? KH : g.kh, kw = KW ? KW : g.kw;
  const int sh = SH ? SH : g.sh, sw = SW ? SW : g.sw;
  const int WH = windows_across(kPlaneTH, kh, sh), WW = windows_across(kPlaneTW, kw, sw);
  const int XS = round4((WW - 1) * sw + kw + 3), YS = round4(WW + 3);
  // per plane: x [XR][XS], y and dy [WH][YS]; then the taps [kPlanes][WH * WW]
  const int XP = ((WH - 1) * sh + kh) * XS, YP = WH * YS;
  T* xs = smem;
  T* ys = xs + kPlanes * XP;
  T* dys = ys + kPlanes * YP;
  uint16_t* taps = reinterpret_cast<uint16_t*>(dys + kPlanes * YP);
  // neighbouring blocks are neighbouring tiles of the same planes
  const int h0 = blockIdx.y * kPlaneTH, w0 = blockIdx.x * kPlaneTW;
  const int64_t first = plane0 + (int64_t)blockIdx.z * kPlanes;
  const int planes = (int)min((int64_t)kPlanes, (int64_t)g.n * g.c - first);
  const T* xp = x + first * g.h * g.w;
  const T* yp = y + first * g.oh * g.ow;
  const T* dyp = dy + first * g.oh * g.ow;
  const int64_t xstride = (int64_t)g.h * g.w, ystride = (int64_t)g.oh * g.ow;
  const Reach a(g, h0, w0, kPlaneTH, kPlaneTW, kh, kw, sh, sw);
  // the staged rows start at a 4-element boundary of the plane's row
  const int xcb = VEC ? a.xc0 & ~3 : a.xc0, ycb = VEC ? a.ow_lo & ~3 : a.ow_lo;

  // 1. stage x, y and dy of every plane
  {
    const int xq = VEC ? (a.xc1 - xcb + 3) / 4 : a.xc1 - a.xc0;
    const int yq = VEC ? (a.ow_lo + a.ww - ycb + 3) / 4 : a.ww;
    const int xrows = a.xr1 - a.xr0, step = VEC ? 4 : 1;
    for (int i = threadIdx.x; i < planes * xrows * xq; i += kThreads) {
      const int p = i / (xrows * xq), rq = i % (xrows * xq);
      const int r = a.xr0 + rq / xq, q = rq % xq;
      T* dst = xs + p * XP + (r - a.hb) * XS + step * q;
      const T* src = xp + p * xstride + (int64_t)r * g.w + xcb + step * q;
      if (VEC) copy_quad(dst, src, true);
      else copy_one(dst, src, true);
    }
    for (int i = threadIdx.x; i < planes * a.wh * yq; i += kThreads) {
      const int p = i / (a.wh * yq), rq = i % (a.wh * yq);
      const int r = rq / yq, q = rq % yq;
      const int64_t at = p * ystride + (int64_t)(a.oh_lo + r) * g.ow + ycb + step * q;
      const int off = p * YP + r * YS + step * q;
      if (VEC) {
        copy_quad(ys + off, yp + at, true);
        copy_quad(dys + off, dyp + at, true);
      } else {
        copy_one(ys + off, yp + at, true);
        copy_one(dys + off, dyp + at, true);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. each window's first tap that equals y, in every plane
  const int windows = a.wh * a.ww;
  for (int i = threadIdx.x; i < windows; i += kThreads) {
    const int oi = i / a.ww, oj = i % a.ww;
    const int hh0 = a.hb + oi * sh, ww0 = a.wb + oj * sw;
    float yv[kPlanes];
    unsigned tap[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      yv[p] = widen(ys[p * YP + oi * YS + a.ow_lo - ycb + oj]);
      tap[p] = kNoTap;
    }
#pragma unroll
    for (int di = kh - 1; di >= 0; --di) {
      const int hh = hh0 + di;
#pragma unroll
      for (int dj = kw - 1; dj >= 0; --dj) {
        const int wc = ww0 + dj;
        // padding never holds the maximum
        if (hh >= 0 && hh < g.h && wc >= 0 && wc < g.w) {
          const T* xv = xs + (hh - a.hb) * XS + wc - xcb;
#pragma unroll
          for (int p = 0; p < kPlanes; ++p)
            if (widen(xv[p * XP]) == yv[p]) tap[p] = di * kw + dj;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) taps[p * windows + i] = (uint16_t)tap[p];
  }
  __syncthreads();

  // 3. four neighbouring elements of one row a thread, in every plane
  const int h = h0 + threadIdx.x / (kPlaneTW / 4);
  const int w = w0 + 4 * (threadIdx.x % (kPlaneTW / 4));
  if (h >= g.h || w >= g.w) return;
  const int hq = h + g.ph;  // position in the padded plane
  float out[kPlanes][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int wq = w + e + g.pw;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) out[p][e] = 0.f;
    for (int di = hq % sh; di < kh && di <= hq; di += sh) {
      const int oh = (hq - di) / sh;
      if (oh >= g.oh) continue;
      for (int dj = wq % sw; dj < kw && dj <= wq; dj += sw) {
        const int ow = (wq - dj) / sw;
        if (ow >= g.ow) continue;
        const int win = (oh - a.oh_lo) * a.ww + ow - a.ow_lo;
        const int at = (oh - a.oh_lo) * YS + ow - ycb;
        const unsigned tap = di * kw + dj;
#pragma unroll
        for (int p = 0; p < kPlanes; ++p)
          if (taps[p * windows + win] == tap)
            out[p][e] = __fadd_rn(out[p][e], widen(dys[p * YP + at]));
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    if (p >= planes) break;
    T* dst = dx + (first + p) * xstride + (int64_t)h * g.w + w;
    if (VEC) {
      store4(dst, out[p][0], out[p][1], out[p][2], out[p][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (w + e < g.w) store1(dst + e, out[p][e]);
    }
  }
}

// Channels-last: element (n, c, h, w) at ((n * H + h) * W + w) * C + c.
// VEC: C a multiple of 4, tensors 16-byte aligned.
template <typename T, int KH, int KW, int SH, int SW, bool VEC>
__global__ void __launch_bounds__(kThreads)
    pool_bwd_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ dy, T* __restrict__ dx, Geometry g,
                         int64_t image0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int kh = KH ? KH : g.kh, kw = KW ? KW : g.kw;
  const int sh = SH ? SH : g.sh, sw = SW ? SW : g.sw;
  const int WH = windows_across(kPixTH, kh, sh), WW = windows_across(kPixTW, kw, sw);
  const int XC = (WW - 1) * sw + kw, XR = (WH - 1) * sh + kh;
  T* xs = smem;
  T* ys = xs + XR * XC * kCB;
  T* dys = ys + WH * WW * kCB;
  uint16_t* taps = reinterpret_cast<uint16_t*>(dys + WH * WW * kCB);
  const int chunks = (g.c + kCB - 1) / kCB;
  // neighbouring blocks are the channel chunks of one tile, then
  // neighbouring tiles of one row
  const int c0 = blockIdx.x % chunks * kCB;
  const int w0 = blockIdx.x / chunks * kPixTW, h0 = blockIdx.y * kPixTH;
  const int64_t img = image0 + blockIdx.z;
  const T* xi = x + img * g.h * g.w * g.c;
  const T* yi = y + img * g.oh * g.ow * g.c;
  const T* dyi = dy + img * g.oh * g.ow * g.c;
  const Reach a(g, h0, w0, kPixTH, kPixTW, kh, kw, sh, sw);
  constexpr int kQ = VEC ? kCB / 4 : kCB;  // copies a pixel

  // 1. stage x, y and dy: pixel by pixel, kCB channels each (zeros past C)
  const int xcols = a.xc1 - a.xc0;
  for (int i = threadIdx.x; i < (a.xr1 - a.xr0) * xcols * kQ; i += kThreads) {
    const int p = i / kQ, q = i % kQ;
    const int r = a.xr0 + p / xcols, col = a.xc0 + p % xcols;
    const int cc = c0 + (VEC ? 4 * q : q);
    T* dst = xs + ((r - a.hb) * XC + col - a.wb) * kCB + (VEC ? 4 * q : q);
    const T* src = cc < g.c ? xi + ((int64_t)r * g.w + col) * g.c + cc : xi;
    if (VEC) copy_quad(dst, src, cc < g.c);
    else copy_one(dst, src, cc < g.c);
  }
  for (int i = threadIdx.x; i < a.wh * a.ww * kQ; i += kThreads) {
    const int p = i / kQ, q = i % kQ;
    const int cc = c0 + (VEC ? 4 * q : q);
    const int64_t at = ((int64_t)(a.oh_lo + p / a.ww) * g.ow + a.ow_lo + p % a.ww) * g.c + cc;
    const int off = p * kCB + (VEC ? 4 * q : q);
    if (VEC) {
      copy_quad(ys + off, cc < g.c ? yi + at : yi, cc < g.c);
      copy_quad(dys + off, cc < g.c ? dyi + at : dyi, cc < g.c);
    } else {
      copy_one(ys + off, cc < g.c ? yi + at : yi, cc < g.c);
      copy_one(dys + off, cc < g.c ? dyi + at : dyi, cc < g.c);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. each window's first tap that equals y, four channels a thread
  for (int i = threadIdx.x; i < a.wh * a.ww * (kCB / 4); i += kThreads) {
    const int win = i / (kCB / 4), q = i % (kCB / 4);
    const float4 yv = load4(ys + win * kCB + 4 * q);
    const int hh0 = a.hb + win / a.ww * sh, ww0 = a.wb + win % a.ww * sw;
    unsigned t0 = kNoTap, t1 = kNoTap, t2 = kNoTap, t3 = kNoTap;
#pragma unroll
    for (int di = kh - 1; di >= 0; --di) {
      const int hh = hh0 + di;
#pragma unroll
      for (int dj = kw - 1; dj >= 0; --dj) {
        const int wc = ww0 + dj;
        if (hh >= 0 && hh < g.h && wc >= 0 && wc < g.w) {  // padding never holds the maximum
          const float4 xv = load4(xs + ((hh - a.hb) * XC + wc - a.wb) * kCB + 4 * q);
          const unsigned tap = di * kw + dj;
          if (xv.x == yv.x) t0 = tap;
          if (xv.y == yv.y) t1 = tap;
          if (xv.z == yv.z) t2 = tap;
          if (xv.w == yv.w) t3 = tap;
        }
      }
    }
    *reinterpret_cast<uint2*>(taps + win * kCB + 4 * q) = make_uint2(t0 | t1 << 16, t2 | t3 << 16);
  }
  __syncthreads();

  // 3. four neighbouring channels of one pixel a thread
  for (int i = threadIdx.x; i < kPixTH * kPixTW * (kCB / 4); i += kThreads) {
    const int p = i / (kCB / 4), q = i % (kCB / 4);
    const int h = h0 + p / kPixTW, w = w0 + p % kPixTW, cc = c0 + 4 * q;
    if (h >= g.h || w >= g.w || cc >= g.c) continue;
    const int hq = h + g.ph, wq = w + g.pw;  // position in the padded plane
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int di = hq % sh; di < kh && di <= hq; di += sh) {
      const int oh = (hq - di) / sh;
      if (oh >= g.oh) continue;
      for (int dj = wq % sw; dj < kw && dj <= wq; dj += sw) {
        const int ow = (wq - dj) / sw;
        if (ow >= g.ow) continue;
        const int win = (oh - a.oh_lo) * a.ww + ow - a.ow_lo;
        const uint2 t = *reinterpret_cast<const uint2*>(taps + win * kCB + 4 * q);
        const float4 d = load4(dys + win * kCB + 4 * q);
        const unsigned tap = di * kw + dj;
        if ((t.x & 0xffffu) == tap) a0 = __fadd_rn(a0, d.x);
        if ((t.x >> 16) == tap) a1 = __fadd_rn(a1, d.y);
        if ((t.y & 0xffffu) == tap) a2 = __fadd_rn(a2, d.z);
        if ((t.y >> 16) == tap) a3 = __fadd_rn(a3, d.w);
      }
    }
    T* dst = dx + ((img * g.h + h) * g.w + w) * g.c + cc;
    if (VEC) {
      store4(dst, a0, a1, a2, a3);
    } else {
      const float v[4] = {a0, a1, a2, a3};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (cc + e < g.c) store1(dst + e, v[e]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int KH, int KW, int SH, int SW, bool VEC>
int run(bool channels_last, const T* x, const T* y, const T* dy, T* dx, const Geometry& g,
        cudaStream_t s) {
  auto* kernel = channels_last ? pool_bwd_nhwc_kernel<T, KH, KW, SH, SW, VEC>
                               : pool_bwd_nchw_kernel<T, KH, KW, SH, SW, VEC>;
  const int smem = smem_bytes(channels_last, g.kh, g.kw, g.sh, g.sw, (int)sizeof(T));
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // the grid's z axis takes at most 65535 images (groups of kPlanes planes):
  // more go in further launches
  const int64_t count = channels_last ? g.n : ((int64_t)g.n * g.c + kPlanes - 1) / kPlanes;
  const int tiles_h = channels_last ? (g.h + kPixTH - 1) / kPixTH : (g.h + kPlaneTH - 1) / kPlaneTH;
  const int64_t across = channels_last
                             ? (int64_t)((g.w + kPixTW - 1) / kPixTW) * ((g.c + kCB - 1) / kCB)
                             : (g.w + kPlaneTW - 1) / kPlaneTW;
  for (int64_t z0 = 0; z0 < count; z0 += 65535) {
    const int64_t z = count - z0 < 65535 ? count - z0 : 65535;
    kernel<<<dim3((unsigned)across, (unsigned)tiles_h, (unsigned)z), kThreads, smem, s>>>(
        x, y, dy, dx, g, channels_last ? z0 : z0 * kPlanes);
  }
  return (int)cudaGetLastError();
}

template <typename T, int KH, int KW, int SH, int SW>
int launch(bool channels_last, bool vec, const T* x, const T* y, const T* dy, T* dx,
           const Geometry& g, cudaStream_t s) {
  return vec ? run<T, KH, KW, SH, SW, true>(channels_last, x, y, dy, dx, g, s)
             : run<T, KH, KW, SH, SW, false>(channels_last, x, y, dy, dx, g, s);
}

// The checks and the dispatch on the geometry of both entries
template <typename T>
int pool_backward(const void* x, const void* y, const void* dy, void* dx, int n, int c, int h,
                  int w, int oh, int ow, int kh, int kw, int sh, int sw, int ph, int pw,
                  int channels_last, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || kh <= 0 || kw <= 0 ||
      sh <= 0 || sw <= 0 || ph < 0 || pw < 0 || (int64_t)kh * kw >= (int64_t)kNoTap)
    return (int)cudaErrorInvalidValue;
  const bool cl = channels_last != 0;
  const int64_t tiles_h = cl ? (h + kPixTH - 1) / kPixTH : (h + kPlaneTH - 1) / kPlaneTH;
  const int64_t across = cl ? (int64_t)((w + kPixTW - 1) / kPixTW) * ((c + kCB - 1) / kCB)
                            : (w + kPlaneTW - 1) / kPlaneTW;
  // a tile's windows and halo must fit in shared memory (3x3/2 in float32:
  // 35 KB NCHW, 41 KB channels-last); a window bigger than 64 x 64 does not
  if (tiles_h > 65535 || across > 0x7fffffff || kh > 64 || kw > 64 ||
      smem_bytes(cl, kh, kw, sh, sw, (int)sizeof(T)) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Geometry g{n, c, h, w, oh, ow, kh, kw, sh, sw, ph, pw};
  const auto *xp = static_cast<const T*>(x), *yp = static_cast<const T*>(y);
  const auto* dyp = static_cast<const T*>(dy);
  auto* dxp = static_cast<T*>(dx);
  const bool vec = aligned16(x) && aligned16(y) && aligned16(dy) && aligned16(dx) &&
                   (cl ? c % 4 == 0 : w % 4 == 0 && ow % 4 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kh == 3 && kw == 3 && sh == 2 && sw == 2)
    return launch<T, 3, 3, 2, 2>(cl, vec, xp, yp, dyp, dxp, g, s);
  if (kh == 2 && kw == 2 && sh == 2 && sw == 2)
    return launch<T, 2, 2, 2, 2>(cl, vec, xp, yp, dyp, dxp, g, s);
  if (kh == 3 && kw == 3 && sh == 1 && sw == 1)
    return launch<T, 3, 3, 1, 1>(cl, vec, xp, yp, dyp, dxp, g, s);
  return launch<T, 0, 0, 0, 0>(cl, vec, xp, yp, dyp, dxp, g, s);
}

}  // namespace

// dx from x [N, C, H, W] and y, dy [N, C, OH, OW], all float32 and laid out
// alike: NCHW-contiguous (channels_last 0) or channels-last (1, element
// (n, c, h, w) at ((n * H + h) * W + w) * C + c); dx is written in the same
// layout. Returns cudaGetLastError() after the launch.
extern "C" int ptt_max_pool2d_backward(const void* x, const void* y, const void* dy, void* dx,
                                       int n, int c, int h, int w, int oh, int ow, int kh, int kw,
                                       int sh, int sw, int ph, int pw, int channels_last,
                                       void* stream) {
  return pool_backward<float>(x, y, dy, dx, n, c, h, w, oh, ow, kh, kw, sh, sw, ph, pw,
                              channels_last, stream);
}

// The same with x, y, dy and dx in bf16: the taps added in float32, each
// element of dx rounded once.
extern "C" int ptt_max_pool2d_backward_bf16(const void* x, const void* y, const void* dy,
                                            void* dx, int n, int c, int h, int w, int oh, int ow,
                                            int kh, int kw, int sh, int sw, int ph, int pw,
                                            int channels_last, void* stream) {
  return pool_backward<__nv_bfloat16>(x, y, dy, dx, n, c, h, w, oh, ow, kh, kw, sh, sw, ph, pw,
                                      channels_last, stream);
}
