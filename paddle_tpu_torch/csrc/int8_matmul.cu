// int8 x int8 -> int32 matrix product, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/int8_matmul.py _kernel / _pallas_matmul:
// out [M, N] int32 = x [M, K] int8 @ w [K, N] int8, both row-major, with
// exact 32-bit accumulation. Any M, K and N: ragged edges are masked with
// zeros while a tile is staged, which is exact for an integer product, so
// there are no padded copies and no size rule.
//
// Bound on the H100: device memory at the serving shapes. The int32 output
// is four bytes an element against one byte an element of input, and
// 2*M*K*N operations at the card's int8 tensor-core rate take less time
// than writing M*N*4 bytes until K reaches a few thousand.
//
// Design: one block of 256 threads (8 warps, 2 x 4) per 128 x 128 output
// tile, a K step of 32. The tensor cores take their int8 operands as
// 32-bit words of four consecutive K values. For x those four bytes are
// neighbours in memory. For w they are N bytes apart, so they are packed
// while the tile is staged: a thread reads four bytes of each of four
// consecutive rows of w and transposes the 4 x 4 bytes in registers with
// shifts, never through a transposed copy of w. Both tiles sit in shared
// memory as [K / 4][rows or columns] words (the row stride padded by 8
// words so that a fragment's 32 reads fall on 32 banks), and each warp
// computes 64 x 32 outputs as 4 x 4 mma.sync.m16n8k32 (s8 x s8 -> s32)
// products a step. The next tiles are fetched into registers while the
// current ones are multiplied. Rows of x are read 16 bytes a thread when K
// is a multiple of 16 and x is 16-byte aligned, rows of w 4 bytes a thread
// when N is a multiple of 4; otherwise byte by byte with masks (K = 147 or
// 70, N = 130 or 257).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;      // output rows a block
constexpr int kBN = 128;      // output columns a block
constexpr int kBK = 32;       // K values a step: one mma's depth
constexpr int kQ = kBK / 4;   // packed words along K a step
constexpr int kPad = 8;       // words added to a shared row: conflict-free fragment reads
constexpr int kThreads = 256;
constexpr int kWarpM = 64;    // output rows a warp
constexpr int kWarpN = 32;    // output columns a warp

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool A_VEC, bool B_VEC>
__global__ void __launch_bounds__(kThreads)
    int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int32_t* __restrict__ out, int m, int k, int n) {
  __shared__ __align__(16) uint32_t as[kQ][kBM + kPad];
  __shared__ __align__(16) uint32_t bs[kQ][kBN + kPad];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;

  // staging: thread (a_r, a_half) holds 16 K values of one row of x;
  // thread (b_q, b_c) holds 4 K values of 4 neighbouring columns of w
  const int a_r = tid / 2, a_half = tid % 2;
  const int b_q = tid / 32, b_c = tid % 32;
  uint32_t a_reg[4], b_reg[4];

  auto fetch = [&](int k0) {
    const int gr = row0 + a_r;
    const int gk = k0 + 16 * a_half;
    if (A_VEC) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < m && gk < k) v = *reinterpret_cast<const uint4*>(x + (int64_t)gr * k + gk);
      a_reg[0] = v.x; a_reg[1] = v.y; a_reg[2] = v.z; a_reg[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t word = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = gk + 4 * j + i;
          if (gr < m && kk < k)
            word |= (uint32_t)(uint8_t)x[(int64_t)gr * k + kk] << (8 * i);
        }
        a_reg[j] = word;
      }
    }
    // rows[j] holds w[k0 + 4*b_q + j][col0 + 4*b_c .. + 3], one byte a column
    uint32_t rows[4];
    const int gc = col0 + 4 * b_c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k0 + 4 * b_q + j;
      uint32_t word = 0u;
      if (kk < k) {
        if (B_VEC) {
          if (gc < n) word = *reinterpret_cast<const uint32_t*>(w + (int64_t)kk * n + gc);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (gc + i < n) word |= (uint32_t)(uint8_t)w[(int64_t)kk * n + gc + i] << (8 * i);
        }
      }
      rows[j] = word;
    }
    // 4 x 4 byte transpose: b_reg[i] holds the four K values of column gc + i
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b_reg[i] = ((rows[0] >> (8 * i)) & 0xffu) | (((rows[1] >> (8 * i)) & 0xffu) << 8) |
                 (((rows[2] >> (8 * i)) & 0xffu) << 16) | (((rows[3] >> (8 * i)) & 0xffu) << 24);
  };
  auto stash = [&]() {
#pragma unroll
    for (int j = 0; j < 4; ++j) as[4 * a_half + j][a_r] = a_reg[j];
    *reinterpret_cast<uint4*>(&bs[b_q][4 * b_c]) =
        make_uint4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
  };

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * kWarpM;  // the warp's first row in the tile
  const int wn = (warp % 4) * kWarpN;  // the warp's first column in the tile
  const int g = lane / 4, t = lane % 4;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  fetch(0);
  for (int k0 = 0; k0 < k; k0 += kBK) {
    stash();
    __syncthreads();
    if (k0 + kBK < k) fetch(k0 + kBK);  // in flight while this step is multiplied
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r = wm + 16 * mi + g;
      af[mi][0] = as[t][r];
      af[mi][1] = as[t][r + 8];
      af[mi][2] = as[4 + t][r];
      af[mi][3] = as[4 + t][r + 8];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = wn + 8 * ni + g;
      bf[ni][0] = bs[t][c];
      bf[ni][1] = bs[4 + t][c];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    __syncthreads();
  }

  const bool pair = (n % 2) == 0;  // then out + r*n + c is 8-byte aligned for even c
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + wm + 16 * mi + g + 8 * half;
        const int c = col0 + wn + 8 * ni + 2 * t;
        if (r >= m || c >= n) continue;
        int32_t* dst = out + (int64_t)r * n + c;
        const int v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (pair) {
          *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        } else {
          dst[0] = v0;
          if (c + 1 < n) dst[1] = v1;
        }
      }
}

}  // namespace

// out [M, N] int32 = x [M, K] int8 @ w [K, N] int8, all contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_int8_matmul(const void* x, const void* w, void* out, int m, int k, int n,
                               void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (n + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  const bool a_vec = (k % 16 == 0) && (reinterpret_cast<uintptr_t>(xp) % 16 == 0);
  const bool b_vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(wp) % 4 == 0);
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)((n + kBN - 1) / kBN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_vec && b_vec) int8_mm_kernel<true, true><<<grid, kThreads, 0, s>>>(xp, wp, op, m, k, n);
  else if (a_vec) int8_mm_kernel<true, false><<<grid, kThreads, 0, s>>>(xp, wp, op, m, k, n);
  else if (b_vec) int8_mm_kernel<false, true><<<grid, kThreads, 0, s>>>(xp, wp, op, m, k, n);
  else int8_mm_kernel<false, false><<<grid, kThreads, 0, s>>>(xp, wp, op, m, k, n);
  return (int)cudaGetLastError();
}
