// int8 x int8 -> int32 matrix product, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/int8_matmul.py _kernel / _pallas_matmul:
// out [M, N] int32 = x [M, K] int8 @ w [K, N] int8, both row-major, with
// exact 32-bit accumulation. Any M, K and N: ragged edges are filled with
// zeros while a tile is staged, which is exact for an integer product, so
// there are no padded copies and no size rule.
//
// Bound on the H100: device memory at the serving shapes. The int32 output
// is four bytes an element against one byte an element of input, and
// 2*M*K*N operations at the card's int8 tensor-core rate take less time
// than writing M*N*4 bytes until K reaches a few thousand. At serving's
// small M the whole cost is streaming w once, so what matters is how many
// of its bytes are in flight.
//
// Design: one block of 256 threads (8 warps, 2 x 4, each a 64 x 32 quarter
// of it) per 128 x 128 output tile. Slabs of 128 K values (a 128 x 128
// slab of x and a 128 x 128 slab of w) stream through a ring of kStages slabs in
// shared memory, filled by cp.async 16 bytes a copy straight from the rows
// as they lie, with no registers in between: the copies of the next
// kStages - 1 slabs are in flight while one is multiplied, one
// cp.async.wait_group and one barrier a slab. Products run on
// mma.sync.m16n8k32 (s8 x s8 -> s32). A fragments come from the x slab by
// ldmatrix (rows kSA = 144 bytes apart: eight rows fall on eight distinct
// 16-byte bank groups). The B fragment needs four consecutive K bytes of
// one column, and w is row-major; so w is packed on its way to the
// fragments, not on its way in: the warp's 32 columns are permuted so that
// lane group g takes columns 4g .. 4g + 3 as column g of its four n8 tiles.
// Then one 4-byte shared load of a w row feeds all four tiles, and four of
// them (K rows 4t .. 4t + 3) become four B words by a 4 x 4 byte transpose
// of eight byte_perms. The w slab's 16-byte chunks are stored XOR-swizzled
// by row (chunk ^ 2 * ((row / 4) % 4)), so the four K rows a warp's load
// touches lie on distinct banks. The permutation makes each lane's
// accumulators eight neighbouring columns of a row, two 16-byte stores
// into the staged output tile.
//
// Split-K: where the output tiles are fewer than the card's 132 SMs
// (serving at M <= 512: 1-96 tiles), block z of the grid multiplies slabs
// [z * per, (z + 1) * per) of K and adds its tile into the output by
// red.global.add.s32, the output zeroed first. int32 sums are exact in any
// order, so the result is bit-equal to one pass whatever order the adds
// land in; and it needs no workspace and no second pass over the output
// (an ordered second pass would write and read slices * M * N * 4 bytes
// more). Either way the tile goes through shared memory first, so a
// warp's stores cover 512 contiguous bytes and its adds 128. plan() makes
// the split; ops/cuda/int8_matmul.py _split_k is the same plan in Python,
// and chip_smoke.py holds the two equal at every checked shape.
//
// x rows are copied 16 bytes at a time when K is a multiple of 16 and x is
// 16-byte aligned, w rows when N is; otherwise byte by byte with masks
// (K = 70 or 129, N = 2, 130 or 257), into the same layout.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBM = 128;                  // output rows a block
constexpr int kBN = 128;                  // output columns a block
constexpr int kBK = 128;                  // K values a slab
constexpr int kStages = 3;                // slabs in the ring
constexpr int kThreads = 256;
constexpr int kWM = 64;                   // output rows a warp
constexpr int kWN = 32;                   // output columns a warp
constexpr int kWarpsN = kBN / kWN;
constexpr int kSA = kBK + 16;             // bytes between x rows of a slab
constexpr int kStageA = kBM * kSA;
constexpr int kStageBytes = kStageA + kBK * kBN;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kSO = kBN + 4;              // int32 words between rows of the staged tile
constexpr int kWave = 132;                // split-K plans for one block an SM
constexpr int kMinSliceSlabs = 2;         // split-K slices are about this deep or deeper

static_assert(kBM * kSO * 4 <= kSmemBytes, "the staged tile fits in the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory past L1, of which the first
// `bytes` (0 or 16) are read and the rest filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void red_add(int32_t* p, int v) {
  asm volatile("red.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// where chunk q (16 bytes) of row r of a w slab sits in its stage
__device__ __forceinline__ int b_chunk(int r, int q) {
  return r * kBN + ((q ^ (2 * ((r >> 2) & 3))) << 4);
}

// 16 bytes of a row from `src` (valid: how many are inside the matrix) to
// `dst`, byte by byte, zeros past the edge
__device__ __forceinline__ void copy16(uint8_t* dst, const int8_t* __restrict__ src, int valid) {
#pragma unroll 4
  for (int e = 0; e < 16; ++e) dst[e] = e < valid ? (uint8_t)src[e] : 0;
}

// Copy slab [kb, kb + kBK) of x rows [row0, row0 + kBM) and of w columns
// [col0, col0 + kBN) into one stage; what lies at or past m, k_end or n is
// zero. A_VEC / B_VEC: 16-byte copies (K, resp. N, a multiple of 16).
template <bool A_VEC, bool B_VEC>
__device__ __forceinline__ void load_slab(uint8_t* stage, const int8_t* __restrict__ x,
                                          const int8_t* __restrict__ w, int64_t row0, int col0,
                                          int kb, int m, int k_end, int k, int n) {
  uint8_t* bs = stage + kStageA;
#pragma unroll
  for (int p = 0; p < kBM * (kBK / 16) / kThreads; ++p) {
    const int i = threadIdx.x + p * kThreads;
    const int r = i / (kBK / 16), q = i % (kBK / 16);
    const int gk = kb + 16 * q;
    const int valid = row0 + r < m ? max(0, min(16, k_end - gk)) : 0;
    const int8_t* src = x + (row0 + r) * k + gk;
    if (A_VEC) cp_async16(stage + r * kSA + 16 * q, valid ? src : x, valid);
    else copy16(stage + r * kSA + 16 * q, src, valid);
  }
#pragma unroll
  for (int p = 0; p < kBK * (kBN / 16) / kThreads; ++p) {
    const int i = threadIdx.x + p * kThreads;
    const int r = i / (kBN / 16), q = i % (kBN / 16);
    const int gc = col0 + 16 * q;
    const int valid = kb + r < k_end ? max(0, min(16, n - gc)) : 0;
    const int8_t* src = w + (int64_t)(kb + r) * n + gc;
    if (B_VEC) cp_async16(bs + b_chunk(r, q), valid ? src : w, valid);
    else copy16(bs + b_chunk(r, q), src, valid);
  }
}

// out (+)= x @ w over slabs [blockIdx.z * slice_slabs, ...) of K: a plain
// store with one slice, red.global.add into a zeroed out with more
template <bool A_VEC, bool B_VEC>
__global__ void __launch_bounds__(kThreads, 2)
    int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int32_t* __restrict__ out, int m, int k, int n, int slice_slabs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;  // the warp's corner
  const int64_t row0 = (int64_t)blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int k_begin = blockIdx.z * slice_slabs * kBK;
  const int k_end = min(k, k_begin + slice_slabs * kBK);
  const int slabs = (k_end - k_begin + kBK - 1) / kBK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // the ring: slab s sits in stage s % kStages; one commit group a slab,
  // empty past the last, so the wait below counts slabs
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs)
      load_slab<A_VEC, B_VEC>(smem + s * kStageBytes, x, w, row0, col0, k_begin + s * kBK, m,
                              k_end, k, n);
    cp_async_commit();
  }
  // this lane's ldmatrix row (lanes 0-15: rows 0-15 at k 0-15, 16-31 at k 16-31)
  const int a_off = (wm + (lane & 15)) * kSA + (lane >> 4) * 16;
  // this lane's w bytes: columns wn + 4g .. + 3 of K rows 4t + i (+ 16),
  // whose swizzle is 2t: (row / 4) % 4 == t for every row it reads
  const int b_off = 4 * t * kBN + ((((wn + 4 * g) >> 4) ^ (2 * t)) << 4) + ((4 * g) & 15);
#pragma unroll 1
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kStages - 2>();  // slab s has landed (this thread's copies)
    __syncthreads();               // everyone's, and slab s - 1's stage is free
    const int next = s + kStages - 1;
    if (next < slabs)
      load_slab<A_VEC, B_VEC>(smem + next % kStages * kStageBytes, x, w, row0, col0,
                              k_begin + next * kBK, m, k_end, k, n);
    cp_async_commit();
    const uint8_t* as = smem + s % kStages * kStageBytes;
    const uint8_t* bs = as + kStageA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], as + a_off + 16 * i * kSA + kk);
      uint32_t b[4][2];  // [n8 tile j][K half]: four K values of column wn + 4g + j
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t* bp = bs + (kk + 16 * h) * kBN + b_off;
        const uint32_t r0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t r1 = *reinterpret_cast<const uint32_t*>(bp + kBN);
        const uint32_t r2 = *reinterpret_cast<const uint32_t*>(bp + 2 * kBN);
        const uint32_t r3 = *reinterpret_cast<const uint32_t*>(bp + 3 * kBN);
        // 4 x 4 byte transpose: b[j][h] byte i is byte j of row r_i
        const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
        const uint32_t lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
        b[0][h] = __byte_perm(lo01, lo23, 0x5410);
        b[1][h] = __byte_perm(lo01, lo23, 0x7632);
        b[2][h] = __byte_perm(hi01, hi23, 0x5410);
        b[3][h] = __byte_perm(hi01, hi23, 0x7632);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  // the tile through shared memory (the ring's space): a lane holds rows
  // wm + 16i + g (+ 8) at columns wn + 8t + j (acc[i][j][0 | 2]) and
  // wn + 8t + 4 + j (acc[i][j][1 | 3]), four neighbouring columns a
  // 16-byte store; then neighbouring lanes write neighbouring columns
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  int32_t* tile = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<int4*>(tile + (wm + 16 * i + g + 8 * h) * kSO + wn + 8 * t + 4 * half) =
            make_int4(acc[i][0][2 * h + half], acc[i][1][2 * h + half], acc[i][2][2 * h + half],
                      acc[i][3][2 * h + half]);
  __syncthreads();
  const int rows = m - row0 < kBM ? (int)(m - row0) : kBM, cols = min(kBN, n - col0);
  if (gridDim.z == 1) {  // one slice: 16-byte stores, a warp 512 contiguous bytes
    const bool vec = n % 4 == 0;  // then every row start is 16-byte aligned
    for (int e = threadIdx.x; e < rows * (kBN / 4); e += kThreads) {
      const int r = e / (kBN / 4), c = 4 * (e % (kBN / 4));
      const int4 v = *reinterpret_cast<const int4*>(tile + r * kSO + c);
      int32_t* dst = out + (row0 + r) * n + col0 + c;
      if (vec && c + 3 < cols) {
        *reinterpret_cast<int4*>(dst) = v;
      } else {
        if (c < cols) dst[0] = v.x;
        if (c + 1 < cols) dst[1] = v.y;
        if (c + 2 < cols) dst[2] = v.z;
        if (c + 3 < cols) dst[3] = v.w;
      }
    }
  } else {  // split-K: a warp's adds cover 128 contiguous bytes
    for (int e = threadIdx.x; e < rows * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      if (c < cols) red_add(out + (row0 + r) * n + col0 + c, tile[r * kSO + c]);
    }
  }
}

// The split-K plan: `slices` slices of `per` slabs each (the last one
// shorter, none empty). One slice when the output tiles are at least
// kWave; else as many slices as make kWave blocks, but no more than slices
// of kMinSliceSlabs slabs would make. Planned for one block an SM: a second
// block an SM from more slices cost more in zeroing and atomic adds than
// it gained on the H100. ops/cuda/int8_matmul.py _split_k is the same.
void plan(int m, int k, int n, int* slices, int* per) {
  const int64_t tiles = (int64_t)((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  const int slabs = (k + kBK - 1) / kBK;
  int64_t want = 1;
  if (tiles < kWave)
    want = std::max<int64_t>(1, std::min<int64_t>(kWave / tiles,
                                                  (slabs + kMinSliceSlabs - 1) / kMinSliceSlabs));
  *per = (int)((slabs + want - 1) / want);
  *slices = (slabs + *per - 1) / *per;
}

template <bool A_VEC, bool B_VEC>
int launch(const int8_t* x, const int8_t* w, int32_t* out, int m, int k, int n, int slices,
           int per, cudaStream_t s) {
  auto* kernel = int8_mm_kernel<A_VEC, B_VEC>;
  // above 48 KB a kernel's dynamic shared memory must be allowed first
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)((n + kBN - 1) / kBN),
                  (unsigned)slices);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(x, w, out, m, k, n, per);
  return (int)cudaGetLastError();
}

}  // namespace

// out [M, N] int32 = x [M, K] int8 @ w [K, N] int8, all contiguous.
// Returns cudaGetLastError() after the launch (with split-K, after the
// output is zeroed and the kernel launched).
extern "C" int ptt_int8_matmul(const void* x, const void* w, void* out, int m, int k, int n,
                               void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || (n + kBN - 1) / kBN > 65535) return (int)cudaErrorInvalidValue;
  int slices, per;
  plan(m, k, n, &slices, &per);
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slices > 1) {
    const cudaError_t e = cudaMemsetAsync(op, 0, (size_t)m * n * sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
  }
  const bool a_vec = k % 16 == 0 && reinterpret_cast<uintptr_t>(xp) % 16 == 0;
  const bool b_vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0;
  auto* run = a_vec ? (b_vec ? launch<true, true> : launch<true, false>)
                    : (b_vec ? launch<false, true> : launch<false, false>);
  return run(xp, wp, op, m, k, n, slices, per, s);
}

// The split-K plan ptt_int8_matmul makes for [m, k] @ [k, n]: slices and
// slabs a slice.
extern "C" void ptt_int8_matmul_plan(int m, int k, int n, int* slices, int* per) {
  plan(m, k, n, slices, per);
}
