// Conv-as-matmul with a fused batch-norm epilogue in bf16, for Hopper (sm_90a).
//
// Replaces the bf16 forms of paddle_tpu/ops/pallas/conv_bn_relu.py
// _mm_affine_relu (eval: y = relu(bf16(p2 @ w2) * scale + shift), rounded to
// bf16, the pre-activation never stored) and _mm_stats (training: co =
// bf16(p2 @ w2) plus per-tile float32 channel sums of the rounded co). p2
// [M, K] are the conv's patches (or its channels-last input for a 1x1
// stride-1 conv) and w2 [K, N] its weight, N = Cout, both bf16 and row-major;
// w2's rows are ldb >= N elements apart; scale and shift are float32.
//
// Bound on the H100: device memory. At layer1's 3x3 conv at batch 128
// ([401408, 576] @ [576, 64]) reading p2 once takes 0.138 ms at 3.35 TB/s and
// the products 0.030 ms at bf16's 989 TFLOP/s: the kernel has to keep p2's
// bytes streaming, with as few instructions of its own as it can.
//
// Design (the helpers are wgmma_attention.cuh's): persistent blocks, one an
// SM, each walking work items (an output tile, or one K slice of it under
// split-K) blockIdx.x, + gridDim.x, ...; the items of a row block's column
// tiles and slices are adjacent, so tiles that read the same p2 rows run
// close together in time. A producer warp issues TMA loads of 64-deep K
// slabs into a ring of kStages stages: p2's rows as they lie (K-major, the
// 128-byte swizzle; rows past M and columns past K load as zeros) and w2's
// slab as 64-column panels (MN-major, read by wgmma with imm-trans-b = 1,
// one product spanning the panels through the descriptor's leading byte
// offset). Each stage completes on an mbarrier; two consumer warpgroups
// issue m64nWN k16 wgmma products with float32 sums straight from the ring
// and release a stage when its products are done, so the producer runs up
// to kStages slabs ahead, across items: one tile's epilogue overlaps the
// next tile's loads. A consumer warpgroup owns 128 rows (two m64 products
// sharing each w2 step) and WN = 64 or 128 columns; a tile is the two one
// above the other (256 x WN, N <= 128) or side by side (128 x 2WN, wider
// N), so a tile covers all of ResNet-50's N = 64, 128 and 256 and p2
// streams from device memory once (N = 512 is two column tiles, adjacent).
// A warpgroup stages its bf16 output in shared memory (128-byte swizzled,
// so a warp's pairs fall on 32 distinct banks) and one thread stores it by
// TMA: the output leaves in whole lines, where a thread's own pair stores
// would touch 8 rows an instruction (an epilogue of several microseconds
// an item on the H100, longer than a 64-deep item's loads).
// The producer and the consumers split the registers by setmaxnreg.
//
// Rounding, as the TPU kernels round: the float32 sums are rounded to bf16
// once (co); the channel sums add the rounded values in float32; the affine
// rounds as __fmul_rn then __fadd_rn on the rounded co, then relu, then bf16.
//
// Epilogues (a template parameter); a consumer thread holds rows 16w + g
// (+ 8) of each of its m64 products at columns 8n + 2t (+ 1), w its warp in
// the warpgroup, lane = 4g + t:
//   kAffineRelu: y = bf16(relu(bf16(acc) * scale + shift));
//   kStats:      co = bf16(acc), and one [ceil(M / 128), N] row of float32
//                channel sums of the stored co per 128 output rows (rows >=
//                M masked): a thread adds its 4 rows of a column, the 8 row
//                groups of a warp meet by shuffles, the warpgroup's 4 warps
//                in shared memory, in warp order. No atomics, and the order
//                is the tile's own, so the sums repeat bit for bit whatever
//                block takes the tile;
//   kPartial:    split-K (eval only, every item in one wave: tiles x S <=
//                the blocks): an item's slice z multiplies slabs [z *
//                slice_slabs, (z + 1) * slice_slabs) and stores its raw
//                float32 sums (staged in the ring, which its one item no
//                longer reads, and written out in whole lines) in slice z
//                of an [S, M, N] workspace; once all S slices of a
//                warpgroup's rows have arrived (a counter in device
//                memory, acquired; the launch is cooperative, so all
//                slices are resident at once), slice z's warpgroup takes its
//                share of those rows and adds the S slices in slice order,
//                rounds the sum to bf16 and applies the affine + relu: one
//                reduce, in the same launch, the order fixed whatever block
//                arrives last. The last warpgroup out sets the counters back
//                to 0 for the next launch.
//
// TMA needs 16-byte row strides: K must be a multiple of 8 (the wrapper pads
// K with zero columns in the lowering; the stem's 147 becomes 152, one
// partial slab past two whole ones) and ldb a multiple of 8 (the wrapper
// pads w2's rows).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma_attention.cuh"

namespace {

constexpr int kBK = 64;          // depth of one slab: one 128-byte swizzled row of p2
constexpr int kWgRows = 128;     // rows a consumer warpgroup owns
constexpr int kMT = kWgRows / 64;  // m64 products a consumer warpgroup issues a k16 step
constexpr int kTileRows = 128;   // output rows of one row of channel sums: a warpgroup's
constexpr int kBlocksPerSm = 1;  // persistent blocks an SM
constexpr int kPanel = 64 * kBK;  // elements of one [kBK][64] panel of w2

static_assert(kTileRows == kWgRows, "a warpgroup writes its own rows of channel sums");

enum Epilogue { kAffineRelu = 0, kStats = 1, kPartial = 2 };

// a block's output tile: two consumer warpgroups of kWgRows x WN, one above
// the other, or side by side
template <int WN, bool kSide>
struct Tile {
  static constexpr int kBM = kSide ? kWgRows : 2 * kWgRows;
  static constexpr int kBN = kSide ? 2 * WN : WN;
  static constexpr int kPanels = kBN / 64;
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBK * kBN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = WN == 64 ? 4 : 3;  // slabs in the ring
  // a warpgroup's output staged for its TMA store: WN / 64 panels of
  // [kWgRows][64] bf16, 128-byte swizzled
  static constexpr int kStageOut = kWgRows * WN;
  // the ring, the two warpgroups' staged outputs, their column sums
  // ([2][4][WN] float) and affine vectors ([2][2][WN] float), the barriers,
  // and room to align the ring to 1024
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 2 * kStageOut * 2 +
                                  2 * 6 * WN * sizeof(float) + 2 * kStages * 8;
  // kPartial stages a warpgroup's float32 sums, rows kWgRows x (WN + 4), in
  // the ring, which its one item no longer reads
  static constexpr int kPartialLd = WN + 4;
  static_assert(WN == 64 || WN == 128, "warpgroup widths 64 and 128");
  static_assert(kSmem <= 232448, "a block's shared memory");
  static_assert(2 * kWgRows * kPartialLd * 4 <= kStages * kStageBytes, "partials fit the ring");
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the batch-norm pre-activation rounded as the plain version rounds it, then relu
__device__ __forceinline__ float affine_relu(float x, float scale, float shift) {
  return fmaxf(__fadd_rn(__fmul_rn(x, scale), shift), 0.f);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// the 256 consumer threads meet
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup wg meet (barrier 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <int WN>
__device__ __forceinline__ void product(float (&d)[WN / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (WN == 128) {
    wgmma_ss_n128<1>(d, a, b, acc);
  } else {
    wgmma_ss_n64<1>(d, a, b, acc);
  }
}

// out [M, N] (float32 slice z of the workspace for kPartial, bf16
// otherwise) of p2 [M, K] @ w2 [K, N]; items = m_tiles * n_tiles * slices;
// kPartial writes y and keeps its counters (2 a warpgroup's rows of a tile)
// in `counters`.
// `staged`: the bf16 output goes through shared memory and TMA stores of
// to's boxes (N a multiple of 8, so its rows lie 16-byte multiples apart),
// else each thread stores its own pairs.
template <int EPI, int WN, bool kSide>
__global__ void __launch_bounds__(kThreads, 1)
    conv_mm_bf16_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb,
                        const __grid_constant__ CUtensorMap to, int64_t m, int k, int n,
                        int slice_slabs, int slices, int n_tiles, int items, int staged,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        void* __restrict__ out, float* __restrict__ partial,
                        bf16* __restrict__ y, int* __restrict__ counters) {
  using T = Tile<WN, kSide>;
  constexpr int kStages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  bf16* staging = reinterpret_cast<bf16*>(ring + kStages * T::kStageBytes);  // [2][kStageOut]
  float* sums = reinterpret_cast<float*>(staging + 2 * T::kStageOut);       // [2][4][WN]
  float* vecs = sums + 2 * 4 * WN;                                           // [2][2][WN]
  uint64_t* full = reinterpret_cast<uint64_t*>(vecs + 2 * 2 * WN);
  uint64_t* empty = full + kStages;
  const int slabs = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);                  // the producer's arrival, then the bytes
      mbar_init(&empty[i], 4 * kConsumers);    // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == kConsumers) {
    // -- producer: one thread keeps the ring full, item after item ---------------------
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&ta)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tb)) : "memory");
      int sc = 0;  // slabs issued
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int z = item % slices, tn = item / slices % n_tiles, tm = item / slices / n_tiles;
        const int s1 = min(slabs, (z + 1) * slice_slabs);
        for (int s = z * slice_slabs; s < s1; ++s, ++sc) {
          const int st = sc % kStages;
          mbar_wait(&empty[st], ((sc / kStages) & 1) ^ 1);  // the stage's last slab released
          uint8_t* a_s = ring + st * T::kStageBytes;
          bf16* b_s = reinterpret_cast<bf16*>(a_s + T::kABytes);
          mbar_arrive_tx(&full[st], T::kStageBytes);
          tma_load_2d(a_s, &ta, &full[st], s * kBK, tm * T::kBM);
#pragma unroll
          for (int p = 0; p < T::kPanels; ++p)
            tma_load_2d(b_s + p * kPanel, &tb, &full[st], tn * T::kBN + 64 * p, s * kBK);
        }
      }
    }
    return;
  }

  // -- consumers: kWgRows x WN a warpgroup ---------------------------------------------
  regs_inc<kConsumerRegs>();
  const int w = (threadIdx.x / 32) % 4, g = lane >> 2, t = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;  // issues the warpgroup's TMA stores
  float* wsum = sums + wg * 4 * WN;  // this warpgroup's [4][WN] column sums
  float* wvec = vecs + wg * 2 * WN;  // this warpgroup's columns of scale, then shift
  uint8_t* out_s = reinterpret_cast<uint8_t*>(staging + wg * T::kStageOut);
  float* part_s = reinterpret_cast<float*>(ring) + wg * kWgRows * T::kPartialLd;
  float acc[kMT][WN / 2];
  int sc = 0;  // slabs consumed
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int z = item % slices, tn = item / slices % n_tiles, tm = item / slices / n_tiles;
    const int s0 = z * slice_slabs, s1 = min(slabs, s0 + slice_slabs);
    const int64_t row0 = (int64_t)tm * T::kBM + (kSide ? 0 : wg * kWgRows);  // this warpgroup's
    const int col0 = tn * T::kBN + (kSide ? wg * WN : 0);
    if (EPI != kStats) {  // read while the products run; the epilogue's barrier orders them
      const int c = threadIdx.x % 128;
      if (c < WN) {
        wvec[c] = col0 + c < n ? __ldg(scale + col0 + c) : 0.f;
        wvec[WN + c] = col0 + c < n ? __ldg(shift + col0 + c) : 0.f;
      }
    }
    for (int s = s0; s < s1; ++s, ++sc) {
      const int st = sc % kStages;
      mbar_wait(&full[st], (sc / kStages) & 1);
      const bf16* a_s = reinterpret_cast<const bf16*>(ring + st * T::kStageBytes) +
                        (kSide ? 0 : wg * kWgRows * kBK);
      const bf16* b_s = reinterpret_cast<const bf16*>(ring + st * T::kStageBytes + T::kABytes) +
                        (kSide ? wg * (WN / 64) * kPanel : 0);
#pragma unroll
      for (int i = 0; i < kMT; ++i) reg_fence(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = desc_mn(b_s + kk * 16 * 64, kPanel * 2);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          product<WN>(acc[i], desc<128>(a_s + i * 64 * kBK + kk * 16), db, s > s0 || kk > 0);
      }
      wgmma_commit();
      if (s > s0) {  // the previous slab's products are done: release its stage
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(sc - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kMT; ++i) reg_fence(acc[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(sc - 1) % kStages]);
    if (EPI == kPartial) consumers_sync();  // both warpgroups are done reading the ring

    // epilogue: entry 4j + 2h + e of acc[i] is row row0 + 64i + 16w + 8h + g,
    // column col0 + 8j + 2t + e. Staged, the pair goes to the staging panel
    // j / 8, row 64i + 16w + 8h + g, 16-byte chunk (j % 8) ^ g (the 128-byte
    // swizzle: the 8 row groups of a store land on 8 distinct chunks), and
    // the TMA store clips rows past M and columns past N.
    if (staged && leader) bulk_wait_read<0>();  // the last item's stores have read the staging
    wg_sync(wg);  // ... and every thread is done with its column sums
    const bool pairs = n % 2 == 0;  // pair stores stay aligned
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      const int c = col0 + 8 * j + 2 * t;
      float sc0 = 0.f, sc1 = 0.f, sh0 = 0.f, sh1 = 0.f;
      if (EPI == kAffineRelu) {
        const float2 sc2 = *reinterpret_cast<const float2*>(wvec + 8 * j + 2 * t);
        const float2 sh2 = *reinterpret_cast<const float2*>(wvec + WN + 8 * j + 2 * t);
        sc0 = sc2.x, sc1 = sc2.y, sh0 = sh2.x, sh1 = sh2.y;
      }
      float cs0 = 0.f, cs1 = 0.f;  // kStats: this thread's rows of columns c, c + 1
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = 64 * i + 16 * w + 8 * h + g;  // the row within the warpgroup's
          const int64_t r = row0 + rr;
          const float x0 = acc[i][4 * j + 2 * h], x1 = acc[i][4 * j + 2 * h + 1];
          if (EPI == kPartial) {
            *reinterpret_cast<float2*>(part_s + rr * T::kPartialLd + 8 * j + 2 * t) =
                make_float2(x0, x1);
            continue;
          }
          float v0 = round_bf16(x0), v1 = round_bf16(x1);
          if (EPI == kStats) {
            if (r < m) {
              cs0 += v0;
              cs1 += v1;
            }
          } else {
            v0 = affine_relu(v0, sc0, sh0);
            v1 = affine_relu(v1, sc1, sh1);
          }
          if (staged) {
            *reinterpret_cast<uint32_t*>(out_s + (j / 8) * kWgRows * 128 + rr * 128 +
                                         (((j % 8) ^ g) << 4) + 4 * t) = pack_bf16(v0, v1);
          } else if (r < m && c < n) {
            bf16* dst = static_cast<bf16*>(out) + r * n + c;
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
            } else {
              dst[0] = __float2bfloat16_rn(v0);
              if (c + 1 < n) dst[1] = __float2bfloat16_rn(v1);
            }
          }
        }
      if (EPI == kStats) {
        // the 8 row groups of the warp hold the same columns (lanes t, t + 4, ...)
#pragma unroll
        for (int d = 4; d < 32; d *= 2) {
          cs0 += __shfl_xor_sync(0xffffffffu, cs0, d);
          cs1 += __shfl_xor_sync(0xffffffffu, cs1, d);
        }
        if (g == 0) {
          wsum[w * WN + 8 * j + 2 * t] = cs0;
          wsum[w * WN + 8 * j + 2 * t + 1] = cs1;
        }
      }
    }
    if (EPI == kPartial) {
      // this slice's staged sums out to slice z of the workspace, whole lines
      // a warp, then count it in and wait for every slice of the rows
      wg_sync(wg);
      float* slice = static_cast<float*>(out) + (int64_t)z * m * n;
      for (int e = threadIdx.x % 128; e < kWgRows * (WN / 4); e += 128) {
        const int rr = e / (WN / 4), cc = 4 * (e % (WN / 4));
        const int64_t r = row0 + rr;
        const int c = col0 + cc;
        if (r >= m || c >= n) continue;
        const float4 v = *reinterpret_cast<const float4*>(part_s + rr * T::kPartialLd + cc);
        float* dst = slice + r * n + c;
        if (n % 4 == 0) {
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          const float vs[4] = {v.x, v.y, v.z, v.w};
          for (int q = 0; q < 4 && c + q < n; ++q) dst[q] = vs[q];
        }
      }
      __threadfence();
      wg_sync(wg);
      int* arrived = counters + 2 * ((tm * n_tiles + tn) * 2 + wg);
      if (leader) {
        atomicAdd(arrived, 1);
        // the launch is cooperative, so every slice runs at once; a slice
        // still missing after ~2^32 cycles is a fault, trapped, not a hang
        const long long start = clock64();
        while (load_acquire(arrived) < slices) {
          __nanosleep(64);
          if (clock64() - start > (1ll << 32)) __trap();
        }
      }
      wg_sync(wg);
      // rows [r_lo, r_hi) of the warpgroup's, 4 columns a thread at a time:
      // the S slices in slice order, 8 loads in flight
      const float* ws = static_cast<const float*>(out);
      const int64_t plane = m * (int64_t)n;
      const int share = (kWgRows + slices - 1) / slices;
      const int r_lo = min(kWgRows, z * share), r_hi = min(kWgRows, r_lo + share);
      for (int e = threadIdx.x % 128; e < (r_hi - r_lo) * (WN / 4); e += 128) {
        const int64_t r = row0 + r_lo + e / (WN / 4);
        const int cc = 4 * (e % (WN / 4)), c = col0 + cc;
        if (r >= m || c >= n) continue;
        const float* src = ws + r * n + c;
        if (n % 4 == 0) {  // c + 3 < n, and 16-byte loads stay aligned
          float4 v = __ldcg(reinterpret_cast<const float4*>(src));
#pragma unroll 8
          for (int zz = 1; zz < slices; ++zz) {
            const float4 u = __ldcg(reinterpret_cast<const float4*>(src + zz * plane));
            v.x += u.x;
            v.y += u.y;
            v.z += u.z;
            v.w += u.w;
          }
          const float* sc = wvec + cc;
          const float* sh = wvec + WN + cc;
          *reinterpret_cast<uint2*>(y + r * n + c) = make_uint2(
              pack_bf16(affine_relu(round_bf16(v.x), sc[0], sh[0]),
                        affine_relu(round_bf16(v.y), sc[1], sh[1])),
              pack_bf16(affine_relu(round_bf16(v.z), sc[2], sh[2]),
                        affine_relu(round_bf16(v.w), sc[3], sh[3])));
        } else {
          for (int q = 0; q < 4 && c + q < n; ++q) {
            float v = __ldcg(src + q);
#pragma unroll 8
            for (int zz = 1; zz < slices; ++zz) v += __ldcg(src + zz * plane + q);
            y[r * n + c + q] = __float2bfloat16_rn(
                affine_relu(round_bf16(v), wvec[cc + q], wvec[WN + cc + q]));
          }
        }
      }
      wg_sync(wg);
      if (leader && atomicAdd(arrived + 1, 1) == slices - 1) {  // the last one out
        arrived[0] = 0;
        arrived[1] = 0;
      }
      continue;
    }
    if (staged) fence_async_shared();  // the staged pairs visible to the TMA unit
    wg_sync(wg);  // the warpgroup's pairs are staged and its 4 warps' sums written
    if (EPI == kStats) {
      const int c = threadIdx.x % 128;
      if (c < WN && col0 + c < n && row0 < m) {
        const float s = ((wsum[c] + wsum[WN + c]) + wsum[2 * WN + c]) + wsum[3 * WN + c];
        partial[row0 / kTileRows * n + col0 + c] = s;
      }
    }
    if (staged && leader) {
#pragma unroll
      for (int p = 0; p < WN / 64; ++p)
        tma_store_2d(&to, out_s + p * kWgRows * 128, col0 + 64 * p, (int)row0);
      bulk_commit();
    }
  }
  if (staged && leader) bulk_wait_read<0>();  // the staging outlives the stores' reads
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

struct Args {
  const void *a, *b, *scale, *shift;
  void *out, *partial, *y, *counters;
  int64_t m;
  int k, n, ldb, slices, slice_slabs;
};

template <int EPI, int WN, bool kSide>
int launch_tile(const Args& x, cudaStream_t stream) {
  using T = Tile<WN, kSide>;
  CUtensorMap ta, tb, to;
  const int staged = EPI != kPartial && x.n % 8 == 0;
  int e = tensor_map_2d(&ta, x.a, x.m, x.k, x.k, kBK, T::kBM);
  if (e == 0) e = tensor_map_2d(&tb, x.b, x.k, x.n, x.ldb, 64, kBK);
  if (e == 0) e = staged ? tensor_map_2d(&to, x.out, x.m, x.n, x.n, 64, kWgRows) : 0;
  if (e != 0) return e;
  auto* kernel = conv_mm_bf16_kernel<EPI, WN, kSide>;
  // above 48 KB a kernel's dynamic shared memory must be allowed first
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int64_t m_tiles = (x.m + T::kBM - 1) / T::kBM;
  const int n_tiles = (x.n + T::kBN - 1) / T::kBN;
  const int64_t items = m_tiles * n_tiles * x.slices;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int blocks = (int)std::min<int64_t>(items, (int64_t)kBlocksPerSm * sm_count());
  if (EPI == kPartial && items > blocks) return (int)cudaErrorInvalidValue;  // one wave
  // kPartial waits for every slice of a tile in the same launch: launched
  // cooperatively, its blocks are all resident at once, or it is refused
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = stream;
  cfg.attrs = coop;
  cfg.numAttrs = EPI == kPartial ? 1 : 0;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, kernel, ta, tb, staged ? to : ta, x.m, x.k, x.n, x.slice_slabs, x.slices, n_tiles,
      (int)items, staged, static_cast<const float*>(x.scale), static_cast<const float*>(x.shift),
      x.out, static_cast<float*>(x.partial), static_cast<bf16*>(x.y),
      static_cast<int*>(x.counters));
  return (int)(launched != cudaSuccess ? launched : cudaGetLastError());
}

// the tile for N (the wrapper's _bf16_tile mirrors it)
template <int EPI>
int launch(const Args& x, cudaStream_t stream) {
  // TMA: bases on 16 bytes, row strides (K, ldb) multiples of 8 elements
  if (x.m <= 0 || x.k <= 0 || x.n <= 0 || x.k % 8 != 0 || x.ldb % 8 != 0 || x.ldb < x.n ||
      x.m > 0x7fffffff || !aligned16(x.a) || !aligned16(x.b) || !aligned16(x.out))
    return (int)cudaErrorInvalidValue;
  if (x.n <= 64) return launch_tile<EPI, 64, false>(x, stream);
  if (x.n <= 128) return launch_tile<EPI, 128, false>(x, stream);
  return launch_tile<EPI, 128, true>(x, stream);
}

}  // namespace

// y [M, N] bf16 = relu(bf16(a [M, K] @ b [K, N]) * scale [N] + shift [N]);
// b's rows ldb elements apart. a, b and y 16-byte aligned, K and ldb
// multiples of 8 (else cudaErrorInvalidValue). Returns cudaGetLastError()
// after the launch (or the error of encoding a tensor map).
extern "C" int ptt_conv_mm_bf16_affine_relu(const void* a, const void* b, const void* scale,
                                            const void* shift, void* y, int64_t m, int k, int n,
                                            int ldb, void* stream) {
  const int slabs = (k + kBK - 1) / kBK;
  return launch<kAffineRelu>({a, b, scale, shift, y, nullptr, nullptr, nullptr, m, k, n, ldb, 1,
                              slabs},
                             static_cast<cudaStream_t>(stream));
}

// The same y through split-K: `slices` slices of `slice_slabs` 64-deep slabs
// of K each (the last one shorter, none empty) into the float32 ws [slices,
// M, N], then, in the same launch, the ordered sum, its rounding to bf16 and
// the affine + relu. Every work item must fit one wave (tiles x slices <=
// the card's persistent blocks), else cudaErrorInvalidValue. counters: 4
// int32 a tile (2 a warpgroup), zero, and zero again when the launch ends;
// one launch at a time may use them.
extern "C" int ptt_conv_mm_bf16_affine_relu_split(const void* a, const void* b,
                                                  const void* scale, const void* shift, void* y,
                                                  void* ws, void* counters, int64_t m, int k,
                                                  int n, int ldb, int slices, int slice_slabs,
                                                  void* stream) {
  const int slabs = (k + kBK - 1) / kBK;
  if (slices < 1 || slice_slabs < 1 || (slices - 1) * slice_slabs >= slabs || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  return launch<kPartial>({a, b, scale, shift, ws, nullptr, y, counters, m, k, n, ldb, slices,
                           slice_slabs},
                          static_cast<cudaStream_t>(stream));
}

// co [M, N] bf16 = bf16(a @ b), and the float32 partial [ceil(M / 128), N]
// holding each 128-row tile's column sums of the rounded co. Returns
// cudaGetLastError() after the launch.
extern "C" int ptt_conv_mm_bf16_stats(const void* a, const void* b, void* co, void* partial,
                                      int64_t m, int k, int n, int ldb, void* stream) {
  const int slabs = (k + kBK - 1) / kBK;
  return launch<kStats>({a, b, nullptr, nullptr, co, partial, nullptr, nullptr, m, k, n, ldb, 1,
                         slabs},
                        static_cast<cudaStream_t>(stream));
}

// Rows of one partial-sum tile, for the wrapper's allocation.
extern "C" int ptt_conv_mm_bf16_tile_rows() { return kTileRows; }
