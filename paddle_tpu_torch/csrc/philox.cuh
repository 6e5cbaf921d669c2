// Philox4x32-10, the counter-based generator of Salmon et al., "Parallel
// random numbers: as easy as 1, 2, 3" (SC'11), as cuRAND's
// curand_Philox4x32_10 implements it: ten rounds over a 128-bit counter
// under a 64-bit key, four 32-bit words out.
//
// The attention kernels key it by the dropout seed and count by
// (key column / 4, query row, batch*head, 0): word (key column % 4) of the
// output is the 32 random bits of one (query row, key column) entry. Any
// kernel can regenerate any entry whatever its tiling, so the forward, dQ
// and dK/dV kernels drop the same entries. The plain PyTorch version
// (paddle_tpu_torch/ops/cuda/flash_attention.py philox4x32_10) computes the
// same words with integer tensor ops.
#pragma once

#include <stdint.h>

namespace ptt {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ uint32_t word(uint4 w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

}  // namespace ptt
