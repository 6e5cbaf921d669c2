#!/usr/bin/env python3
"""The bf16 conv GEMM's split-K plans against every split, on one NVIDIA card (H100).

    python3 tools/conv_mm_bf16_splits.py

For each distinct fused conv product of a ResNet-50 forward at serving
batches 1, 8 and 32 (K padded to a multiple of 8, as the bf16 lowering gives
it), ``mm_affine_relu`` (``csrc/conv_bn_relu_mm_bf16.cu``) is timed unsplit
and at the splits that fit one wave of the kernel's persistent blocks
(slices of 1, 2, 4 slabs and of a half, a quarter and an eighth of K), with
each output held to 2 bf16 ulps of the plain version's largest; beside it
bf16 ``torch.matmul`` on the same operands and the plan
``conv_bn_relu._split_k_bf16`` picks. Device time behind a sleep kernel
(``chip_smoke.device_ms``), 20 calls each. The planner's constants
(``_BF16_ITEM_SLABS``, ``_BF16_REDUCE_SLABS``, ``_BF16_SPLIT_SHARE``) are
read off this table. One line per product on stdout, ``SPLIT b<batch> [M, K,
N] tiles <n> plan (slices, slabs) lib <ms> | (slices, slabs) <ms> ...``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops.cuda import _build  # noqa: E402
from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("CUDA is not available: this script runs only on the card", file=sys.stderr)
        return 2
    _build.build_all(["conv_bn_relu_mm_bf16"])
    g = torch.Generator(device="cuda").manual_seed(3)
    sms = cbr._sm_count(0)
    plan = cbr._split_k_bf16
    seen = set()
    try:
        for batch in (1, 8, 32):
            for m, k, n in cs._rn50_fused_products_bf16(batch):
                if (m, k, n) in seen:
                    continue
                seen.add((m, k, n))
                args = cs._conv_sets_bf16(g, m, k, n, 1)[0]
                bm, bn = cbr._bf16_tile(n)
                tiles = -(-m // bm) * -(-n // bn)
                slabs = -(-k // cbr._BF16_SLAB)
                row = []
                for per in sorted({slabs, -(-slabs // 2), -(-slabs // 4), -(-slabs // 8), 4, 2,
                                   1}, reverse=True):
                    slices = -(-slabs // per)
                    if per > slabs or (slices > 1 and tiles * slices > sms):
                        continue
                    cbr._split_k_bf16 = lambda *_, s=slices, p=per: (s, p)
                    ulps = cs._ulps(cbr.mm_affine_relu(*args), cbr._mm_affine_relu_plain(*args))
                    if ulps > cs.CONV_BF16_Y_ULPS:
                        raise AssertionError(f"[{m}, {k}, {n}] split ({slices}, {per}): {ulps} "
                                             "ulps")
                    ms = cs.device_ms(lambda: cbr.mm_affine_relu(*args), 20)[0]
                    row.append(f"({slices},{per}) {ms:.4f}")
                cbr._split_k_bf16 = plan
                lib = cs.device_ms(lambda: torch.matmul(args[0], args[1]), 20)[0]
                print(f"SPLIT b{batch} [{m},{k},{n}] tiles {tiles} plan {plan(m, k, n, sms)} "
                      f"lib {lib:.4f} | " + " ".join(row), flush=True)
    finally:
        cbr._split_k_bf16 = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
