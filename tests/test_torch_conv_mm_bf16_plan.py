"""The bf16 conv GEMM's tiles and split-K plan (``csrc/conv_bn_relu_mm_bf16.cu``,
``paddle_tpu_torch.ops.cuda.conv_bn_relu``), on the CPU.

The bf16 GEMM has its own plan, apart from the float32 GEMM's
(``tests/test_torch_conv_mm_tf32.py`` holds that one unchanged): tiles of
two consumer warpgroups of 128 rows by 64 or 128 columns, 64-deep slabs,
one persistent block an SM, and split-K only within one wave of those
blocks, because the split's reduce waits for every slice of a tile in the
same launch. Here the wrapper's constants are held against the C source,
the plan is checked over ResNet-50's 33 fused products at the serving
buckets and the training batch, and a split's slices, added in slice order
and rounded once, are emulated against the plain version. The kernel itself
is held against the plain version on the card by ``chip_smoke.py``.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from paddle_tpu_torch.ops.cuda import conv_bn_relu as tcbr  # noqa: E402

torch.set_num_threads(1)

SMS = 132  # the H100's SMs
_SRC = os.path.join(os.path.dirname(tcbr.__file__), "..", "..", "csrc",
                    "conv_bn_relu_mm_bf16.cu")


def _source():
    with open(_SRC) as f:
        return f.read()


def test_wrapper_constants_mirror_the_kernel_source():
    """Slab depth, a warpgroup's rows (also the rows of one row of channel
    sums) and the persistent blocks an SM are the C source's."""
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", _source()))
    assert int(consts["kBK"]) == tcbr._BF16_SLAB
    assert int(consts["kWgRows"]) == tcbr._BF16_WG_ROWS
    assert int(consts["kTileRows"]) == tcbr._BF16_WG_ROWS
    assert int(consts["kBlocksPerSm"]) == tcbr._BF16_BLOCKS_PER_SM


def test_tile_for_n_mirrors_the_kernel_launch():
    """``_bf16_tile`` picks the tile the C source's ``launch`` picks: the
    warpgroups one above the other (256 rows) up to N = 128, side by side
    (128 rows, 256 columns) past it."""
    src = _source()
    rules = re.findall(r"if \(x\.n <= (\d+)\) return launch_tile<EPI, (\d+), (true|false)>", src)
    last = re.search(r"\n  return launch_tile<EPI, (\d+), (true|false)>", src)
    assert rules and last
    cases = [(int(lim), int(wn), side == "true") for lim, wn, side in rules]
    for n in (1, 37, 64, 65, 70, 128, 129, 256, 512, 1000):
        wn, side = next(((wn, side) for lim, wn, side in cases if n <= lim),
                        (int(last.group(1)), last.group(2) == "true"))
        rows = tcbr._BF16_WG_ROWS * (1 if side else 2)
        assert tcbr._bf16_tile(n) == (rows, wn * (2 if side else 1)), n


def _shapes():
    out = set()
    for batch in (1, 2, 8, 32, 128):
        out.update(chip_smoke._rn50_fused_products_bf16(batch))
    out.update([(1000, 24, 37), (12345, 152, 70), (1, 8, 1), (49, 4608, 512)])
    return sorted(out)


@pytest.mark.parametrize("m,k,n", _shapes())
def test_split_plan_covers_k_and_fits_one_wave(m, k, n):
    """Every plan covers K in whole slabs with no empty slice; a split fits
    one wave of the blocks (its reduce waits for every slice of a tile in
    the same launch) on a card its tiles leave mostly empty."""
    slices, per = tcbr._split_k_bf16(m, k, n, SMS)
    slabs = -(-k // tcbr._BF16_SLAB)
    assert 1 <= per <= slabs and (slices - 1) * per < slabs <= slices * per
    bm, bn = tcbr._bf16_tile(n)
    tiles = -(-m // bm) * -(-n // bn)
    if slices > 1:
        assert tiles * slices <= SMS * tcbr._BF16_BLOCKS_PER_SM
        assert tiles * tcbr._BF16_SPLIT_SHARE <= SMS * tcbr._BF16_BLOCKS_PER_SM
    else:
        assert per == slabs


def test_split_plan_at_the_paths_shapes():
    """The training batch and the stem never split; layer4's deepest
    bucket-1 product splits into 2-slab slices, one wave of 72 blocks; a
    card with fewer SMs gets fewer slices."""
    assert tcbr._split_k_bf16(401408, 576, 64, SMS) == (1, 9)
    assert tcbr._split_k_bf16(1605632, 152, 64, SMS) == (1, 3)
    assert tcbr._split_k_bf16(6272, 4608, 512, SMS) == (1, 72)
    assert tcbr._split_k_bf16(49, 4608, 512, SMS) == (36, 2)
    assert tcbr._split_k_bf16(49, 4608, 512, 66)[0] < 36
    assert tcbr._split_k_bf16(1, 8, 1, SMS) == (1, 1)
    # the float32 plan is its own, unchanged
    assert tcbr._split_k(49, 4608, 512) != tcbr._split_k_bf16(49, 4608, 512, SMS)


@pytest.mark.parametrize("batch", [1, 8])
def test_serving_products_that_split(batch):
    """At the small serving buckets the deep products split and the shallow
    ones, whose fixed costs the split would double, do not."""
    shapes = chip_smoke._rn50_fused_products_bf16(batch)
    plans = [tcbr._split_k_bf16(m, k, n, SMS) for m, k, n in shapes]
    split = {(m, k, n) for (m, k, n), (s, _) in zip(shapes, plans) if s > 1}
    assert split, batch
    assert all(k >= 1024 for _, k, _ in split)
    assert all(s == 1 for (m, k, n), (s, _) in zip(shapes, plans) if k <= 576)


@pytest.mark.parametrize("m,k,n", [(49, 4608, 512), (196, 1024, 256), (392, 2048, 512)])
def test_split_slices_added_in_order_match_the_plain_version(m, k, n):
    """The split path's arithmetic: each slice's float32 product, the slices
    added in slice order, rounded once to bf16, then the affine and relu
    (the kernel's reduce), within 1 bf16 ulp of the plain version's largest
    output (float32 sums in another order)."""
    slices, per = tcbr._split_k_bf16(m, k, n, SMS)
    assert slices > 1
    rng = np.random.RandomState(m)
    p2 = torch.from_numpy(rng.randn(m, k).astype("f4")).bfloat16()
    w2 = torch.from_numpy((rng.randn(k, n) * (2.0 / k) ** 0.5).astype("f4")).bfloat16()
    scale = torch.from_numpy((rng.rand(n) + 0.5).astype("f4"))
    shift = torch.from_numpy((rng.randn(n) * 0.1).astype("f4"))
    depth = per * tcbr._BF16_SLAB
    acc = torch.zeros(m, n)
    for z in range(slices):
        acc += p2[:, z * depth:(z + 1) * depth].float() @ w2[z * depth:(z + 1) * depth].float()
    got = torch.relu(acc.bfloat16().float() * scale + shift).bfloat16()
    want = tcbr._mm_affine_relu_plain(p2, w2, scale, shift)
    ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    assert float((got.float() - want.float()).abs().max()) <= ulp


def test_cpu_calls_plan_nothing_and_count_no_split():
    """On the CPU the plain version runs: no split counted, no launch."""
    p2 = torch.zeros(49, 4608).bfloat16()
    w2 = torch.zeros(4608, 512).bfloat16()
    v = torch.ones(512)
    before = (tcbr.MM_AFFINE_RELU_SPLITS, tcbr.BF16_MM_AFFINE_RELU_LAUNCHES)
    tcbr.mm_affine_relu(p2, w2, v, v)
    assert (tcbr.MM_AFFINE_RELU_SPLITS, tcbr.BF16_MM_AFFINE_RELU_LAUNCHES) == before
