"""The conv GEMM's arithmetic and its split-K plan (``csrc/conv_bn_relu_mm.cu``,
``paddle_tpu_torch.ops.cuda.conv_bn_relu``), on the CPU.

The kernel computes ``p2 @ w2`` in 3xTF32 on the tensor cores; here that
product is emulated (``tests/test_torch_multi_tensor.py``'s ``mm_tf32``)
and held to ``chip_smoke.py``'s ``CONV_MM_RTOL`` against float64 at
ResNet-50's conv shapes, while one TF32 pass is shown to miss it. The
split-K planner is checked over ResNet-50's 33 fused products at the
serving buckets and the training batch. The CUDA kernels themselves are
held against the plain versions on the card by ``chip_smoke.py``.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from paddle_tpu_torch.ops.cuda import conv_bn_relu as tcbr  # noqa: E402
from tests.test_torch_multi_tensor import mm_tf32  # noqa: E402

torch.set_num_threads(1)

CONV_MM_RTOL = chip_smoke.CONV_MM_RTOL  # 2e-5 of the largest output


def _operands(m, k, n, seed):
    """Patches as the unit normals ``chip_smoke._conv_sets`` draws, weights
    at Kaiming scale."""
    rng = np.random.RandomState(seed)
    p2 = rng.randn(m, k).astype("f4")
    w2 = (rng.randn(k, n) * (2.0 / k) ** 0.5).astype("f4")
    return torch.from_numpy(p2), torch.from_numpy(w2)


def _rel64(got, a, b):
    want = a.double() @ b.double()
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("m,k,n", [(4096, 576, 64), (4096, 147, 64), (1000, 147, 70)])
def test_3xtf32_conv_product_stays_within_the_limit_and_tf32_does_not(m, k, n):
    """Layer1's 3x3 conv (K = 576), the stem (K = 147) and the ragged check
    (N = 70): 3xTF32 within ``CONV_MM_RTOL`` of float64, one TF32 pass
    beyond it."""
    p2, w2 = _operands(m, k, n, seed=k + n)
    err3 = _rel64(mm_tf32(p2, w2, 3), p2, w2)
    err1 = _rel64(mm_tf32(p2, w2, 1), p2, w2)
    assert err3 <= CONV_MM_RTOL, (err3, err1)
    assert err1 > CONV_MM_RTOL, (err3, err1)


@pytest.mark.parametrize("m,k,n", [(49, 4608, 512), (196, 2304, 256)])
def test_split_k_emulated_stays_within_the_limit(m, k, n):
    """The split path at layer4's and layer3's deepest bucket-1 products:
    each slice's 3xTF32 product, the slices added in slice order, stays
    within ``CONV_MM_RTOL`` of float64."""
    slices, per = tcbr._split_k(m, k, n)
    assert slices > 1
    p2, w2 = _operands(m, k, n, seed=3)
    depth = per * tcbr._SLAB
    parts = [mm_tf32(p2[:, z * depth:(z + 1) * depth], w2[z * depth:(z + 1) * depth], 3)
             for z in range(slices)]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    assert _rel64(total, p2, w2) <= CONV_MM_RTOL


# -- the split-K plan -----------------------------------------------------------


def _tiles(m, n):
    return -(-m // tcbr._TILE_ROWS) * -(-n // tcbr._TILE_COLS)


@pytest.mark.parametrize("batch", [1, 8, 32, 128])
def test_split_k_plan_over_resnet50_products(batch):
    """Over the 33 fused products: batch 128 never splits; every slice is a
    whole number of slabs and none is empty; layer4 at batch 1 gets at least
    8 slices; tiles x slices reach a wave where K allows it."""
    products = chip_smoke._rn50_fused_products(batch)
    assert len(products) == 33
    for m, k, n in products:
        slices, per = tcbr._split_k(m, k, n)
        slabs = -(-k // tcbr._SLAB)
        assert slices >= 1 and per >= 1
        assert (slices - 1) * per < slabs <= slices * per, (m, k, n, slices, per)
        tiles = _tiles(m, n)
        if tiles >= tcbr._WAVE:
            assert slices == 1
        else:
            deepest = -(-slabs // tcbr._MIN_SLICE_SLABS)
            assert tiles * slices >= tcbr._WAVE or slices == deepest, (m, k, n, slices)
        if batch == 128:
            assert slices == 1
        if batch == 1 and n == 512:
            assert slices >= 8, (m, k, n, slices)


def test_split_k_plan_keeps_one_slice_when_the_tiles_fill_the_card():
    assert tcbr._split_k(401408, 576, 64) == (1, 18)
    assert tcbr._split_k(tcbr._TILE_ROWS * tcbr._WAVE, 4608, 64) == (1, 144)
    assert tcbr._split_k(1, 1, 1) == (1, 1)


def test_wrapper_constants_mirror_the_kernel_source():
    """The wrapper's tile rows and columns and slab depth are the C source's
    ``kBM``, ``kBN`` and ``kBK``."""
    src = open(os.path.join(os.path.dirname(tcbr.__file__), "..", "..", "csrc",
                            "conv_bn_relu_mm.cu")).read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kBM"]) == tcbr._TILE_ROWS
    assert int(consts["kBN"]) == tcbr._TILE_COLS
    assert int(consts["kBK"]) == tcbr._SLAB


def test_smoke_products_are_the_models(monkeypatch):
    """``chip_smoke._rn50_fused_products`` lists the products the port's
    ResNet-50 sends through ``mm_affine_relu``, in order."""
    from paddle_tpu_torch.models import resnet50

    seen = []
    plain = tcbr.mm_affine_relu

    def record(p2, w2, scale, shift):
        seen.append((p2.shape[0], p2.shape[1], w2.shape[1]))
        return plain(p2, w2, scale, shift)

    model = resnet50(num_classes=10, generator=torch.Generator().manual_seed(0)).eval()
    monkeypatch.setattr(tcbr, "mm_affine_relu", record)
    with torch.no_grad():
        model(torch.zeros(2, 3, 64, 64))
    assert seen == chip_smoke._rn50_fused_products(2, hw=64)


def test_cpu_calls_count_no_split():
    p2, w2 = _operands(196, 2304, 256, seed=1)
    assert tcbr._split_k(196, 2304, 256)[0] > 1
    before = (tcbr.MM_AFFINE_RELU_SPLITS, tcbr.MM_AFFINE_RELU_LAUNCHES)
    v = torch.ones(256)
    tcbr.mm_affine_relu(p2, w2, v, v)
    assert (tcbr.MM_AFFINE_RELU_SPLITS, tcbr.MM_AFFINE_RELU_LAUNCHES) == before
