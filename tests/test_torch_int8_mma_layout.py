"""The int8 matmul kernel's index arithmetic and split-K plan
(``csrc/int8_matmul.cu``, ``paddle_tpu_torch.ops.cuda.int8_matmul``), on
the CPU.

The kernel cannot run here, so its data movement is emulated in numpy from
the same formulas: each slab staged as the kernel stages it (x rows ``kSA``
bytes apart, w's 16-byte chunks XOR-swizzled by row), the A fragments read
through ``ldmatrix``'s lane-to-row addressing, the B fragments read one
4-byte word a K row at the kernel's ``b_off`` and transposed by the same
``__byte_perm`` selectors, the warp's columns permuted (lane group g takes
columns 4g .. 4g + 3 as column g of its four n8 tiles), and the accumulators
written back where the epilogue writes them. The tensor-core product in
between follows PTX's documented ``mma.m16n8k32`` fragment layouts, so a
wrong address, swizzle, selector or column anywhere gives a wrong product.
The slices of the split-K plan are added into a zeroed output as the
kernel's atomics add them. Held bit for bit against the int32 product at the
int8 program's serving shapes and at ragged ones.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from paddle_tpu_torch.ops.cuda import int8_matmul as tim  # noqa: E402

BM, BN, BK = tim._TILE_ROWS, tim._TILE_COLS, tim._SLAB
KSA = BK + 16  # bytes between x rows of a stage (kSA)
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
STEPS = BK // 32  # k32 steps a slab


def _src_constants():
    src = open(os.path.join(os.path.dirname(tim.__file__), "..", "..", "csrc",
                            "int8_matmul.cu")).read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def b_chunk(r, q):
    """Where chunk q (16 bytes) of row r of a w slab sits in its stage."""
    return r * BN + ((q ^ (2 * ((r >> 2) & 3))) << 4)


def byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)`` (default mode) on uint32 arrays."""
    both = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= both[(s >> (4 * n)) & 7] << (8 * n)
    return out


def _a_offsets():
    """[warp row (2)][m16 tile i (4)][k32 step (2)][lane][register][byte]:
    the stage byte ldmatrix.x4 hands each lane. Lane l of matrix j's eight
    supplies its row r = l - 8j; a receiving lane gets bytes 4 * (lane % 4)
    .. + 3 of row lane // 4."""
    off = np.zeros((2, 4, STEPS, 32, 4, 4), np.int64)
    for wmi in range(2):
        for i in range(4):
            for kki, kk in enumerate(range(0, BK, 32)):
                for j in range(4):
                    sup = 8 * j + G  # the lane that supplied the row this lane reads
                    a_off = (64 * wmi + (sup & 15)) * KSA + (sup >> 4) * 16
                    base = a_off + 16 * i * KSA + kk + 4 * T
                    off[wmi, i, kki, :, j, :] = base[:, None] + np.arange(4)
    return off


def _b_words(stage_b, wni, kk, h):
    """The four words (K rows 4t + i, i = 0..3) a lane loads for half h of
    a k32 step: [tiles, lane, i]."""
    wn = 32 * wni
    b_off = 4 * T * BN + ((((wn + 4 * G) >> 4) ^ (2 * T)) << 4) + ((4 * G) & 15)
    words = []
    for i in range(4):
        at = (kk + 16 * h) * BN + b_off + i * BN
        b = [stage_b[:, at + e].astype(np.uint32) for e in range(4)]
        words.append(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24)
    return words


def _b_fragments(stage_b, wni, kk, h):
    """[tiles, n8 tile j, lane] words: the kernel's 4 x 4 byte transpose."""
    r0, r1, r2, r3 = _b_words(stage_b, wni, kk, h)
    lo01, hi01 = byte_perm(r0, r1, 0x5140), byte_perm(r0, r1, 0x7362)
    lo23, hi23 = byte_perm(r2, r3, 0x5140), byte_perm(r2, r3, 0x7362)
    return np.stack([byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
                     byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)], axis=1)


def _bytes(words):
    return np.stack([((words >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8)
                     for b in range(4)], axis=-1)


# PTX mma.m16n8k32 (s8) fragment layouts: A register j byte b of lane (g, t)
# is A[g + 8 * (j % 2), 16 * (j // 2) + 4t + b]; B register h byte b is
# B[16h + 4t + b, g]; C register e is C[g + 8 * (e // 2), 2t + e % 2].
_A_ROW = (G[:, None, None] + 8 * (np.arange(4)[None, :, None] % 2)) + 0 * np.arange(4)
_A_COL = 16 * (np.arange(4)[None, :, None] // 2) + 4 * T[:, None, None] + np.arange(4)
_B_ROW = 16 * np.arange(2)[None, :, None] + 4 * T[:, None, None] + np.arange(4)
_B_COL = G[:, None, None] + 0 * _B_ROW


def emulate(x, w):
    """The kernel's ``x @ w`` (int64 out) from its staging, fragments,
    permutation, epilogue and split-K plan."""
    m, k = x.shape
    n = w.shape[1]
    tr, tc = -(-m // BM), -(-n // BN)
    slices, per = tim._split_k(m, k, n)
    slabs = -(-k // BK)
    xp = np.zeros((tr * BM, slabs * BK), np.int8)
    xp[:m, :k] = x
    wp = np.zeros((slabs * BK, tc * BN), np.int8)
    wp[:k, :n] = w
    a_off = _a_offsets()
    bidx = np.array([[b_chunk(r, q) + e for q in range(BN // 16) for e in range(16)]
                     for r in range(BK)]).ravel()
    out = np.zeros((tr * BM, tc * BN), np.int64)
    # where the epilogue writes lane (g, t)'s register e of m16 tile i (row)
    # and n8 tile j (column): row wm + 16i + g + 8 * (e // 2), column wn +
    # 8t + 4 * (e % 2) + j; [tr, wmi, i, lane, e] and [tc, wni, j, lane, e]
    rows = (BM * np.arange(tr)[:, None, None, None, None] + 64 * np.arange(2)[:, None, None, None]
            + 16 * np.arange(4)[:, None, None] + G[:, None] + 8 * (np.arange(4)[None, :] // 2))
    cols = (BN * np.arange(tc)[:, None, None, None, None] + 32 * np.arange(4)[:, None, None, None]
            + np.arange(4)[:, None, None] + 8 * T[:, None] + 4 * (np.arange(4)[None, :] % 2))
    for z in range(slices):
        part = np.zeros_like(out)
        for s in range(z * per, min(slabs, (z + 1) * per)):
            kb = s * BK
            stage_a = np.zeros((tr, BM, KSA), np.int8)
            stage_a[:, :, :BK] = xp[:, kb:kb + BK].reshape(tr, BM, BK)
            stage_a = stage_a.reshape(tr, -1)
            stage_b = np.zeros((tc, BK * BN), np.uint8)
            slab = wp[kb:kb + BK].reshape(BK, tc, BN // 16, 16).transpose(1, 0, 2, 3)
            stage_b[:, bidx] = slab.reshape(tc, -1).view(np.uint8)
            # A matrices [tr, wmi, i, kk, 16, 32], B matrices [tc, wni, j, kk, 32, 8]
            frag_a = stage_a[:, a_off]
            mat_a = np.zeros((tr, 2, 4, STEPS, 16, 32), np.float64)
            mat_a[..., _A_ROW, _A_COL] = frag_a
            mat_b = np.zeros((tc, 4, 4, STEPS, 32, 8), np.float64)
            for wni in range(4):
                for kki, kk in enumerate(range(0, BK, 32)):
                    for h in range(2):
                        frag = _bytes(_b_fragments(stage_b, wni, kk, h))  # [tc, j, lane, byte]
                        sub = mat_b[:, wni, :, kki]  # a view: [tc, j, 32, 8]
                        sub[:, :, _B_ROW[:, h], _B_COL[:, h]] = frag
            a2 = mat_a.transpose(0, 1, 2, 4, 3, 5).reshape(tr * 2 * 4 * 16, BK)
            b2 = mat_b.transpose(3, 4, 0, 1, 2, 5).reshape(BK, tc * 4 * 4 * 8)
            c = (a2 @ b2).reshape(tr, 2, 4, 16, tc, 4, 4, 8).astype(np.int64)
            # lane (g, t) register e of tile (i, j): C[g + 8 * (e // 2), 2t + e % 2]
            cr = G[:, None] + 8 * (np.arange(4)[None, :] // 2)
            cc = 2 * T[:, None] + np.arange(4)[None, :] % 2
            acc = c[:, :, :, cr, :, :, :, cc]  # [lane, e, tr, wmi, i, tc, wni, j]
            acc = acc.transpose(2, 3, 4, 5, 6, 7, 0, 1)  # [tr, wmi, i, tc, wni, j, lane, e]
            r_idx = rows[:, :, :, None, None, None, :, :]
            c_idx = cols[None, None, None, :, :, :, :, :]
            part[np.broadcast_to(r_idx, acc.shape), np.broadcast_to(c_idx, acc.shape)] += acc
        out += part  # red.global.add: exact in any order
    return out[:m, :n]


def _int8(rng, *shape):
    return rng.randint(-128, 128, shape).astype(np.int8)


SHAPES = [(m, k, n) for m in (8, 64) for k, n in ((768, 3072), (3072, 768))] + [
    (512, 768, 3072), (512, 3072, 768), (8, 768, 2), (512, 768, 2),
    (37, 70, 130), (300, 129, 257), (100, 1000, 70), (1, 1, 1), (8, 3072, 2)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_emulated_kernel_equals_the_int32_product(m, k, n):
    rng = np.random.RandomState(m * 7 + k + n)
    x, w = _int8(rng, m, k), _int8(rng, k, n)
    np.testing.assert_array_equal(emulate(x, w), x.astype(np.int64) @ w.astype(np.int64))


def test_emulated_fragments_follow_the_ptx_layouts():
    """The tables themselves: ldmatrix hands lane (g, t) row g (+ 8) at K
    4t (+ 16) of its m16 tile, and B word (j, h) of lane (g, t) is column
    wn + 4g + j at K rows 16h + 4t .. + 3."""
    off = _a_offsets()
    for j in range(4):
        for b in range(4):
            want = (16 * 1 + G + 8 * (j % 2)) * KSA + 32 + 16 * (j // 2) + 4 * T + b
            np.testing.assert_array_equal(off[0, 1, 1, :, j, b], want)
    stage = np.zeros((1, BK * BN), np.uint8)
    # a stage whose byte at (K row r, column c) encodes r and c
    for r in range(BK):
        for q in range(BN // 16):
            for e in range(16):
                stage[0, b_chunk(r, q) + e] = (r * 3 + 16 * q + e) % 256
    for wni in range(4):
        for h in range(2):
            frag = _bytes(_b_fragments(stage, wni, 32, h))[0].view(np.uint8)  # [j, lane, byte]
            for j in range(4):
                col = 32 * wni + 4 * G + j
                rows = 32 + 16 * h + 4 * T[:, None] + np.arange(4)
                np.testing.assert_array_equal(frag[j], (rows * 3 + col[:, None]) % 256)


def test_swizzle_puts_a_warps_b_loads_on_distinct_banks():
    """For each of a warp's four word loads (i) the 32 lanes read 32 words
    on 32 distinct banks, for every warp column and step."""
    for wni in range(4):
        wn = 32 * wni
        b_off = 4 * T * BN + ((((wn + 4 * G) >> 4) ^ (2 * T)) << 4) + ((4 * G) & 15)
        for kk in range(0, BK, 32):
            for h in range(2):
                for i in range(4):
                    at = (kk + 16 * h) * BN + b_off + i * BN
                    assert len(set((at // 4) % 32)) == 32


# -- the split-K plan -------------------------------------------------------------


def test_plan_constants_mirror_the_kernel_source():
    consts = _src_constants()
    assert (consts["kBM"], consts["kBN"], consts["kBK"]) == (BM, BN, BK)
    assert consts["kWave"] == tim._WAVE and consts["kMinSliceSlabs"] == tim._MIN_SLICE_SLABS


@pytest.mark.parametrize("bucket", [1, 8, 64, 512, 4096])
def test_split_k_plan_over_the_int8_program(bucket):
    """Over the program's 25 products: slices cover K in whole slabs, none
    empty; K is split only when the tiles are under a wave, and then the
    blocks stay within one wave, and no more slices are made than slices of
    the least depth would give."""
    shapes = chip_smoke._q_forward_products(bucket)
    assert len(shapes) == chip_smoke.Q_MULS
    for m, k, n in shapes:
        slices, per = tim._split_k(m, k, n)
        slabs = -(-k // BK)
        assert slices >= 1 and per >= 1
        assert (slices - 1) * per < slabs <= slices * per, (m, k, n, slices, per)
        assert slices <= -(-slabs // tim._MIN_SLICE_SLABS)
        tiles = -(-m // BM) * -(-n // BN)
        if tiles >= tim._WAVE:
            assert slices == 1
        else:
            assert tiles * slices <= tim._WAVE, (m, k, n, slices)
            if tiles * 2 <= tim._WAVE and slabs >= 2 * tim._MIN_SLICE_SLABS:
                assert slices > 1, (m, k, n)


def test_split_k_plan_at_the_serving_shapes():
    assert tim._split_k(512, 768, 3072) == (1, 6)  # 96 tiles: a second slice overfills
    assert tim._split_k(512, 3072, 768) == (5, 5)  # 24 tiles: 5 slices, 120 blocks
    assert tim._split_k(8, 3072, 768) == (12, 2)  # 6 tiles: 12 slices of 2 slabs
    assert tim._split_k(4096, 768, 3072) == (1, 6)  # 768 tiles: no split
    assert tim._split_k(100, 1000, 70) == (4, 2)  # ragged K and N, split
    assert tim._split_k(1, 1, 1) == (1, 1)


def test_cpu_calls_count_no_launch_and_no_split():
    rng = np.random.RandomState(5)
    x, w = torch.from_numpy(_int8(rng, 8, 3072)), torch.from_numpy(_int8(rng, 3072, 768))
    assert tim._split_k(8, 3072, 768)[0] > 1
    before = (tim.LAUNCHES, tim.SPLITS)
    tim.int8_matmul(x, w)
    assert (tim.LAUNCHES, tim.SPLITS) == before


def test_split_counter_is_reset_with_the_launch_counts(monkeypatch):
    from paddle_tpu_torch.ops import cuda

    monkeypatch.setattr(tim, "SPLITS", 3)
    cuda.reset_launch_counts()
    assert tim.SPLITS == 0
