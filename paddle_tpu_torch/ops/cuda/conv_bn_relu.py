"""Fused conv2d + batch_norm + relu: the CUDA kernels, their plain versions and the op.

Replaces ``paddle_tpu/ops/pallas/conv_bn_relu.py``. The conv is lowered to
a matrix product once, outside the kernels (:func:`_as_matmul`: a 1x1
stride-1 conv is its channels-last input, any other goes through
``F.unfold``, whose patch features are ordered (cin, kh, kw) as the JAX
package's ``conv_general_dilated_patches``), and six kernels do the rest:

- eval, ``csrc/conv_bn_relu_mm.cu``: :func:`mm_affine_relu` computes
  ``relu((p2 @ w2) * scale + shift)`` with the pre-activation kept out of
  device memory (``_mm_affine_relu``, ``:306``); where its output tiles
  would not fill the card (serving at small batch) it splits K
  (:func:`_split_k`) and a second kernel adds the slices in order;
- training forward: :func:`mm_stats` (same source) computes ``co = p2 @
  w2`` and per-tile channel sums (``_mm_stats``, ``:337``);
  :func:`centered_sumsq` the centred per-channel sum of squares, two-pass
  (``_centered_sumsq``, ``:370``); :func:`bn_relu` the normalize + relu
  (``_bn_relu``, ``:399``); the last two in ``csrc/conv_bn_relu_bn.cu``;
- training backward, same source: :func:`bn_bwd_partials` the sums of
  ``dy_relu`` and ``dy_relu * co`` with the relu gate recomputed from
  ``co`` (``_bn_bwd_partials``, ``:463``) and :func:`bn_bwd_dco` the
  folded ``d_co = scale * dy_relu - k3 * co - b0`` (``_bn_bwd_dco``,
  ``:496``). The matrix gradients ``d_co @ w2ᵀ`` and ``p2ᵀ @ d_co`` are
  ``torch.matmul``, as the JAX package leaves them to ``jnp.dot``, and
  :class:`_Unfold`'s backward folds ``dp2`` back into ``dx``, adding the
  overlapping patches in float32 (XLA's patch VJP; on the CPU a bf16
  ``F.fold`` would round as it adds).

The float32 products run on the tensor cores in 3xTF32 (f32-accurate, not
bit-equal to ``torch.matmul``). Every reduction writes per-block partials
that the wrapper adds up with ``torch.sum``: no atomics. Nothing float32
is padded: the kernels mask ragged M, K and N themselves. The TPU dispatch
skipped convs with ``N * Cout < 512`` (``_supported``, ``:621``); here
every structurally admitted conv takes the kernels, so the launch counts
hold at every batch size.

bf16 (the op under AMP takes bf16 ``x`` and ``weight`` and float32 gamma,
beta and statistics: ``nn/layers.py`` ``fused_conv_bn_relu``): the two
products are ``csrc/conv_bn_relu_mm_bf16.cu`` (``wgmma`` with float32 sums
from a TMA ring, persistent blocks; split-K at small M planned for its own
resident blocks by :func:`_split_k_bf16`), the four passes bf16 instances of
``csrc/conv_bn_relu_bn.cu``; each counts its launches apart from the
float32 kernel's. They round where the TPU kernels round: ``co`` to bf16
once, its channel sums taken from the rounded values (``:245-250``), the
affine, the statistics and every sum in float32, ``y`` rounded once;
``d_co`` stays float32 (``:501``) and the matrix gradients are float32
products rounded once to the operands' type (``:560-561``). bf16 rows
reach the GEMM by TMA, whose rows must lie a multiple of 16 bytes apart, so
:func:`_as_matmul` pads K with zeros to a multiple of 8 (the stem's 147 to
152).

float16 (O1 float16 autocast): the TPU kernels never took it, and the JAX
package sends an fp16 conv to its unfused reference (``_reference``,
``:136-149``: the registered ``conv2d``, ``batch_norm``, ``relu``). The same
sources have fp16 instances (entries ``ptt_conv_mm_f16_*`` and
``ptt_bn_*_f16``, counted apart as ``FP16_*``) that round where that
reference rounds: ``co`` to fp16 once, the statistics and every sum in
float32 from the rounded ``co``, ``y`` rounded once, and ``d_co`` rounded to
fp16 once, as ``_bn_train_bwd`` rounds it (``ops/kernels.py:918-923``). The
reference then takes dx and dw as the conv's VJP, each one product with
float32 sums rounded once; so in fp16 the cores fold the patches' float32
gradients back into dx before its one rounding (:func:`_fp16_conv_grads`),
where bf16 rounds each patch's gradient first as the TPU kernels do. fp16
rounds past 65504 to inf and is never clamped: an overflowing conv or
gradient stays non-finite for the loss scaler. K is padded as for bf16.

A tensor on the CPU takes the plain versions (the ``_*_plain``
functions); a tensor on the card launches the kernels or raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch
import torch.nn.functional as _F

from ...framework.autograd import amp_cast
from . import _build
from ._tally import bump, check_outputs, counted

__all__ = ["conv_bn_relu", "mm_affine_relu", "mm_stats", "centered_sumsq", "bn_relu",
           "bn_bwd_partials", "bn_bwd_dco"]

#: kernel launches since the last reset (counted where each kernel launches),
#: float32, bf16 and fp16 apart
MM_AFFINE_RELU_LAUNCHES = 0
MM_STATS_LAUNCHES = 0
CENTERED_SUMSQ_LAUNCHES = 0
BN_RELU_LAUNCHES = 0
BN_BWD_PARTIALS_LAUNCHES = 0
BN_BWD_DCO_LAUNCHES = 0
BF16_MM_AFFINE_RELU_LAUNCHES = 0
BF16_MM_STATS_LAUNCHES = 0
BF16_CENTERED_SUMSQ_LAUNCHES = 0
BF16_BN_RELU_LAUNCHES = 0
BF16_BN_BWD_PARTIALS_LAUNCHES = 0
BF16_BN_BWD_DCO_LAUNCHES = 0
FP16_MM_AFFINE_RELU_LAUNCHES = 0
FP16_MM_STATS_LAUNCHES = 0
FP16_CENTERED_SUMSQ_LAUNCHES = 0
FP16_BN_RELU_LAUNCHES = 0
FP16_BN_BWD_PARTIALS_LAUNCHES = 0
FP16_BN_BWD_DCO_LAUNCHES = 0
#: calls of :func:`mm_affine_relu` that took split-K, in either type (each
#: also counts one launch of its type)
MM_AFFINE_RELU_SPLITS = 0
_count_lock = threading.Lock()
# the count's prefix by the matrices' dtype
_PREFIX = {torch.float32: "", torch.bfloat16: "BF16_", torch.float16: "FP16_"}
# the 16-bit GEMM's and passes' entries by dtype
_SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16"}

# the float32 GEMM's tiles (csrc/conv_bn_relu_mm.cu kBM, kBN, kBK): output
# rows and columns a block, and the depth of one slab of K
_TILE_ROWS, _TILE_COLS, _SLAB = 128, 64, 32
# 16-bit rows reach the 16-bit GEMM by TMA, 16-byte row strides: K a
# multiple of 8 (:func:`_as_matmul` pads it), w2's rows padded to a multiple
# of 8 columns
_BF16_ALIGN = 8
# the bf16 GEMM (csrc/conv_bn_relu_mm_bf16.cu): the depth of one slab
# (kBK), the rows a consumer warpgroup owns (kWgRows, also the rows of one
# row of channel sums) and the persistent blocks an SM (kBlocksPerSm)
_BF16_SLAB = 64
_BF16_WG_ROWS = 128
_BF16_BLOCKS_PER_SM = 1
# bf16 split-K (measured on the H100: a sweep of every split of ResNet-50's
# serving products at batches 1, 8 and 32): a split pays a work item's
# fixed cost (its first slab's wait, its epilogue) and the in-launch reduce
# (its partial stores, the wait for every slice, a share of the rows read
# back), in slabs a block loads; it pays off only on a card mostly left
# empty, at most one tile for _BF16_SPLIT_SHARE of the blocks. The fp16
# instances take the same plan unchanged: the same kernel, tiles and
# 2-byte elements, so the same bytes and slabs (not tuned apart)
_BF16_ITEM_SLABS = 6
_BF16_REDUCE_SLABS = 14
_BF16_SPLIT_SHARE = 4
# split-K: a wave is the blocks the card holds at once, 2 an SM (85.5 KB of
# shared memory each) on the H100's 132 (a batch-8 ResNet-50 forward's 33
# products ran faster on the card planned for 264 blocks than for 132); a
# slice walks at least _MIN_SLICE_SLABS slabs, so that its work outweighs
# its ring's start and its share of the workspace (2 and 1 were no faster)
_WAVE = 264
_MIN_SLICE_SLABS = 4

# blocks the reductions aim at: a few per SM of the card's 132, so each
# partial is small next to the pass and the card stays full
_REDUCE_BLOCKS = 2048
_REDUCE_COLS = 32  # channels a reduction block (csrc/conv_bn_relu_bn.cu kCols)


def _count(attr, dtype=torch.float32, outs=()):
    name = _PREFIX[dtype] + attr
    with _count_lock:
        bump(globals(), name)
    check_outputs(globals(), name, *outs)


# -- plain versions -----------------------------------------------------------


def _pre_act(co, scale, shift):
    """``co * scale + shift`` as two rounded ops, the kernels' rounding."""
    return co * scale + shift


def _product(p2, w2):
    """``p2 @ w2`` in the operands' type; fp16 as one float32 product
    rounded once, the fp16 kernel's rounding (torch's CPU half GEMM is
    slow)."""
    if p2.dtype == torch.float16:
        return torch.matmul(p2.float(), w2.float()).half()
    return torch.matmul(p2, w2)


def _mm_affine_relu_plain(p2, w2, scale, shift):
    return torch.relu(_pre_act(_product(p2, w2), scale, shift)).to(p2.dtype)


def _mm_stats_plain(p2, w2):
    """``(co, partial)`` with the f32 partial ``[1, N]``: one tile of every
    row."""
    co = _product(p2, w2)
    return co, co.float().sum(0, keepdim=True)


def _centered_sumsq_plain(co, mean):
    return (co.float() - mean).square().sum(0, keepdim=True)


def _bn_relu_plain(co, scale, shift):
    return torch.relu(_pre_act(co, scale, shift)).to(co.dtype)


def _gated(co, dy, scale, shift):
    return torch.where(_pre_act(co, scale, shift) > 0, dy, torch.zeros_like(dy))


def _bn_bwd_partials_plain(co, dy, scale, shift):
    dyr = _gated(co, dy, scale, shift).float()
    return dyr.sum(0, keepdim=True), (dyr * co.float()).sum(0, keepdim=True)


def _bn_bwd_dco_plain(co, dy, scale, shift, k3, b0):
    """float32 for float32 and bf16 ``co``, as the TPU kernel writes it
    (``:501``): the matrix gradients take it unrounded; fp16 rounded once to
    fp16, as the JAX package's fp16 path rounds it (``_bn_train_bwd``)."""
    dco = scale * _gated(co, dy, scale, shift).float() - k3 * co.float() - b0
    return dco.half() if co.dtype == torch.float16 else dco


# -- kernel entries -----------------------------------------------------------


_VP = ctypes.c_void_p
_I64, _INT = ctypes.c_int64, ctypes.c_int


def _bind(lib, symbol, argtypes):
    fn = getattr(_build.library(lib), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _on_kernel(name, mats, vecs, n):
    """False for CPU tensors (the plain version runs); on the card, checks
    what the kernels take (matrices all float32, all bf16 or all fp16, the
    vectors float32) and returns True; raises on any other device. The
    ``[N]`` vectors are checked on every device."""
    if any(tuple(v.shape) != (n,) for v in vecs):
        raise ValueError(f"{name}: per-channel vectors must be [{n}], got "
                         f"{[tuple(v.shape) for v in vecs]}")
    first = mats[0]
    if first.device.type == "cpu" and all(t.device.type == "cpu" for t in mats + vecs):
        return False
    if (first.dtype not in _PREFIX
            or any(t.dtype != first.dtype for t in mats)
            or any(v.dtype != torch.float32 for v in vecs)):
        raise TypeError(f"{name}: the kernels take float32, bf16 or fp16 matrices of one type and "
                        f"float32 vectors, got {[str(t.dtype) for t in mats]} and "
                        f"{sorted({str(v.dtype) for v in vecs})}")
    if first.device.type != "cuda" or any(t.device != first.device for t in mats + vecs):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in mats):
        raise ValueError(f"{name}: the [M, N] operands must be contiguous")
    return True


def _half(t):
    """A 16-bit type, bf16 or fp16: the wgmma GEMM's and the passes' paired
    instances."""
    return t.dtype in _SUFFIX


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_mm(name, p2, w2):
    if p2.dim() != 2 or w2.dim() != 2 or p2.shape[1] != w2.shape[0]:
        raise ValueError(f"{name}: p2 {tuple(p2.shape)} @ w2 {tuple(w2.shape)} is no [M, K] @ "
                         "[K, N] product")


def _aligned(t):
    """``t``, or a copy of it when its base is off 16 bytes: the conv GEMM
    copies its operands in 16-byte chunks."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_mn(name, co, *others):
    if co.dim() != 2 or any(t.shape != co.shape for t in others):
        raise ValueError(f"{name}: operands {[tuple(t.shape) for t in (co,) + others]} must be "
                         "one [M, N]")


def _mm_lib(p2):
    """(library, symbol prefix) of the conv GEMM for ``p2``'s type."""
    if _half(p2):
        return "conv_bn_relu_mm_bf16", f"ptt_conv_mm_{_SUFFIX[p2.dtype]}_"
    return "conv_bn_relu_mm", "ptt_conv_mm_"


def _mm_operands(name, p2, w2):
    """``(p2, w2, ld)`` as the GEMM copies them: bases on 16 bytes; in a
    16-bit type, K a multiple of 8 (raises otherwise: :func:`_as_matmul`
    pads it) and w2's rows padded with zero columns to a multiple of 8,
    their length in ``ld``, the 16-bit entries' extra argument (empty for
    float32)."""
    p2, w2 = _aligned(p2), _aligned(w2)
    if not _half(p2):
        return p2, w2, ()
    if p2.shape[1] % _BF16_ALIGN:
        raise ValueError(f"{name}: the 16-bit kernel takes K a multiple of {_BF16_ALIGN}, got "
                         f"{p2.shape[1]} (pad it with zeros, as _as_matmul does)")
    extra = -w2.shape[1] % _BF16_ALIGN
    return p2, (_F.pad(w2, (0, extra)) if extra else w2), (w2.shape[1] + extra,)


def _mm_bytes(p2, w2):
    m, k = p2.shape
    return (m * k + k * w2.shape[1] + m * w2.shape[1]) * p2.element_size()


def _mm_affine_relu_cost(p2, w2, scale, shift):
    """Row 8's work: ``2·M·K·N`` FLOPs (3xTF32 counted once), the operands
    and the two f32 vectors read, y written."""
    return 2 * p2.shape[0] * p2.shape[1] * w2.shape[1], _mm_bytes(p2, w2) + 8 * w2.shape[1]


def _mm_stats_cost(p2, w2):
    """Row 9's work: ``2·M·K·N`` FLOPs, the operands read, co and its f32
    column sums written."""
    return 2 * p2.shape[0] * p2.shape[1] * w2.shape[1], _mm_bytes(p2, w2) + 4 * w2.shape[1]


def _mn(co):
    return co.numel() * co.element_size()


def _centered_sumsq_cost(co, mean):
    """Row 10's work: co and the mean read, the f32 sums written."""
    return 0, _mn(co) + 8 * co.shape[1]


def _bn_relu_cost(co, scale, shift):
    """Row 11's work: co and the two vectors read, y written."""
    return 0, 2 * _mn(co) + 8 * co.shape[1]


def _bn_bwd_partials_cost(co, dy, scale, shift):
    """Row 12's work: co, dy and the two vectors read, the two f32 sums
    written."""
    return 0, 2 * _mn(co) + 16 * co.shape[1]


def _bn_bwd_dco_cost(co, dy, scale, shift, k3, b0):
    """Row 13's work: co, dy and the four vectors read, dco written (f32;
    fp16 for fp16 co)."""
    out = 2 if co.dtype == torch.float16 else 4
    return 0, 2 * _mn(co) + out * co.numel() + 16 * co.shape[1]


@counted(_mm_affine_relu_cost)
def mm_affine_relu(p2, w2, scale, shift):
    """``relu((p2 @ w2) * scale + shift)`` for ``p2 [M, K]``, ``w2 [K, N]``
    (both float32, bf16 or fp16; the output in their type) and float32
    ``[N]`` vectors: the kernel on the card, the plain version on the
    CPU."""
    _check_mm("mm_affine_relu", p2, w2)
    m, n = p2.shape[0], w2.shape[1]
    scale, shift = scale.contiguous(), shift.contiguous()
    if not _on_kernel("mm_affine_relu", [p2, w2], [scale, shift], n):
        return _mm_affine_relu_plain(p2, w2, scale, shift)
    y = torch.empty(m, n, device=p2.device, dtype=p2.dtype)
    if m == 0 or n == 0:  # nothing is launched or counted
        return y
    k = p2.shape[1]
    p2, w2, ld = _mm_operands("mm_affine_relu", p2, w2)
    lib, sym = _mm_lib(p2)
    slices, per = (_split_k_bf16(m, k, n, _sm_count(p2.device.index)) if _half(p2)
                   else _split_k(m, k, n))
    with torch.cuda.device(p2.device):
        args = (p2.data_ptr(), w2.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr())
        if slices == 1:
            err = _bind(lib, sym + "affine_relu", [_VP] * 5 + [_I64] + [_INT] * (2 + len(ld))
                        + [_VP])(*args, m, k, n, *ld, _stream(p2))
        elif _half(p2):  # the ordered reduce in the same launch, on zeroed counters
            ws = torch.empty(slices, m, n, device=p2.device, dtype=torch.float32)
            bm, bn = _bf16_tile(n)
            ctr = _counters(p2.device, 4 * -(-m // bm) * -(-n // bn))
            err = _bind(lib, sym + "affine_relu_split", [_VP] * 7 + [_I64] + [_INT] * 5 + [_VP])(
                *args, ws.data_ptr(), ctr.data_ptr(), m, k, n, *ld, slices, per, _stream(p2))
        else:
            ws = torch.empty(slices, m, n, device=p2.device, dtype=torch.float32)
            err = _bind(lib, sym + "affine_relu_split", [_VP] * 6 + [_I64] +
                        [_INT] * (4 + len(ld)) + [_VP])(
                *args, ws.data_ptr(), m, k, n, *ld, slices, per, _stream(p2))
    _build.check(err, "mm_affine_relu")
    _count("MM_AFFINE_RELU_LAUNCHES", p2.dtype, (y,))
    if slices > 1:
        _count("MM_AFFINE_RELU_SPLITS")
    return y


@counted(_mm_stats_cost)
def mm_stats(p2, w2):
    """``(co, partial)``: ``co = p2 @ w2`` ``[M, N]`` in the operands' type
    and the float32 ``partial [tiles, N]`` whose column sums are ``co``'s
    (one row per 128-row tile on the card, one row on the CPU)."""
    _check_mm("mm_stats", p2, w2)
    m, n = p2.shape[0], w2.shape[1]
    if not _on_kernel("mm_stats", [p2, w2], [], n):
        return _mm_stats_plain(p2, w2)
    co = torch.empty(m, n, device=p2.device, dtype=p2.dtype)
    if m == 0 or n == 0:  # nothing is launched or counted
        return co, co.new_zeros(1, n, dtype=torch.float32)
    k = p2.shape[1]
    p2, w2, ld = _mm_operands("mm_stats", p2, w2)
    lib, sym = _mm_lib(p2)
    tiles = -(-m // getattr(_build.library(lib), sym + "tile_rows")())
    partial = torch.empty(tiles, n, device=p2.device, dtype=torch.float32)
    with torch.cuda.device(p2.device):
        err = _bind(lib, sym + "stats", [_VP] * 4 + [_I64] + [_INT] * (2 + len(ld)) + [_VP])(
            p2.data_ptr(), w2.data_ptr(), co.data_ptr(), partial.data_ptr(), m, k, n, *ld,
            _stream(p2))
    _build.check(err, "mm_stats")
    _count("MM_STATS_LAUNCHES", p2.dtype, (co, partial))
    return co, partial


def _split_k(m, k, n):
    """``(slices, slice_slabs)`` for the float32 eval product ``[m, k] @
    [k, n]``:
    one slice when its output tiles fill a wave of the card; else enough
    slices of whole slabs to fill one, none shorter than
    ``_MIN_SLICE_SLABS`` slabs unless K is, and none empty."""
    tiles = -(-m // _TILE_ROWS) * -(-n // _TILE_COLS)
    slabs = -(-k // _SLAB)
    if tiles >= _WAVE:
        return 1, slabs
    want = -(-_WAVE // tiles)
    per = min(slabs, max(_MIN_SLICE_SLABS, slabs // want))
    return -(-slabs // per), per


def _bf16_tile(n):
    """``(rows, cols)`` of the bf16 GEMM's output tile for ``N = n``: two
    consumer warpgroups of 128 rows by 64 or 128 columns, one above the
    other up to N = 128, side by side past it (the C source's ``launch``
    picks the same)."""
    if n <= 64:
        return 2 * _BF16_WG_ROWS, 64
    if n <= 128:
        return 2 * _BF16_WG_ROWS, 128
    return _BF16_WG_ROWS, 256


def _split_k_bf16(m, k, n, sm_count):
    """``(slices, slice_slabs)`` for the 16-bit eval product ``[m, k] @ [k,
    n]`` (bf16 or fp16: the same plan) on a card of ``sm_count`` SMs. A
    split runs in one wave of the kernel's persistent blocks (tiles x
    slices of them at most: its reduce waits for every slice of a tile in
    the same launch), so the shortest slices of whole 64-deep slabs (none
    empty) that fit one wave; it is taken where the tiles leave most of the
    card empty and its slices, an item's fixed cost and the reduce cost
    fewer slabs a block than the unsplit rounds of whole tiles do."""
    bm, bn = _bf16_tile(n)
    tiles = -(-m // bm) * -(-n // bn)
    slabs = -(-k // _BF16_SLAB)
    wave = sm_count * _BF16_BLOCKS_PER_SM
    unsplit = -(-tiles // wave) * (slabs + _BF16_ITEM_SLABS)
    if tiles * _BF16_SPLIT_SHARE <= wave:
        for per in range(1, slabs):
            slices = -(-slabs // per)
            if tiles * slices <= wave:
                if per + _BF16_ITEM_SLABS + _BF16_REDUCE_SLABS < unsplit:
                    return slices, per
                break
    return 1, slabs


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


_split_counters = {}  # device -> int32 counters of the bf16 split-K reduce, zero between launches


def _counters(device, count):
    """At least ``count`` zero int32 counters on ``device`` for the bf16
    split-K's in-launch reduce; the kernel leaves them zero, so one buffer
    serves every launch on the device's stream. The buffer is made once, at
    the most a split can ask for (4 a tile, and a split's tiles fit one wave
    of :func:`_split_k_bf16`), and never replaced: a launch captured in a
    CUDA graph keeps its address for every replay."""
    buf = _split_counters.get(device)
    if buf is None:
        most = 4 * _sm_count(device.index) * _BF16_BLOCKS_PER_SM
        buf = _split_counters[device] = torch.zeros(max(most, 4096), dtype=torch.int32,
                                                    device=device)
    if buf.numel() < count:
        raise ValueError(f"mm_affine_relu: a split of {count // 4} tiles is more than one wave; "
                         f"the counters hold {buf.numel() // 4}")
    return buf


def _reduce_rows(m, n):
    """Rows a reduction block walks (a multiple of its 8 warps), aiming at
    about ``_REDUCE_BLOCKS`` blocks in all."""
    col_tiles = -(-n // _REDUCE_COLS)
    want = max(1, _REDUCE_BLOCKS // col_tiles)
    per = -(-m // want)
    return max(8, -(-per // 8) * 8)


_BN_ARGS = {"centered_sumsq": [_VP, _I64, _INT, _I64, _VP, _VP, _VP],
            "relu": [_VP, _I64, _INT, _VP, _VP, _VP, _VP],
            "bwd_partials": [_VP, _VP, _I64, _INT, _I64] + [_VP] * 5,
            "bwd_dco": [_VP, _VP, _I64, _INT] + [_VP] * 6}


def _bn_symbol(name, co):
    """The batch-norm pass ``ptt_bn_<name>`` for ``co``'s type."""
    return _bind("conv_bn_relu_bn",
                 f"ptt_bn_{name}" + (f"_{_SUFFIX[co.dtype]}" if _half(co) else ""),
                 _BN_ARGS[name])


@counted(_centered_sumsq_cost)
def centered_sumsq(co, mean):
    """``partial [blocks, N]`` (float32) whose column sums are ``sum((co -
    mean)^2)`` per channel of ``co [M, N]``: the centred second pass of the
    batch variance."""
    _check_mn("centered_sumsq", co)
    m, n = co.shape
    mean = mean.contiguous()
    if not _on_kernel("centered_sumsq", [co], [mean], n):
        return _centered_sumsq_plain(co, mean)
    if m == 0 or n == 0:  # nothing is launched or counted
        return co.new_zeros(1, n, dtype=torch.float32)
    per = _reduce_rows(m, n)
    partial = torch.empty(-(-m // per), n, device=co.device, dtype=torch.float32)
    with torch.cuda.device(co.device):
        err = _bn_symbol("centered_sumsq", co)(co.data_ptr(), m, n, per, mean.data_ptr(),
                                               partial.data_ptr(), _stream(co))
    _build.check(err, "centered_sumsq")
    _count("CENTERED_SUMSQ_LAUNCHES", co.dtype, (partial,))
    return partial


@counted(_bn_relu_cost)
def bn_relu(co, scale, shift):
    """``relu(co * scale + shift)`` for ``co [M, N]``, in ``co``'s type."""
    _check_mn("bn_relu", co)
    m, n = co.shape
    scale, shift = scale.contiguous(), shift.contiguous()
    if not _on_kernel("bn_relu", [co], [scale, shift], n):
        return _bn_relu_plain(co, scale, shift)
    y = torch.empty_like(co)
    if m == 0 or n == 0:  # nothing is launched or counted
        return y
    with torch.cuda.device(co.device):
        err = _bn_symbol("relu", co)(co.data_ptr(), m, n, scale.data_ptr(), shift.data_ptr(),
                                     y.data_ptr(), _stream(co))
    _build.check(err, "bn_relu")
    _count("BN_RELU_LAUNCHES", co.dtype, (y,))
    return y


@counted(_bn_bwd_partials_cost)
def bn_bwd_partials(co, dy, scale, shift):
    """``(partial_dy, partial_dyco)``, each float32 ``[blocks, N]``, whose
    column sums are ``sum(dy_relu)`` and ``sum(dy_relu * co)``, with
    ``dy_relu = dy`` where ``co * scale + shift > 0`` and 0 elsewhere."""
    _check_mn("bn_bwd_partials", co, dy)
    m, n = co.shape
    scale, shift = scale.contiguous(), shift.contiguous()
    if not _on_kernel("bn_bwd_partials", [co, dy], [scale, shift], n):
        return _bn_bwd_partials_plain(co, dy, scale, shift)
    if m == 0 or n == 0:  # nothing is launched or counted
        return (co.new_zeros(1, n, dtype=torch.float32),
                co.new_zeros(1, n, dtype=torch.float32))
    per = _reduce_rows(m, n)
    pdy = torch.empty(-(-m // per), n, device=co.device, dtype=torch.float32)
    pdyc = torch.empty_like(pdy)
    with torch.cuda.device(co.device):
        err = _bn_symbol("bwd_partials", co)(
            co.data_ptr(), dy.data_ptr(), m, n, per, scale.data_ptr(), shift.data_ptr(),
            pdy.data_ptr(), pdyc.data_ptr(), _stream(co))
    _build.check(err, "bn_bwd_partials")
    _count("BN_BWD_PARTIALS_LAUNCHES", co.dtype, (pdy, pdyc))
    return pdy, pdyc


@counted(_bn_bwd_dco_cost)
def bn_bwd_dco(co, dy, scale, shift, k3, b0):
    """``scale * dy_relu - k3 * co - b0`` for ``co, dy [M, N]``: float32
    for float32 and bf16 (``_bn_bwd_dco``, ``:501``), fp16 rounded once for
    fp16 (the JAX package's fp16 path, ``_bn_train_bwd``)."""
    _check_mn("bn_bwd_dco", co, dy)
    m, n = co.shape
    vecs = [v.contiguous() for v in (scale, shift, k3, b0)]
    if not _on_kernel("bn_bwd_dco", [co, dy], vecs, n):
        return _bn_bwd_dco_plain(co, dy, *vecs)
    dco = torch.empty(m, n, device=co.device,
                      dtype=torch.float16 if co.dtype == torch.float16 else torch.float32)
    if m == 0 or n == 0:  # nothing is launched or counted
        return dco
    with torch.cuda.device(co.device):
        err = _bn_symbol("bwd_dco", co)(co.data_ptr(), dy.data_ptr(), m, n,
                                        *(v.data_ptr() for v in vecs), dco.data_ptr(),
                                        _stream(co))
    _build.check(err, "bn_bwd_dco")
    _count("BN_BWD_DCO_LAUNCHES", co.dtype, (dco,))
    return dco


# -- autograd -------------------------------------------------------------------


class _TrainCore(torch.autograd.Function):
    """``(y2, batch_mean, batch_var)`` of ``relu(batch_norm(p2 @ w2))`` with
    batch statistics; the statistics feed only the detached running-stat
    blend, so they carry no gradient (``_train_core``, ``:510-565``). The
    module's entries are looked up at call time.

    With ``group`` (a data-parallel group of more than one rank,
    ``distributed.collective.stats_group``) the statistics are the global
    batch's, reduced between the launches: the channel sums and the row
    count are summed over the group, the centred sums of squares are taken
    about that global mean and summed; in the backward the two channel sums
    of ``bn_bwd_partials`` are summed over the group before ``bn_bwd_dco``
    (``dgamma`` and ``dbeta`` stay this rank's: the step averages them with
    every gradient).

    fp16 passes the conv's input ``x`` and its :class:`_Lowering` beside a
    ``p2`` lowered from ``x`` without autograd: the backward returns dx for
    ``x`` itself (:func:`_fp16_conv_grads`), none for ``p2``."""

    @staticmethod
    def forward(ctx, p2, w2, gamma, beta, eps, group=None, x=None, lowering=None):
        m = p2.shape[0]
        co, ps = mm_stats(p2, w2)
        if group is None:
            mean = ps.sum(0) / m
            var = centered_sumsq(co, mean).sum(0) / m
        else:
            from ...distributed import collective

            tot = torch.cat([ps.sum(0), ps.new_full((1,), float(m))])
            collective.all_reduce(tot, collective.ReduceOp.SUM, group)
            m = tot[-1]
            mean = tot[:-1] / m
            var = centered_sumsq(co, mean).sum(0)
            collective.all_reduce(var, collective.ReduceOp.SUM, group)
            var = var / m
        rstd = torch.rsqrt(var + eps)
        scale = gamma * rstd
        shift = beta - mean * scale
        y2 = bn_relu(co, scale, shift)
        ctx.save_for_backward(p2, w2, co, mean, rstd, scale, shift)
        ctx.group, ctx.count, ctx.lowering = group, m, lowering
        ctx.mark_non_differentiable(mean, var)
        return y2, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        p2, w2, co, mean, rstd, scale, shift = ctx.saved_tensors
        m = ctx.count
        dy = dy.contiguous()
        pdy, pdyc = bn_bwd_partials(co, dy, scale, shift)
        sum_dy, sum_dyc = pdy.sum(0), pdyc.sum(0)
        dbeta = sum_dy
        dgamma = (sum_dyc - mean * sum_dy) * rstd
        if ctx.group is not None:
            from ...distributed import collective

            both = torch.cat([sum_dy, sum_dyc])
            collective.all_reduce(both, collective.ReduceOp.SUM, ctx.group)
            sum_dy, sum_dyc = both.split(sum_dy.shape[0])
            k3 = scale * ((sum_dyc - mean * sum_dy) * rstd / m) * rstd
        else:
            k3 = scale * (dgamma / m) * rstd
        b0 = scale * (sum_dy / m) - k3 * mean
        dco = bn_bwd_dco(co, dy, scale, shift, k3, b0)  # float32; fp16 for fp16
        if ctx.lowering is not None:
            dx, dw2 = _fp16_conv_grads(p2, w2, dco, ctx.lowering, ctx.needs_input_grad[6],
                                       ctx.needs_input_grad[1])
            return None, dw2, dgamma, dbeta, None, None, dx, None
        # float32 products of the float32 d_co, each rounded once to its
        # operand's type (``_train_core_bwd``, ``:560-561``)
        dp2 = (torch.matmul(dco, w2.float().t()).to(p2.dtype) if ctx.needs_input_grad[0]
               else None)
        dw2 = (torch.matmul(p2.float().t(), dco).to(w2.dtype) if ctx.needs_input_grad[1]
               else None)
        return dp2, dw2, dgamma, dbeta, None, None, None, None


def _eval_expr(p2, w2, gamma, beta, mean, var, eps):
    """The eval-mode function as plain torch ops (``_eval_expr``, ``:576``):
    the eval backward differentiates this recompute."""
    co = torch.matmul(p2, w2)
    return torch.relu((co - mean) * torch.rsqrt(var + eps) * gamma + beta)


class _EvalCore(torch.autograd.Function):
    """``relu(batch_norm(p2 @ w2))`` with running statistics through
    :func:`mm_affine_relu`; the backward is off the training path and
    differentiates the plain recompute (``_eval_core_bwd``, ``:590``).

    fp16 takes ``x`` and its :class:`_Lowering` as :class:`_TrainCore` does;
    its backward differentiates the JAX package's fp16 path, ``_reference``
    in eval mode: ``co`` rounded to fp16, ``y`` computed in float32 from it
    and rounded to fp16, then relu; so ``d_co`` is rounded to fp16 once
    before the conv's gradients (:func:`_fp16_conv_grads`)."""

    @staticmethod
    def forward(ctx, p2, w2, gamma, beta, mean, var, eps, x=None, lowering=None):
        rstd = torch.rsqrt(var + eps)
        scale = gamma * rstd
        y2 = mm_affine_relu(p2, w2, scale, beta - mean * scale)
        ctx.save_for_backward(p2, w2, gamma, beta, mean, var)
        ctx.eps, ctx.lowering = eps, lowering
        return y2

    @staticmethod
    def backward(ctx, g):
        if ctx.lowering is not None:
            p2, w2, *vecs = ctx.saved_tensors
            with torch.enable_grad():
                ins = [_product(p2, w2).float().requires_grad_()] + [
                    t.detach().requires_grad_() for t in vecs]
                co, gamma, beta, mean, var = ins
                y2 = torch.relu(((co - mean) * torch.rsqrt(var + ctx.eps) * gamma + beta).half())
                dco, *grads = torch.autograd.grad(y2, ins, g)
            dx, dw2 = _fp16_conv_grads(p2, w2, dco.half(), ctx.lowering,
                                       ctx.needs_input_grad[7], ctx.needs_input_grad[1])
            return (None, dw2, *grads, None, dx, None)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y2 = _eval_expr(*ins, ctx.eps)
            grads = torch.autograd.grad(y2, ins, g)
        return (*grads, None, None, None)


#: how an fp16 conv's input became its patches: the input's shape, the
#: window, the stride, ``[(top, bottom), (left, right)]`` and the layout
_Lowering = collections.namedtuple("_Lowering", "shape kernel stride pad data_format")


def _patch_grad(dp2, lo):
    """dx (float32, in the input's shape and layout) from the patch
    gradient ``dp2 [M, K']`` (K padding columns past ``K`` dropped): the
    overlapping patches' gradients added in float32, as XLA's VJP of the
    JAX lowering adds them; a pointwise conv's patches are its input."""
    if lo.data_format == "NHWC":
        n, h, wd, cin = lo.shape
    else:
        n, cin, h, wd = lo.shape
    kh, kw = lo.kernel
    sh, sw = lo.stride
    (top, bottom), (left, right) = lo.pad
    k = cin * kh * kw
    dp2 = dp2[:, :k]
    if (kh, kw) == (1, 1) and (sh, sw) == (1, 1) and lo.pad == [(0, 0), (0, 0)]:
        dx = dp2.reshape(n, h, wd, cin)
        return dx if lo.data_format == "NHWC" else dx.permute(0, 3, 1, 2)
    hp, wp = h + top + bottom, wd + left + right
    oh, ow = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    dp = dp2.reshape(n, oh * ow, k).transpose(1, 2)
    dx = _F.fold(dp, (hp, wp), (kh, kw), stride=(sh, sw))[:, :, top:top + h, left:left + wd]
    return dx.permute(0, 2, 3, 1) if lo.data_format == "NHWC" else dx


def _fp16_conv_grads(p2, w2, dco, lowering, need_dx, need_dw):
    """``(dx, dw2)`` of an fp16 conv from its fp16 ``d_co``, as the JAX
    package's fp16 path takes them (the VJP of ``_reference``'s conv): each
    one product with float32 sums, rounded once to fp16; dx's overlapping
    patches added in float32 before that rounding (:func:`_patch_grad`)."""
    d = dco.float()
    dx = _patch_grad(torch.matmul(d, w2.float().t()), lowering).half() if need_dx else None
    dw2 = torch.matmul(p2.float().t(), d).half() if need_dw else None
    return dx, dw2


# -- lowering and the op ------------------------------------------------------------


def _pair(v):
    return tuple(int(a) for a in v) if isinstance(v, (list, tuple)) else (int(v), int(v))


def _norm_padding(padding):
    """``[(top, bottom), (left, right)]``, or None for the string forms,
    which take the unfused path (``_norm_padding``, ``:155``)."""
    from ...nn import functional as F

    return None if isinstance(padding, str) else F.conv_padding(padding)


def _as_matmul(x, w, stride, pad, data_format, k_multiple=1):
    """Lower the conv to ``p2 [M, K] @ w2 [K, Cout]`` (``_as_matmul``,
    ``:177``). Returns ``(p2, w2, (n, oh, ow))``; the patch features are
    ordered (cin, kh, kw), the OIHW weight's trailing axes. With
    ``k_multiple``, K is padded with zero features (zero columns of p2,
    zero rows of w2) up to a multiple of it, which changes no product; the
    pad writes the patches once where ``reshape`` copied them, and autograd
    drops the padding's gradients."""
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    n, cin, h, wd = x.shape
    cout, _, kh, kw = w.shape
    sh, sw = _pair(stride)
    (top, bottom), (left, right) = pad
    oh = (h + top + bottom - kh) // sh + 1
    ow = (wd + left + right - kw) // sw + 1
    k = cin * kh * kw
    extra = -k % k_multiple
    if (kh, kw) == (1, 1) and (sh, sw) == (1, 1) and pad == [(0, 0), (0, 0)]:
        # a pointwise conv's "patches" are its input, channels last (a view
        # when x is the channels-last output of the fused conv before it)
        p2 = x.permute(0, 2, 3, 1).reshape(n * h * wd, cin)
        p2 = _F.pad(p2, (0, extra)) if extra else p2
    else:
        if top != bottom or left != right:
            x = _F.pad(x, (left, right, top, bottom))
            top = left = 0
        p = _Unfold.apply(x, (kh, kw), (top, left), (sh, sw))  # [N, K, OH*OW]
        p = p.transpose(1, 2)
        p2 = (_F.pad(p, (0, extra)) if extra else p).reshape(n * oh * ow, k + extra)
    w2 = w.reshape(cout, k).t()
    w2 = _F.pad(w2, (0, 0, 0, extra)) if extra else w2
    return p2.contiguous(), w2.contiguous(), (n, oh, ow)


class _Unfold(torch.autograd.Function):
    """``F.unfold`` whose backward adds the overlapping patches' gradients
    in float32 and rounds once to bf16, as XLA's VJP of
    ``conv_general_dilated_patches`` does. torch's CPU ``F.fold`` adds bf16
    in bf16; CUDA's ``col2im`` already adds in float32, so on the card the
    fold runs as it is."""

    @staticmethod
    def forward(ctx, x, kernel, padding, stride):
        ctx.geom = (tuple(x.shape[-2:]), kernel, padding, stride)
        return _F.unfold(x, kernel, padding=padding, stride=stride)

    @staticmethod
    def backward(ctx, dp):
        size, kernel, padding, stride = ctx.geom
        if dp.device.type == "cpu" and dp.dtype == torch.bfloat16:
            dx = _F.fold(dp.float(), size, kernel, padding=padding, stride=stride).bfloat16()
        else:
            dx = _F.fold(dp, size, kernel, padding=padding, stride=stride)
        return dx, None, None, None


def _supported(x, w, padding, data_format):
    return (x.dim() == 4 and w.dim() == 4 and x.dtype == w.dtype
            and _norm_padding(padding) is not None and data_format in ("NCHW", "NHWC"))


def _reference(x, w, gamma, beta, mean, var, *, stride, padding, training, momentum, eps,
               data_format):
    """The unfused sequence conv2d -> batch_norm -> relu, for the forms the
    fused path does not admit; the running statistics come back new."""
    from ...nn import functional as F

    new_mean, new_var = mean.clone(), var.clone()
    co = F.conv2d(x, w, stride=stride, padding=padding, data_format=data_format)
    y = F.batch_norm(co, new_mean, new_var, gamma, beta, training=training, momentum=momentum,
                     epsilon=eps, data_format=data_format)
    return torch.relu(y), new_mean, new_var


def conv_bn_relu(x, weight, gamma, beta, running_mean, running_var, *, stride=1, padding=0,
                 epsilon=1e-5, momentum=0.9, training=False, data_format="NCHW"):
    """Fused ``relu(batch_norm(conv2d(x, weight)))`` for a bias-free,
    ungrouped, undilated conv with an OIHW ``weight``.

    Returns ``(y, new_running_mean, new_running_var)``: in training the
    batch statistics (biased variance) blended as ``momentum * running +
    (1 - momentum) * batch``, in eval the running statistics unchanged.
    Differentiable in ``x``, ``weight``, ``gamma`` and ``beta``.
    """
    x, weight, gamma, beta, running_mean, running_var = amp_cast(
        "fused_conv_bn_relu", [x, weight, gamma, beta, running_mean, running_var])
    kw = dict(stride=stride, padding=padding, training=bool(training), momentum=float(momentum),
              eps=float(epsilon), data_format=data_format)
    if not _supported(x, weight, padding, data_format):
        return _reference(x, weight, gamma, beta, running_mean, running_var, **kw)
    pad = _norm_padding(padding)
    # fp16: the patches lowered without autograd; the cores fold their
    # float32 gradient into dx for x itself (:func:`_fp16_conv_grads`)
    fp16 = x.dtype == torch.float16
    p2, w2, (n, oh, ow) = _as_matmul(x.detach() if fp16 else x, weight, stride, pad, data_format,
                                     k_multiple=_BF16_ALIGN if _half(x) else 1)
    fold = (x, _Lowering(tuple(x.shape), tuple(weight.shape[2:]), _pair(stride), pad,
                         data_format)) if fp16 else ()
    gf, bf = gamma.float(), beta.float()
    if training:
        from ...distributed.collective import stats_group

        y2, bmean, bvar = _TrainCore.apply(p2, w2, gf, bf, float(epsilon), stats_group(), *fold)
        new_mean = momentum * running_mean + (1 - momentum) * bmean.to(running_mean.dtype)
        new_var = momentum * running_var + (1 - momentum) * bvar.to(running_var.dtype)
    else:
        y2 = _EvalCore.apply(p2, w2, gf, bf, running_mean.float(), running_var.float(),
                             float(epsilon), *fold)
        new_mean, new_var = running_mean, running_var
    y = y2.reshape(n, oh, ow, weight.shape[0])
    return (y.permute(0, 3, 1, 2) if data_format == "NCHW" else y), new_mean, new_var
