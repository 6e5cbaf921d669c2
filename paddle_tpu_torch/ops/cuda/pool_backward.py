"""Max-pool2d backward: the CUDA kernel and its plain version.

Replaces ``paddle_tpu/ops/pallas/pool_backward.py`` ``_max_pool2d_backward``:
``dx`` of a max pooling from ``x``, the pooled ``y`` and ``dy``. A window's
gradient goes to its first maximum in row-major tap order (first max wins,
the subgradient of XLA's ``select_and_scatter`` and of the JAX kernel);
padded taps never hold it. ``csrc/pool_backward.cu`` gathers: a block
stages a tile of ``x`` with its halo and the ``y``/``dy`` of the windows
that reach it in shared memory, finds each window's first maximum there,
then adds for each element of ``dx`` the ``dy`` of the windows it won, no
atomics, so the result repeats bit for bit and equals
:func:`_plain_max_pool2d_backward`, which adds the taps in the same order.
Memory bound: x, y, dy read once, dx written once.

Two layouts (:func:`memory_layout`): NCHW-contiguous, the JAX package's,
and channels-last, the NCHW view of an NHWC buffer, in which ResNet's fused
stem conv hands its output to the pool. ``x``, ``y`` and ``dy`` must share
one (:func:`_plan_layout`); ``dx`` comes back in it, so a channels-last
route moves no tensor to another layout.

``torch.nn.functional.max_pool2d`` keeps the index of the first maximum too
(its forward replaces the running maximum only by a strictly greater value,
on the CPU and on CUDA alike), so torch's own backward routes ties the same
way; the port's rule does not rest on that.

float32, bf16 or fp16 (the stem under AMP; the TPU gate
``max_pool_backward_supported`` admits fp16, ``:259-272``): the taps are
compared in the type they come in (a 16-bit ``x == y`` is exact), added in
float32 and rounded once to the type at the store (fp16 past 65504 to inf,
never clamped), as the TPU kernel does (``pool_backward.py:131-135``,
``:196``); bf16 and fp16 launches count apart from float32's. A tensor on
the CPU takes the plain version; a tensor on the card launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ._tally import bump, check_outputs, counted

__all__ = ["max_pool2d_backward", "max_pool_backward_supported", "memory_layout", "LAUNCHES",
           "BF16_LAUNCHES", "FP16_LAUNCHES"]

#: kernel launches since the last reset (counted where the kernel launches),
#: float32, bf16 and fp16 apart
LAUNCHES = 0
BF16_LAUNCHES = 0
FP16_LAUNCHES = 0
_count_lock = threading.Lock()
# each type's C entry and count
_ENTRIES = {torch.float32: ("ptt_max_pool2d_backward", "LAUNCHES"),
            torch.bfloat16: ("ptt_max_pool2d_backward_bf16", "BF16_LAUNCHES"),
            torch.float16: ("ptt_max_pool2d_backward_f16", "FP16_LAUNCHES")}

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1


def memory_layout(t):
    """``"nchw"`` for an NCHW-contiguous 4-D tensor, ``"nhwc"`` for a
    channels-last one (the NCHW view of an NHWC buffer), else None. A tensor
    that is both (C == 1, or H == W == 1) is ``"nchw"``."""
    if t.dim() != 4:
        return None
    if t.is_contiguous():
        return "nchw"
    if t.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return None


def _plan_layout(x, y, dy):
    """The one layout that ``x``, ``y`` and ``dy`` share, which ``dx`` is
    written in: NCHW if all three are NCHW-contiguous, else channels-last if
    all three are channels-last; raises when they lie otherwise."""
    for layout, fmt in (("nchw", torch.contiguous_format), ("nhwc", torch.channels_last)):
        if all(t.is_contiguous(memory_format=fmt) for t in (x, y, dy)):
            return layout
    raise ValueError(f"max_pool2d_backward: x, y and dy must be all NCHW-contiguous or all "
                     f"channels-last; they lie as {[memory_layout(t) for t in (x, y, dy)]}")


def to_layout(t, layout):
    """``t`` itself when it lies in ``layout`` already, else a copy that
    does."""
    fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
    return t if t.is_contiguous(memory_format=fmt) else t.contiguous(memory_format=fmt)


def max_pool_backward_supported(x_shape, dtype, ceil_extra, data_format) -> bool:
    """Gate of the kernel route (the JAX gate less its TPU test): NCHW 4-D
    floating input, symmetric padding (no ``ceil_mode`` tail), no empty
    axis."""
    if data_format != "NCHW" or len(x_shape) != 4:
        return False
    if tuple(ceil_extra) != (0, 0):
        return False
    if not dtype.is_floating_point:
        return False
    return all(int(d) > 0 for d in x_shape)


def _plain_max_pool2d_backward(x, y, dy, kernel, stride, padding):
    """``dx`` in tensor ops: each tap of every window in row-major order
    takes ``dy`` where it equals ``y`` and no earlier tap did, and is added
    back at its place, in float32 for float32 and narrower types (the TPU
    kernel's arithmetic, ``pool_backward.py:131-135``), rounded once to
    ``x``'s type at the end. The padding is NaN, which equals nothing."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    h, w = x.shape[2:]
    oh, ow = y.shape[2:]
    xp = torch.nn.functional.pad(x, (pw, pw, ph, ph), value=float("nan"))
    acc = torch.promote_types(x.dtype, torch.float32)
    dxp = torch.zeros(xp.shape, dtype=acc, device=xp.device)
    taken = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    dyf = dy.to(acc)
    zero = torch.zeros((), dtype=acc, device=dy.device)
    for di in range(kh):
        rows = slice(di, di + sh * (oh - 1) + 1, sh)
        for dj in range(kw):
            cols = slice(dj, dj + sw * (ow - 1) + 1, sw)
            sel = (xp[:, :, rows, cols] == y) & ~taken
            taken |= sel
            dxp[:, :, rows, cols] += torch.where(sel, dyf, zero)
    return dxp[:, :, ph:ph + h, pw:pw + w].to(x.dtype).contiguous()


def _pairs(kernel, stride, padding):
    out = []
    for name, v in (("kernel", kernel), ("stride", stride), ("padding", padding)):
        v = tuple(int(a) for a in v)
        if len(v) != 2:
            raise ValueError(f"max_pool2d_backward: {name} must have two entries, got {v}")
        out.append(v)
    return out


def _on_card(x, tensors):
    """Raise unless every tensor lies on ``x``'s CUDA device."""
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("max_pool2d_backward: all tensors must be on one CUDA device")


def _cost(x, y, dy, kernel, stride, padding):
    """Row 16's work: x, y and dy read, dx (x's shape) written."""
    return 0, (2 * x.numel() + y.numel() + dy.numel()) * x.element_size()


@counted(_cost)
@torch.no_grad()
def max_pool2d_backward(x, y, dy, kernel, stride, padding):
    """``dx`` like ``x`` [N, C, H, W] for ``y = max_pool2d(x)`` and ``dy``
    like ``y`` [N, C, OH, OW], in the layout the three share (NCHW or
    channels-last; raises on a mix); ``kernel``, ``stride`` and
    (symmetric) ``padding`` are pairs."""
    kernel, stride, padding = _pairs(kernel, stride, padding)
    if x.dim() != 4 or y.dim() != 4 or y.shape != dy.shape or x.shape[:2] != y.shape[:2]:
        raise ValueError(f"max_pool2d_backward: x {tuple(x.shape)}, y {tuple(y.shape)} and dy "
                         f"{tuple(dy.shape)} are not a pooling's [N, C, H, W] and [N, C, OH, OW]")
    n, c, h, w = x.shape
    oh, ow = y.shape[2:]
    for dim, o, k, s, p in zip((h, w), (oh, ow), kernel, stride, padding):
        if o != (dim + 2 * p - k) // s + 1:
            raise ValueError(f"max_pool2d_backward: output extent {o} is not that of input "
                             f"{dim}, kernel {k}, stride {s}, padding {p}")
    tensors = (x, y, dy)
    layout = _plan_layout(x, y, dy)
    fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
    if all(t.device.type == "cpu" for t in tensors):
        return _plain_max_pool2d_backward(x, y, dy, kernel, stride, padding).contiguous(
            memory_format=fmt)
    if x.numel() == 0 or y.numel() == 0:  # nothing is launched or counted
        return torch.zeros_like(x, memory_format=fmt)
    if x.dtype not in _ENTRIES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"max_pool2d_backward: the kernel takes float32, bf16 or fp16, one type "
                        f"for x, y and dy, got {[str(t.dtype) for t in tensors]}")
    _on_card(x, tensors)
    symbol, count = _ENTRIES[x.dtype]
    if max(kernel) > 64 or max(n, c, h, w) > _INT_MAX or x.numel() // n > _INT_MAX:
        raise ValueError(f"max_pool2d_backward: the kernel takes windows up to 64 x 64 and "
                         f"extents and images below 2**31; got {kernel} over {tuple(x.shape)}")
    dx = torch.empty_like(x, memory_format=fmt)
    with torch.cuda.device(x.device):
        fn = getattr(_build.library("pool_backward"), symbol)
        if fn.argtypes is None:
            fn.argtypes = _ARGS
            fn.restype = ctypes.c_int
        err = fn(x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c, h, w, oh, ow,
                 *kernel, *stride, *padding, int(layout == "nhwc"),
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "max_pool2d_backward")
    with _count_lock:
        bump(globals(), count)
    check_outputs(globals(), count, dx)
    return dx
