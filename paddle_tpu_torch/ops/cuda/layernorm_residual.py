"""Fused residual-add + LayerNorm, forward and backward: the CUDA kernels and their plain versions.

Replaces ``paddle_tpu/ops/pallas/layernorm_residual.py`` ``_fwd_kernel`` /
``_pallas_fwd`` (``y = LayerNorm(x + res) * w + b`` over the last dim,
with the f32 per-row ``mean`` and ``rstd``) and ``_bwd_kernel`` /
``_pallas_bwd`` (``d_input`` for both ``x`` and ``res`` from the saved
inputs and statistics, plus per-block ``dw``/``db`` partials).

On the H100 both kernels are bound by device memory: a few flops per
element read or written. The forward (``csrc/layernorm_residual.cu``)
keeps each row in registers, so the sum ``x + res`` never goes to device
memory, and takes the variance two-pass over those registers. The
backward (``csrc/layernorm_residual_bwd.cu``) recomputes ``x + res`` the
same way, keeps the ``dw``/``db`` partials of a run of rows in registers
and writes them per block; :func:`layernorm_residual` sums them, as the
JAX package sums its per-tile partials. It has two variants, which
:func:`_bwd_plan` picks with its grid: a warp a row for the widths that fit
a warp's registers (BERT's 768), and a block a row for the rest. No
atomics, so gradients repeat bit for bit.

:func:`layernorm_residual` is a ``torch.autograd.Function`` over the two
entries. A tensor on the CPU takes the plain versions (:func:`_reference`
and :func:`_reference_bwd`); a tensor on the card launches the kernels or
raises.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build

__all__ = ["layernorm_residual", "layernorm_residual_fwd", "layernorm_residual_bwd",
           "LAUNCHES", "BWD_LAUNCHES"]

_MAX_H = 16384
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's block variant: ~1024 blocks at BERT's 16384 rows, so the
# partials add ~4% to the kernel's traffic and the card stays full
_BWD_MAX_BLOCKS = 1024
# the backward's row variant (a warp a row, 16-byte accesses): widest row,
# warps a block and blocks an SM; it takes H a multiple of 32 lanes times 16
# bytes of the dtype
_ROW_MAX_H = 1024
_ROW_WARPS = 8
_ROW_BLOCKS_PER_SM = 1

#: kernel launches since the last reset (counted where each kernel launches)
LAUNCHES = 0
BWD_LAUNCHES = 0
_count_lock = threading.Lock()


def _reference(x2, r2, w, b, eps):
    """The plain forward: the add in the input dtype, f32 statistics, the
    output cast back to the input dtype (``_reference`` / ``_fwd_kernel``
    of the JAX package). Returns ``(y, mean, rstd)`` with f32
    ``mean``/``rstd`` of shape ``[rows]``."""
    a = (x2 + r2).float()
    mean = a.mean(dim=-1, keepdim=True)
    var = (a - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (a - mean) * rstd * w.float() + b.float()
    return y.to(x2.dtype), mean.squeeze(-1), rstd.squeeze(-1)


def _reference_bwd(x2, r2, w, mean, rstd, dy2):
    """The plain backward (``_bwd_kernel`` of the JAX package) on the
    forward's saved statistics: ``(da, dw_partial, db_partial)`` with the
    partials ``[1, H]`` f32, one block of every row."""
    a = (x2 + r2).float()
    xhat = (a - mean[:, None]) * rstd[:, None]
    dy = dy2.float()
    wdy = dy * w.float()
    c1 = wdy.mean(dim=-1, keepdim=True)
    c2 = (wdy * xhat).mean(dim=-1, keepdim=True)
    da = rstd[:, None] * (wdy - c1 - xhat * c2)
    return da.to(x2.dtype), (dy * xhat).sum(0, keepdim=True), dy.sum(0, keepdim=True)


def _bwd_plan(rows, h, dtype, sm_count):
    """The backward kernel's variant and grid for ``rows >= 1`` rows of
    ``h`` values of ``dtype`` on a card of ``sm_count`` SMs: ``(variant,
    rows_per_block, nblocks)``, ``variant`` ``"row"`` (a warp a row; the C
    entry takes it by the same rule) or ``"block"`` (a block a row), and
    ``nblocks = ceil(rows / rows_per_block)`` partial rows."""
    width = 32 * 16 // dtype.itemsize
    if h % width == 0 and h <= _ROW_MAX_H:
        variant = "row"
        nblocks = min(-(-rows // _ROW_WARPS), _ROW_BLOCKS_PER_SM * sm_count)
    else:
        variant = "block"
        nblocks = min(rows, _BWD_MAX_BLOCKS)
    per_block = -(-rows // nblocks)
    return variant, per_block, -(-rows // per_block)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bind(lib, symbol, argtypes):
    fn = getattr(_build.library(lib), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_VP = ctypes.c_void_p
_FWD_ARGS = [_VP] * 7 + [ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int, _VP]
_BWD_ARGS = [_VP] * 9 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP]


def _check(x2, r2, *params):
    if x2.dim() != 2 or r2.shape != x2.shape:
        raise ValueError(f"layernorm_residual: x {tuple(x2.shape)} and residual "
                         f"{tuple(r2.shape)} must be the same [rows, H]")
    h = x2.shape[1]
    if any(p.shape != (h,) for p in params):
        raise ValueError(f"layernorm_residual: weight/bias must be [{h}], got "
                         f"{[tuple(p.shape) for p in params]}")
    if r2.dtype != x2.dtype:
        raise ValueError(f"layernorm_residual: x is {x2.dtype}, residual {r2.dtype}")


def _check_kernel(x2, tensors):
    if x2.device.type != "cuda" or any(t.device != x2.device for t in tensors):
        raise ValueError("layernorm_residual: all tensors must be on one CUDA device")
    if x2.dtype not in _DTYPES:
        raise TypeError(f"layernorm_residual: kernel takes float32/bfloat16, got {x2.dtype}")
    h = x2.shape[1]
    if not 0 < h <= _MAX_H:
        raise ValueError(f"layernorm_residual: kernel takes 0 < H <= {_MAX_H}, got {h}")


def layernorm_residual_fwd(x2, r2, w, b, eps=1e-5):
    """``(y, mean, rstd)`` for ``[rows, H]`` inputs: the kernel on the card,
    :func:`_reference` on the CPU."""
    global LAUNCHES
    _check(x2, r2, w, b)
    if x2.device.type == "cpu":
        return _reference(x2, r2, w, b, eps)
    rows = x2.shape[0]
    if rows == 0:  # no rows: nothing is launched or counted
        stat = x2.new_empty(0, dtype=torch.float32)
        return torch.empty_like(x2), stat, stat.clone()
    _check_kernel(x2, (r2, w, b))
    if not (x2.is_contiguous() and r2.is_contiguous()):
        raise ValueError("layernorm_residual: x and residual must be contiguous")
    w = w.float().contiguous()
    b = b.float().contiguous()
    y = torch.empty_like(x2)
    mean = torch.empty(rows, device=x2.device, dtype=torch.float32)
    rstd = torch.empty(rows, device=x2.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = _bind("layernorm_residual", "ptt_layernorm_residual_fwd", _FWD_ARGS)(
            x2.data_ptr(), r2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, x2.shape[1], float(eps),
            _DTYPES[x2.dtype], stream)
    _build.check(err, "layernorm_residual_fwd")
    with _count_lock:
        LAUNCHES += 1
    return y, mean, rstd


def layernorm_residual_bwd(x2, r2, w, mean, rstd, dy2):
    """``(da, dw_partial, db_partial)`` for ``[rows, H]`` inputs and the
    forward's f32 ``mean``/``rstd``: ``da`` is the gradient of both ``x``
    and the residual, the partials ``[nblocks, H]`` f32 sum to ``dw`` and
    ``db``. The kernel on the card, :func:`_reference_bwd` on the CPU."""
    global BWD_LAUNCHES
    _check(x2, r2, w)
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype:
        raise ValueError(f"layernorm_residual_bwd: dy {tuple(dy2.shape)} {dy2.dtype} does not "
                         f"match x {tuple(x2.shape)} {x2.dtype}")
    rows, h = x2.shape
    if mean.shape != (rows,) or rstd.shape != (rows,):
        raise ValueError(f"layernorm_residual_bwd: mean/rstd must be [{rows}]")
    if x2.device.type == "cpu":
        return _reference_bwd(x2, r2, w, mean, rstd, dy2)
    if rows == 0:  # no rows: nothing is launched or counted
        part = x2.new_zeros(1, h, dtype=torch.float32)
        return torch.empty_like(x2), part, part.clone()
    _check_kernel(x2, (r2, w, mean, rstd, dy2))
    if not all(t.is_contiguous() for t in (x2, r2, dy2, mean, rstd)):
        raise ValueError("layernorm_residual_bwd: x, residual, dy, mean and rstd must be "
                         "contiguous")
    if mean.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise TypeError("layernorm_residual_bwd: mean/rstd must be float32")
    w = w.float().contiguous()
    variant, per_block, nblocks = _bwd_plan(rows, h, x2.dtype, _sm_count(x2.device.index))
    if variant == "row" and any(t.data_ptr() % 16 for t in (x2, r2, dy2, w)):
        raise ValueError("layernorm_residual_bwd: x, residual, dy and weight must be 16-byte "
                         "aligned")
    da = torch.empty_like(x2)
    dwp = torch.empty(nblocks, h, device=x2.device, dtype=torch.float32)
    dbp = torch.empty(nblocks, h, device=x2.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = _bind("layernorm_residual_bwd", "ptt_layernorm_residual_bwd", _BWD_ARGS)(
            x2.data_ptr(), r2.data_ptr(), w.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dy2.data_ptr(), da.data_ptr(), dwp.data_ptr(), dbp.data_ptr(), rows, h, per_block,
            _DTYPES[x2.dtype], stream)
    _build.check(err, "layernorm_residual_bwd")
    with _count_lock:
        BWD_LAUNCHES += 1
    return da, dwp, dbp


class _LayerNormResidual(torch.autograd.Function):
    """Forward and backward through the two entries above (the module's
    names are looked up at call time)."""

    @staticmethod
    def forward(ctx, x2, r2, w, b, eps):
        y, mean, rstd = layernorm_residual_fwd(x2, r2, w, b, eps)
        ctx.save_for_backward(x2, r2, w, mean, rstd)
        ctx.b_dtype = b.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, r2, w, mean, rstd = ctx.saved_tensors
        da, dwp, dbp = layernorm_residual_bwd(x2, r2, w, mean, rstd, dy.contiguous())
        return da, da, dwp.sum(0).to(w.dtype), dbp.sum(0).to(ctx.b_dtype), None


def layernorm_residual(x, residual, weight, bias, epsilon=1e-5):
    """Fused ``LayerNorm(x + residual)`` over the last dimension of any-rank
    ``x``, differentiable in all four inputs; ``weight``/``bias`` are the
    affine parameters ``[H]``."""
    h = x.shape[-1]
    y = _LayerNormResidual.apply(x.reshape(-1, h), residual.reshape(-1, h), weight, bias,
                                 float(epsilon))
    return y.reshape(x.shape)
