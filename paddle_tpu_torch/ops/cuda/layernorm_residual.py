"""Fused residual-add + LayerNorm forward: the CUDA kernel and its plain version.

Replaces ``paddle_tpu/ops/pallas/layernorm_residual.py`` ``_fwd_kernel`` /
``_pallas_fwd``: ``y = LayerNorm(x + res) * w + b`` over the last dim, with
the f32 per-row ``mean`` and ``rstd`` the backward will reuse.

On the H100 the kernel is bound by device memory: x and res are read once
and y written once, with a handful of flops per element. The kernel
(``csrc/layernorm_residual.cu``) keeps each row in registers, so the sum
``x + res`` never goes to device memory, and takes the variance two-pass
over those registers. A tensor on the CPU takes :func:`_reference`; a
tensor on the card launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

__all__ = ["layernorm_residual", "layernorm_residual_fwd", "LAUNCHES"]

_MAX_H = 16384
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (counted where the kernel launches)
LAUNCHES = 0
_count_lock = threading.Lock()


def _reference(x2, r2, w, b, eps):
    """The plain version: the add in the input dtype, f32 statistics, the
    output cast back to the input dtype (``_reference`` / ``_fwd_kernel``
    of the JAX package). Returns ``(y, mean, rstd)`` with f32
    ``mean``/``rstd`` of shape ``[rows]``."""
    a = (x2 + r2).float()
    mean = a.mean(dim=-1, keepdim=True)
    var = (a - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (a - mean) * rstd * w.float() + b.float()
    return y.to(x2.dtype), mean.squeeze(-1), rstd.squeeze(-1)


def _lib():
    lib = _build.library("layernorm_residual")
    fn = lib.ptt_layernorm_residual_fwd
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def _check(x2, r2, w, b):
    if x2.dim() != 2 or r2.shape != x2.shape:
        raise ValueError(f"layernorm_residual: x {tuple(x2.shape)} and residual "
                         f"{tuple(r2.shape)} must be the same [rows, H]")
    h = x2.shape[1]
    if w.shape != (h,) or b.shape != (h,):
        raise ValueError(f"layernorm_residual: weight/bias must be [{h}], got "
                         f"{tuple(w.shape)}/{tuple(b.shape)}")
    if r2.dtype != x2.dtype:
        raise ValueError(f"layernorm_residual: x is {x2.dtype}, residual {r2.dtype}")


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
    if x2.device.type != "cuda" or any(t.device != x2.device for t in (r2, w, b)):
        raise ValueError("layernorm_residual: all tensors must be on one CUDA device")
    if x2.dtype not in _DTYPES:
        raise TypeError(f"layernorm_residual: kernel takes float32/bfloat16, got {x2.dtype}")
    h = x2.shape[1]
    if not 0 < h <= _MAX_H:
        raise ValueError(f"layernorm_residual: kernel takes 0 < H <= {_MAX_H}, got {h}")
    if not (x2.is_contiguous() and r2.is_contiguous()):
        raise ValueError("layernorm_residual: x and residual must be contiguous")
    w = w.float().contiguous()
    b = b.float().contiguous()
    y = torch.empty_like(x2)
    mean = torch.empty(rows, device=x2.device, dtype=torch.float32)
    rstd = torch.empty(rows, device=x2.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = _lib()(x2.data_ptr(), r2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                     mean.data_ptr(), rstd.data_ptr(), rows, h, float(eps), _DTYPES[x2.dtype],
                     stream)
    _build.check(err, "layernorm_residual_fwd")
    with _count_lock:
        LAUNCHES += 1
    return y, mean, rstd


def layernorm_residual(x, residual, weight, bias, epsilon=1e-5):
    """Fused ``LayerNorm(x + residual)`` over the last dimension of any-rank
    ``x``; ``weight``/``bias`` are the affine parameters ``[H]``."""
    h = x.shape[-1]
    y, _, _ = layernorm_residual_fwd(x.reshape(-1, h), residual.reshape(-1, h), weight, bias,
                                     float(epsilon))
    return y.reshape(x.shape)
