"""Fused momentum / L2-decay update in place: the CUDA kernel and its plain version.

Replaces ``paddle_tpu/ops/pallas/optimizer_update.py`` ``_pallas_update``:
one pass over param, grad and velocity computes ::

    g' = grad + wd * param          (when wd != 0)
    v' = mu * velocity + g'
    p' = param - lr * (g' + mu * v')   (Nesterov)
       | param - lr * v'               (plain)

and writes ``p'`` and ``v'`` over ``param`` and ``velocity``
(``csrc/optimizer_update.cu``). Memory bound: five float32 streams for a
few flops an element. Every operation rounds on its own, in the order of
:func:`_plain_update` (the JAX package's ``_jnp_update``), so the kernel
equals the plain version bit for bit. Every parameter takes the kernel,
whatever its size: the TPU's ``size >= 128`` rule (``:131-135``) was its
tiling's.

A tensor on the CPU takes :func:`_plain_update` (and is written in
place the same way); a tensor on the card launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

__all__ = ["fused_momentum_update", "LAUNCHES"]

#: kernel launches since the last reset (counted where the kernel launches)
LAUNCHES = 0
_count_lock = threading.Lock()

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _plain_update(param, grad, velocity, lr, mu, wd, nesterov):
    """``(new_param, new_velocity)``: the update's expression, op by op
    (``_jnp_update``)."""
    g = grad + wd * param if wd else grad
    v = mu * velocity + g
    if nesterov:
        return param - lr * (g + mu * v), v
    return param - lr * v, v


@torch.no_grad()
def fused_momentum_update(param, grad, velocity, lr, momentum=0.9, weight_decay=0.0,
                          use_nesterov=False):
    """One momentum (+ L2 decay) step of ``param``, written over ``param``
    and ``velocity``, which it returns. ``lr`` is a Python number."""
    global LAUNCHES
    mu, wd, lr = float(momentum), float(weight_decay), float(lr)
    if not (param.shape == grad.shape == velocity.shape):
        raise ValueError(f"fused_momentum_update: param {tuple(param.shape)}, grad "
                         f"{tuple(grad.shape)} and velocity {tuple(velocity.shape)} differ")
    tensors = (param, grad, velocity)
    if all(t.device.type == "cpu" for t in tensors):
        new_p, new_v = _plain_update(param, grad, velocity, lr, mu, wd, use_nesterov)
        param.copy_(new_p)
        velocity.copy_(new_v)
        return param, velocity
    if param.device.type != "cuda" or any(t.device != param.device for t in tensors):
        raise ValueError("fused_momentum_update: all tensors must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"fused_momentum_update: the kernel takes float32, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_momentum_update: param, grad and velocity must be contiguous")
    if param.numel() == 0:  # nothing is launched or counted
        return param, velocity
    with torch.cuda.device(param.device):
        fn = _build.library("optimizer_update").ptt_momentum_update
        if fn.argtypes is None:
            fn.argtypes = _ARGS
            fn.restype = ctypes.c_int
        err = fn(param.data_ptr(), grad.data_ptr(), velocity.data_ptr(), param.numel(), lr, mu,
                 wd, int(bool(use_nesterov)), torch.cuda.current_stream(param.device).cuda_stream)
    _build.check(err, "fused_momentum_update")
    with _count_lock:
        LAUNCHES += 1
    return param, velocity
