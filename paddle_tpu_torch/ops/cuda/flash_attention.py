"""Flash-attention forward: the CUDA kernel and its plain version.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py`` ``_fwd_core`` /
``_pallas_fwd`` (tiled) and ``_fwd_small_core`` / ``_pallas_fwd_small``
(whole sequence per program): fused attention over ``[B, H, L, D]``
operands with an additive bias broadcastable to ``[B, H, Lq, Lk]``, an
optional causal mask, and the per-row logsumexp.

On the H100 the kernel is bound by arithmetic (``4*B*H*Lq*Lk*D`` flops on
the FP32 units against a few MB of operands). The kernel
(``csrc/flash_attention.cu``) stages K/V tiles through shared memory for
64 query rows at a time and keeps the online-softmax state in registers,
so the score matrix never reaches device memory; it reads the bias
through its strides, so a padding mask stays ``[B, 1, 1, Lk]``. One
kernel covers both TPU variants. This slice runs float32 without dropout:
``dropout_rate > 0`` raises. A tensor on the CPU takes
:func:`_plain_attention`; a tensor on the card launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "LAUNCHES"]

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)

#: kernel launches since the last reset (counted where the kernel launches)
LAUNCHES = 0
_count_lock = threading.Lock()


def _plain_attention(q, k, v, bias, causal, scale):
    """The plain version (``_plain_attention`` of the JAX package, without
    dropout): scores scaled, causal-masked, biased, softmaxed in f32,
    times ``v``."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        iq = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        ik = torch.arange(lk, device=q.device)[None, :]
        scores = torch.where(iq >= ik, scores, torch.full_like(scores, _NEG_INF))
    if bias is not None:
        scores = scores + bias.float()
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def _lib():
    fn = _build.library("flash_attention").ptt_flash_attention_fwd
    if fn.argtypes is None:
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i64, i64, i64, i64, vp, vp, i32, i32, i32, i32, i32,
                       ctypes.c_float, i32, vp]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, bias):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, L, D]")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if bias is not None and bias.dim() != 4:
        raise ValueError(f"flash_attention: bias must be rank 4, got {tuple(bias.shape)}")


def flash_attention_fwd(q, k, v, bias=None, causal=False, scale=None):
    """``(out, lse)`` on the card: ``out`` ``[B, H, Lq, D]`` and the f32
    logsumexp ``lse`` ``[B*H, Lq]``. CUDA tensors only."""
    global LAUNCHES
    _check(q, k, v, bias)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if b * h == 0 or lq == 0:  # no query rows: nothing is launched or counted
        return torch.empty_like(q), q.new_empty(b * h, lq, dtype=torch.float32)
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v)):
        raise ValueError("flash_attention_fwd: q, k, v must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("flash_attention_fwd: the kernel takes float32 q, k, v")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} not in {_HEAD_DIMS}")
    if lk == 0:
        raise ValueError("flash_attention_fwd: no keys")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention_fwd: q, k, v must be contiguous and 16-byte "
                             "aligned")
    if scale is None:
        scale = float(d) ** -0.5
    if bias is not None:
        if bias.device != q.device:
            raise ValueError("flash_attention_fwd: bias must be on the device of q")
        # stride 0 on broadcast dims: the mask is read in place, never expanded
        bias = bias.float().expand(b, h, lq, lk)
        strides = bias.stride()
        bias_ptr = bias.data_ptr()
    else:
        strides, bias_ptr = (0, 0, 0, 0), None
    out = torch.empty_like(q)
    lse = torch.empty(b * h, lq, device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *strides,
                     out.data_ptr(), lse.data_ptr(), b, h, lq, lk, d, float(scale),
                     int(bool(causal)), stream)
    _build.check(err, "flash_attention_fwd")
    with _count_lock:
        LAUNCHES += 1
    return out, lse


def flash_attention(q, k, v, bias=None, causal=False, scale=None, dropout_rate=0.0):
    """Fused attention over ``[B, H, L, D]`` operands with an additive
    ``bias`` broadcastable to ``[B, H, Lq, Lk]``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Attention dropout (the training path) is not ported yet:
    ``dropout_rate > 0`` raises on every device.
    """
    if float(dropout_rate) > 0.0:
        raise NotImplementedError(
            "flash_attention: attention dropout is not ported yet; use dropout_rate=0.0 (eval)")
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if q.device.type == "cpu":
        _check(q, k, v, bias)
        return _plain_attention(q, k, v, bias, causal, scale)
    out, _ = flash_attention_fwd(q, k, v, bias, causal, scale)
    return out
