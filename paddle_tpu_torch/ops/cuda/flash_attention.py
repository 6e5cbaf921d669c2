"""Flash attention, forward and backward: the CUDA kernels and their plain versions.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py``: the forward
``_fwd_core`` / ``_pallas_fwd`` (tiled) and ``_fwd_small_core`` /
``_pallas_fwd_small`` (whole sequence per program), and the backward
``_dq_core`` / ``_dkv_core`` of ``_pallas_bwd`` and ``_bwd_small_core`` /
``_pallas_bwd_small``: fused attention over ``[B, H, L, D]`` operands with
an additive bias broadcastable to ``[B, H, Lq, Lk]``, an optional causal
mask, dropout on the attention probabilities, and the per-row logsumexp
the backward recomputes the probabilities from.

On the H100 the kernels are bound by arithmetic on the FP32 units
(``4``, ``6`` and ``8 * B*H*Lq*Lk*D`` flops for the forward, dQ and dK/dV
against a few MB of operands). The forward (``csrc/flash_attention.cu``)
stages K/V tiles through shared memory for 64 query rows at a time and
keeps the online-softmax state in registers; the dQ and dK/dV kernels
(``csrc/flash_attention_bwd.cu``) do the same over key tiles and query
tiles, each block writing its own rows, so no atomics. All three read the
bias through its strides, so a padding mask stays ``[B, 1, 1, Lk]``. One
set of kernels covers both TPU variants.

Dropout: an entry ``(b, h, iq, ik)`` is dropped where its 32 random bits
are below ``rate * 2**32`` (``_drop_threshold`` of the JAX package) and
the kept ones are scaled by ``1 / (1 - rate)``. The bits are Philox4x32-10
(``csrc/philox.cuh``) under a 64-bit seed drawn once per call from an
explicit ``torch.Generator``, counted by ``(ik // 4, iq, b*H + h, 0)``,
word ``ik % 4``: a pure function of the seed and the coordinates, so every
kernel regenerates the forward's mask whatever its tiling, and
:func:`philox4x32_10` computes the same bits with integer tensor ops.

:func:`flash_attention` takes the plain version, with autograd through it,
for tensors on the CPU, and a ``torch.autograd.Function`` over the kernel
entries for tensors on the card, which launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ...framework import random as _random
from . import _build

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "philox4x32_10",
           "dropout_keep_mask", "LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES"]

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)

#: kernel launches since the last reset (counted where each kernel launches)
LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
_count_lock = threading.Lock()

# -- Philox4x32-10 on int64 tensors holding uint32 values --------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(m: int, x):
    """High and low 32 bits of ``m * x`` (``m`` a uint32 constant, ``x`` an
    int64 tensor of uint32 values): ``m`` is split into 16-bit halves so
    every partial product fits in int64."""
    p1 = x * (m >> 16)      # < 2**48
    p0 = x * (m & 0xFFFF)   # < 2**48
    s = ((p1 & 0xFFFF) << 16) + p0
    return (p1 >> 16) + (s >> 32), s & _U32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11; cuRAND's
    ``curand_Philox4x32_10``) over int64 tensors or ints holding uint32
    values: counter ``(c0, c1, c2, c3)``, key ``(k0, k1)``. Returns the four
    output words, the same as ``csrc/philox.cuh``."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & _U32
        k1 = (k1 + _W1) & _U32
    return c0, c1, c2, c3


def _drop_threshold(rate: float) -> int:
    """uint32 cutoff: drop where the random bits < rate * 2**32."""
    return min(int(rate * 2**32), 2**32 - 1)


def dropout_keep_mask(seed, b, h, lq, lk, rate):
    """The kernels' dropout mask as a bool ``[b, h, lq, lk]`` tensor on the
    seed's device: True where an entry is kept."""
    dev = seed.device
    words = seed.to(torch.int64) & _U32
    nq = (lk + 3) // 4
    i64 = dict(device=dev, dtype=torch.int64)
    quad = torch.arange(nq, **i64).view(1, 1, nq).expand(b * h, lq, nq)
    row = torch.arange(lq, **i64).view(1, lq, 1).expand(b * h, lq, nq)
    bh = torch.arange(b * h, **i64).view(b * h, 1, 1).expand(b * h, lq, nq)
    out = philox4x32_10(quad, row, bh, torch.zeros_like(quad), words[0], words[1])
    bits = torch.stack(out, dim=-1).reshape(b * h, lq, 4 * nq)[..., :lk]
    return (bits >= _drop_threshold(rate)).reshape(b, h, lq, lk)


def _draw_seed(generator, device):
    """Two random int32 words (one 64-bit Philox key) on ``device``, drawn
    from ``generator`` (default: the device's own, ``framework.random``)
    without waiting for the device."""
    gen = _random.default_generator(device) if generator is None else generator
    seed = torch.randint(-2**31, 2**31, (2,), dtype=torch.int32, device=gen.device,
                         generator=gen)
    return seed.to(device)


# -- plain versions -----------------------------------------------------------


def _scores(q, k, bias, causal, scale):
    """Scaled, causal-masked (-1e30, bottom-right aligned), biased scores
    in at least f32."""
    ct = torch.promote_types(q.dtype, torch.float32)
    scores = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        iq = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        ik = torch.arange(lk, device=q.device)[None, :]
        scores = torch.where(iq >= ik, scores, torch.full_like(scores, _NEG_INF))
    return scores if bias is None else scores + bias.to(ct)


def _plain_attention(q, k, v, bias, causal, scale, rate=0.0, seed=None):
    """The plain version (``_plain_attention`` of the JAX package): the
    scores softmaxed in at least f32, dropped with the kernels' mask, times
    ``v``."""
    w = torch.softmax(_scores(q, k, bias, causal, scale), dim=-1)
    if rate > 0.0:
        b, h, lq, lk = w.shape
        keep = dropout_keep_mask(seed, b, h, lq, lk, rate)
        w = torch.where(keep, w * (1.0 / (1.0 - rate)), torch.zeros_like(w))
    ct = w.dtype  # the weights round to v's dtype, the product runs in ct
    return torch.matmul(w.to(v.dtype).to(ct), v.to(ct)).to(q.dtype)


def _plain_fwd(q, k, v, bias=None, causal=False, scale=None, dropout_rate=0.0, seed=None):
    """``(out, lse)`` of the plain version, as :func:`flash_attention_fwd`
    returns them (``lse`` f32 ``[B*H, Lq]``)."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    out = _plain_attention(q, k, v, bias, causal, scale, dropout_rate, seed)
    lse = torch.logsumexp(_scores(q, k, bias, causal, scale).float(), dim=-1)
    return out, lse.reshape(-1, q.shape[2])


def _plain_bwd(q, k, v, bias, out, lse, dout, causal=False, scale=None, dropout_rate=0.0,
               seed=None):
    """``(dq, dk, dv)`` of the plain version: autograd through
    :func:`_plain_attention` with the same mask (``out`` and ``lse`` are
    not needed, taken for the kernel entry's signature)."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        o = _plain_attention(*qkv, None if bias is None else bias.detach(), causal, scale,
                             dropout_rate, seed)
        return torch.autograd.grad(o, qkv, dout)


# -- kernel entries -----------------------------------------------------------

_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_COMMON = [_VP] * 4 + [_I64] * 4
_TAIL = [_I32] * 5 + [ctypes.c_float, _I32, _VP, ctypes.c_uint32, ctypes.c_float, _VP]
_ARGTYPES = {
    "flash_attention_fwd": _COMMON + [_VP, _VP] + _TAIL,
    "flash_attention_bwd_dq": _COMMON + [_VP] * 4 + _TAIL,
    "flash_attention_bwd_dkv": _COMMON + [_VP] * 5 + _TAIL,
}


def _bind(lib, name):
    fn = getattr(_build.library(lib), f"ptt_{name}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
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


def _kernel_args(name, q, k, v, bias, causal, scale, dropout_rate, seed, tensors):
    """Checks shared by the three entries; returns the C arguments before
    the outputs (q, k, v, bias and its strides) and after them (shape,
    scale, causal, dropout), and the f32 bias they point into, which the
    caller holds until the kernel is launched."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: the kernel takes float32 q, k, v")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")
    if lk == 0:
        raise ValueError(f"{name}: no keys")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: q, k, v must be contiguous and 16-byte aligned")
    if bias is not None:
        if bias.device != q.device:
            raise ValueError(f"{name}: bias must be on the device of q")
        # stride 0 on broadcast dims: the mask is read in place, never expanded
        bias = bias.float().expand(b, h, lq, lk)
        head = [bias.data_ptr(), *bias.stride()]
    else:
        head = [None, 0, 0, 0, 0]
    rate = float(dropout_rate)
    if rate > 0.0:
        if seed is None or seed.shape != (2,) or seed.dtype != torch.int32 \
                or seed.device != q.device:
            raise ValueError(f"{name}: dropout needs the int32 seed [2] on the device of q")
        drop = [seed.data_ptr(), _drop_threshold(rate), 1.0 / (1.0 - rate)]
    else:
        drop = [None, 0, 1.0]
    tail = [b, h, lq, lk, d, float(scale), int(bool(causal)), *drop,
            torch.cuda.current_stream(q.device).cuda_stream]
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), *head], tail, bias


def flash_attention_fwd(q, k, v, bias=None, causal=False, scale=None, dropout_rate=0.0,
                        seed=None):
    """``(out, lse)`` on the card: ``out`` ``[B, H, Lq, D]`` and the f32
    logsumexp ``lse`` ``[B*H, Lq]``; with ``dropout_rate > 0`` the
    probabilities are dropped with the mask of ``seed`` (int32 ``[2]`` on
    the device). CUDA tensors only."""
    global LAUNCHES
    _check(q, k, v, bias)
    b, h, lq, _ = q.shape
    if b * h == 0 or lq == 0:  # no query rows: nothing is launched or counted
        return torch.empty_like(q), q.new_empty(b * h, lq, dtype=torch.float32)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    head, tail, bias32 = _kernel_args("flash_attention_fwd", q, k, v, bias, causal, scale,
                                      dropout_rate, seed, (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(b * h, lq, device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        err = _bind("flash_attention", "flash_attention_fwd")(
            *head, out.data_ptr(), lse.data_ptr(), *tail)
    del bias32  # launched: the stream orders any reuse of its memory after the kernel
    _build.check(err, "flash_attention_fwd")
    with _count_lock:
        LAUNCHES += 1
    return out, lse


def _bwd_args(name, q, k, v, bias, lse, delta, dout, causal, scale, dropout_rate, seed):
    _check(q, k, v, bias)
    b, h, lq, d = q.shape
    if dout.shape != q.shape or lse.shape != (b * h, lq) or delta.shape != (b * h, lq):
        raise ValueError(f"{name}: dout must be shaped as q, lse and delta [B*H, Lq]")
    scale = float(d) ** -0.5 if scale is None else scale
    head, tail, bias32 = _kernel_args(name, q, k, v, bias, causal, scale, dropout_rate, seed,
                                      (q, k, v, dout, lse, delta))
    return head + [dout.data_ptr(), lse.data_ptr(), delta.data_ptr()], tail, bias32


def flash_attention_bwd_dq(q, k, v, bias, lse, delta, dout, causal=False, scale=None,
                           dropout_rate=0.0, seed=None):
    """``dq`` on the card (the dQ kernel) from the forward's ``lse``,
    ``delta = rowsum(dout * out)`` (f32 ``[B*H, Lq]``) and the forward's
    dropout ``seed``. CUDA tensors only."""
    global DQ_LAUNCHES
    b, h, lq, _ = q.shape
    if b * h == 0 or lq == 0:  # no query rows: nothing is launched or counted
        return torch.zeros_like(q)
    head, tail, bias32 = _bwd_args("flash_attention_bwd_dq", q, k, v, bias, lse, delta, dout,
                                   causal, scale, dropout_rate, seed)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _bind("flash_attention_bwd", "flash_attention_bwd_dq")(*head, dq.data_ptr(), *tail)
    del bias32  # held past the allocation of dq, which could otherwise reuse its memory
    _build.check(err, "flash_attention_bwd_dq")
    with _count_lock:
        DQ_LAUNCHES += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, bias, lse, delta, dout, causal=False, scale=None,
                            dropout_rate=0.0, seed=None):
    """``(dk, dv)`` on the card (the dK/dV kernel); arguments as
    :func:`flash_attention_bwd_dq`. CUDA tensors only."""
    global DKV_LAUNCHES
    b, h, lq, _ = q.shape
    if b * h == 0 or lq == 0:  # no query rows: nothing is launched or counted
        return torch.zeros_like(k), torch.zeros_like(v)
    head, tail, bias32 = _bwd_args("flash_attention_bwd_dkv", q, k, v, bias, lse, delta, dout,
                                   causal, scale, dropout_rate, seed)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _bind("flash_attention_bwd", "flash_attention_bwd_dkv")(
            *head, dk.data_ptr(), dv.data_ptr(), *tail)
    del bias32  # held past the allocation of dk and dv, as in the dQ entry
    _build.check(err, "flash_attention_bwd_dkv")
    with _count_lock:
        DKV_LAUNCHES += 1
    return dk, dv


def flash_attention_bwd(q, k, v, bias, out, lse, dout, causal=False, scale=None,
                        dropout_rate=0.0, seed=None):
    """``(dq, dk, dv)`` on the card from the forward's ``out`` and ``lse``
    and the output gradient ``dout``: ``delta = rowsum(dout * out)`` as
    one torch op (as the JAX package leaves it to XLA), then the dQ and
    the dK/dV kernels with the forward's dropout ``seed``. CUDA tensors
    only."""
    if out.shape != q.shape:
        raise ValueError("flash_attention_bwd: out must be shaped as q")
    delta = (dout * out).sum(-1).reshape(-1, q.shape[2])
    args = (q, k, v, bias, lse, delta, dout, causal, scale, dropout_rate, seed)
    dq = flash_attention_bwd_dq(*args)
    dk, dv = flash_attention_bwd_dkv(*args)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward and backward through the kernel entries (the module's names
    are looked up at call time)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, rate, seed):
        out, lse = flash_attention_fwd(q, k, v, bias, causal, scale, rate, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse, seed)
        ctx.cfg = (causal, scale, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse, seed = ctx.saved_tensors
        causal, scale, rate = ctx.cfg
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, out, lse, dout.contiguous(), causal,
                                         scale, rate, seed)
        dbias = None
        if bias is not None and ctx.needs_input_grad[3]:
            # exact dbias through the plain recompute, as the JAX package
            # does in XLA (rate is 0 here: flash_attention refuses a
            # trainable bias with dropout)
            with torch.enable_grad():
                bg = bias.detach().requires_grad_()
                o = _plain_attention(q.detach(), k.detach(), v.detach(), bg, causal, scale)
                (dbias,) = torch.autograd.grad(o, bg, dout)
        return dq, dk, dv, dbias, None, None, None, None


def _use_kernel(q) -> bool:
    return q.device.type != "cpu"


def flash_attention(q, k, v, bias=None, causal=False, scale=None, dropout_rate=0.0,
                    generator=None):
    """Fused attention over ``[B, H, L, D]`` operands with an additive
    ``bias`` broadcastable to ``[B, H, Lq, Lk]``, differentiable in q, k, v
    (and in the bias when ``dropout_rate`` is 0).

    ``dropout_rate > 0`` drops attention probabilities (upscale in train)
    with a seed drawn once from ``generator`` (default: the device's
    default generator, ``framework.random``). CPU tensors take the plain
    version; CUDA tensors launch the kernels.
    """
    _check(q, k, v, bias)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: q is on {q.device}; the kernels need a CUDA device "
                         "and the plain version the CPU")
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"flash_attention: dropout_rate {rate} not in [0, 1)")
    if bias is not None and bias.requires_grad and rate > 0.0:
        raise ValueError(
            "flash_attention: a trainable bias (requires_grad) cannot be combined with "
            "dropout_rate > 0; detach the bias or use dropout_rate=0.0")
    seed = _draw_seed(generator, q.device) if rate > 0.0 else None
    if not _use_kernel(q):
        return _plain_attention(q, k, v, bias, causal, scale, rate, seed)
    return _FlashAttention.apply(q, k, v, bias, causal, scale, rate, seed)
