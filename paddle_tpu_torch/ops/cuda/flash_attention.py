"""Flash attention, forward and backward: the CUDA kernels and their plain versions.

Replaces ``paddle_tpu/ops/pallas/flash_attention.py``: the forward
``_fwd_core`` / ``_pallas_fwd`` (tiled) and ``_fwd_small_core`` /
``_pallas_fwd_small`` (whole sequence per program), and the backward
``_dq_core`` / ``_dkv_core`` of ``_pallas_bwd`` and ``_bwd_small_core`` /
``_pallas_bwd_small``: fused attention over ``[B, H, L, D]`` operands with
an additive bias broadcastable to ``[B, H, Lq, Lk]``, an optional causal
mask, dropout on the attention probabilities, and the per-row logsumexp
the backward recomputes the probabilities from.

On the H100 the kernels are bound by arithmetic (``4``, ``6`` and ``8 *
B*H*Lq*Lk*D`` flops for the forward, dQ and dK/dV against a few MB of
operands). Two sets of kernels take the dtypes. float32: the forward
(``csrc/flash_attention.cu``) and the dQ and dK/dV kernels
(``csrc/flash_attention_bwd.cu``) run their products on the tensor cores in
3xTF32 (f32-accurate) on ``mma.sync``, 64 rows a block, staging K/V (or
Q/dO) tiles through shared memory. bfloat16 and float16, the AMP path: the
forward (``csrc/flash_attention_bf16.cu``) and the dQ and dK/dV kernels
(``csrc/flash_attention_bwd_bf16.cu``), templates on the element type with
an instance of each (entries ``*_bf16`` and ``*_f16``), run on ``wgmma``
from tiles that TMA loads into rings of shared-memory stages, persistent
blocks of 128 rows, with the TPU kernels' rounding points: the
probabilities and dS rounded to the 16-bit type before the products that
take them, every output rounded once (to nearest even; in float16 past
65504 to inf, so an overflow under a loss scale stays non-finite); ``lse``
and ``delta`` stay f32, and the 16-bit dQ kernels compute ``delta``
themselves. Every kernel keeps the online-softmax state in registers and
writes only its own rows, so no atomics. All read the bias through its
strides (as f32), so a padding mask stays ``[B, 1, 1, Lk]``. One set of
kernels a dtype covers both TPU variants.

Dropout: an entry ``(b, h, iq, ik)`` is dropped where its 32 random bits
are below ``rate * 2**32`` (``_drop_threshold`` of the JAX package) and
the kept ones are scaled by ``1 / (1 - rate)``. The bits are Philox4x32-10
(``csrc/philox.cuh``) under a 64-bit seed drawn once per call from an
explicit ``torch.Generator``, counted by ``(ik // 4, iq, b*H + h, 0)``,
word ``ik % 4``: a pure function of the seed and the coordinates, so every
f32 kernel regenerates the forward's mask whatever its tiling, and
:func:`philox4x32_10` computes the same bits with integer tensor ops. The
16-bit forward stores the mask it drew, one bit an entry
(:func:`keep_words`), and the 16-bit backward reads it instead of drawing it
twice more.

:func:`flash_attention` takes the plain version, with autograd through it,
for tensors on the CPU, and a ``torch.autograd.Function`` over the kernel
entries for tensors on the card, which launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ...framework import random as _random
from ...framework.autograd import amp_cast
from . import _build
from ._tally import bump, check_outputs, counted

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_delta", "flash_attention_bwd_dkv",
           "philox4x32_10", "dropout_keep_mask", "keep_words", "unpack_keep", "LAUNCHES",
           "DQ_LAUNCHES", "DKV_LAUNCHES", "BF16_LAUNCHES", "BF16_DQ_LAUNCHES",
           "BF16_DKV_LAUNCHES", "FP16_LAUNCHES", "FP16_DQ_LAUNCHES", "FP16_DKV_LAUNCHES"]

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)
# keys a tile of the bf16 forward kernel by head dim (BN of
# csrc/flash_attention_bf16.cu's launch_d), whose online softmax _plain_fwd
# follows; other head dims (the CPU's) take the widest
_KEY_TILES = {32: 128, 64: 128, 128: 64}

#: kernel launches since the last reset (counted where each kernel launches):
#: the float32 kernels, and the bfloat16 and float16 instances beside them
LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
BF16_LAUNCHES = 0
BF16_DQ_LAUNCHES = 0
BF16_DKV_LAUNCHES = 0
FP16_LAUNCHES = 0
FP16_DQ_LAUNCHES = 0
FP16_DKV_LAUNCHES = 0
_count_lock = threading.Lock()
# the 16-bit types of the wgmma kernels, and their entries' suffixes
_WGMMA_SUFFIX = {torch.bfloat16: "_bf16", torch.float16: "_f16"}
_DTYPES = (torch.float32, *_WGMMA_SUFFIX)
# the kernels' library and count by entry and dtype
_KERNELS = {
    ("flash_attention_fwd", torch.float32): ("flash_attention", "LAUNCHES"),
    ("flash_attention_bwd_dq", torch.float32): ("flash_attention_bwd", "DQ_LAUNCHES"),
    ("flash_attention_bwd_dkv", torch.float32): ("flash_attention_bwd", "DKV_LAUNCHES"),
    ("flash_attention_fwd", torch.bfloat16): ("flash_attention_bf16", "BF16_LAUNCHES"),
    ("flash_attention_bwd_dq", torch.bfloat16): ("flash_attention_bwd_bf16", "BF16_DQ_LAUNCHES"),
    ("flash_attention_bwd_dkv", torch.bfloat16): ("flash_attention_bwd_bf16",
                                                   "BF16_DKV_LAUNCHES"),
    ("flash_attention_fwd", torch.float16): ("flash_attention_bf16", "FP16_LAUNCHES"),
    ("flash_attention_bwd_dq", torch.float16): ("flash_attention_bwd_bf16", "FP16_DQ_LAUNCHES"),
    ("flash_attention_bwd_dkv", torch.float16): ("flash_attention_bwd_bf16",
                                                  "FP16_DKV_LAUNCHES"),
}

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
    return _random.draw(device, generator, lambda gen: torch.randint(
        -2**31, 2**31, (2,), dtype=torch.int32, device=gen.device, generator=gen).to(device))


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
    """``(out, lse)`` as :func:`flash_attention_fwd` returns them (``lse``
    f32 ``[B*H, Lq]``), with the forward kernels' arithmetic: the online
    softmax over tiles of :data:`_KEY_TILES` keys (a running row max, the
    sums rescaled as it grows), the unnormalized probabilities rounded to
    v's dtype before P V (``p_acc.astype(vt.dtype)`` of ``_fwd_core``),
    the output divided by the row sum and rounded once, ``lse = m +
    log(l)``. In bf16 this rounds where the kernels round, which
    :func:`_plain_attention` (the normalized weights rounded, as the JAX
    package's plain path rounds them) does not."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    s = _scores(q, k, bias, causal, scale)
    b, h, lq, lk = s.shape
    keep = dropout_keep_mask(seed, b, h, lq, lk, dropout_rate) if dropout_rate > 0.0 else None
    ct = s.dtype
    m = torch.full((b, h, lq, 1), _NEG_INF, dtype=ct, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, lq, q.shape[3], dtype=ct, device=q.device)
    tile = _KEY_TILES.get(q.shape[3], 128)
    for t0 in range(0, lk, tile):
        st = s[..., t0:t0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * corr + p.sum(-1, keepdim=True)  # the undropped probabilities
        if keep is not None:
            p = torch.where(keep[..., t0:t0 + tile], p * (1.0 / (1.0 - dropout_rate)),
                            torch.zeros_like(p))
        vt = v[..., t0:t0 + tile, :]
        acc = acc * corr + torch.matmul(p.to(v.dtype).to(ct), vt.to(ct))
        m = m_new
    lsafe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / lsafe).to(q.dtype)
    return out, (m + torch.log(lsafe)).reshape(-1, lq)


def _plain_bwd(q, k, v, bias, out, lse, dout, causal=False, scale=None, dropout_rate=0.0,
               seed=None):
    """``(dq, dk, dv)`` of the plain version, with the kernels' arithmetic
    (``_dq_core`` / ``_dkv_core`` of the JAX package): ``delta =
    rowsum(dout * out)`` and the probabilities in at least f32, ``dS`` and
    the dropped probabilities rounded to q's dtype before the products that
    take them, each gradient rounded to its input's dtype once. ``out``
    None recomputes it; ``lse`` is not needed (the softmax recomputes it)
    and is taken for the kernel entry's signature."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    if out is None:
        out = _plain_fwd(q, k, v, bias, causal, scale, dropout_rate, seed)[0]
    ct = torch.promote_types(q.dtype, torch.float32)
    s = _scores(q, k, bias, causal, scale)
    p = torch.softmax(s, dim=-1)  # a row that sees no key comes out uniform
    dp = torch.matmul(dout.to(ct), v.to(ct).transpose(-1, -2))
    pv = p
    if dropout_rate > 0.0:
        b, h, lq, lk = p.shape
        keep = dropout_keep_mask(seed, b, h, lq, lk, dropout_rate)
        inv = 1.0 / (1.0 - dropout_rate)
        pv = torch.where(keep, p * inv, torch.zeros_like(p))
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
    delta = (dout.to(ct) * out.to(ct)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if causal:  # masked scores pass no gradient
        lq, lk = s.shape[-2], s.shape[-1]
        iq = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        ik = torch.arange(lk, device=q.device)[None, :]
        ds = torch.where(iq >= ik, ds, torch.zeros_like(ds))
    ds = ds.to(q.dtype).to(ct)
    dq = (torch.matmul(ds, k.to(ct)) * scale).to(q.dtype)
    dk = (torch.matmul(ds.transpose(-1, -2), q.to(ct)) * scale).to(k.dtype)
    dv = torch.matmul(pv.to(v.dtype).to(ct).transpose(-1, -2), dout.to(ct)).to(v.dtype)
    return dq, dk, dv


# -- kernel entries -----------------------------------------------------------

_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_COMMON = [_VP] * 4 + [_I64] * 4
_SHAPE = [_I32] * 5 + [ctypes.c_float, _I32]  # batch, heads, lq, lk, d, scale, causal
_TAIL = _SHAPE + [_VP, ctypes.c_uint32, ctypes.c_float, _VP]  # seed, threshold, 1/keep, stream
# the 16-bit backward reads the forward's stored mask in place of the seed
_TAIL_KEEP = _SHAPE + [_VP, ctypes.c_float, _VP]
_ARGTYPES = {
    "flash_attention_fwd": _COMMON + [_VP, _VP] + _TAIL,
    "flash_attention_bwd_dq": _COMMON + [_VP] * 4 + _TAIL,
    "flash_attention_bwd_dkv": _COMMON + [_VP] * 5 + _TAIL,
}
for _sfx in _WGMMA_SUFFIX.values():  # the bf16 and fp16 instances take the same arguments
    _ARGTYPES.update({
        f"flash_attention_fwd{_sfx}": _COMMON + [_VP] * 3 + _TAIL,  # out, lse, the mask's words
        # dout, lse, delta (written), out and dq
        f"flash_attention_bwd_dq{_sfx}": _COMMON + [_VP] * 5 + _TAIL_KEEP,
        f"flash_attention_bwd_dkv{_sfx}": _COMMON + [_VP] * 5 + _TAIL_KEEP,
    })


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


def keep_words(b, h, lq, lk, device):
    """An empty int32 ``[b*h, lq, ceil(lk / 32)]`` tensor for the 16-bit
    kernels' stored dropout mask: bit ``ik % 32`` of word ``ik // 32`` of
    row ``iq`` is set where entry ``(iq, ik)`` is kept."""
    return torch.empty(b * h, lq, (lk + 31) // 32, dtype=torch.int32, device=device)


def unpack_keep(keep, b, h, lq, lk):
    """The bool ``[b, h, lq, lk]`` mask a :func:`keep_words` tensor holds."""
    bits = torch.arange(32, device=keep.device, dtype=torch.int32)
    mask = (keep.unsqueeze(-1) >> bits) & 1  # [b*h, lq, words, 32]
    return mask.reshape(b * h, lq, -1)[..., :lk].reshape(b, h, lq, lk).bool()


def _kernel_args(name, q, k, v, bias, causal, scale, tensors, stats=()):
    """Checks shared by the entries; returns the C arguments before the
    outputs (q, k, v, bias and its strides) and the shape, scale and causal
    flag after them, and the f32 bias they point into, which the caller
    holds until the kernel is launched. ``tensors`` (q, k, v and dout) are
    all float32, all bfloat16 or all float16; ``stats`` (lse, delta)
    float32."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if (q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors)
            or any(t.dtype != torch.float32 for t in stats)):
        raise TypeError(f"{name}: the kernels take float32, bfloat16 or float16 q, k, v (one "
                        f"dtype) and float32 statistics, got "
                        f"{[str(t.dtype) for t in tensors + stats]}")
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors + stats):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_HEAD_DIMS}")
    if lk == 0:
        raise ValueError(f"{name}: no keys")
    for t in tensors + stats:
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
    tail = [b, h, lq, lk, d, float(scale), int(bool(causal))]
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), *head], tail, bias


def _seed_args(name, q, dropout_rate, seed):
    """The dropout arguments of the kernels that draw the mask: the seed,
    the drop threshold and the kept entries' scale."""
    rate = float(dropout_rate)
    if rate == 0.0:
        return [None, 0, 1.0]
    if seed is None or seed.shape != (2,) or seed.dtype != torch.int32 or seed.device != q.device:
        raise ValueError(f"{name}: dropout needs the int32 seed [2] on the device of q")
    return [seed.data_ptr(), _drop_threshold(rate), 1.0 / (1.0 - rate)]


def _keep_args(name, q, k, dropout_rate, keep):
    """The dropout arguments of the 16-bit backward kernels, which read the
    mask the 16-bit forward stored (:func:`keep_words`), and the kept
    entries' scale."""
    rate = float(dropout_rate)
    if rate == 0.0:
        return [None, 1.0]
    b, h, lq, _ = q.shape
    if (keep is None or keep.dtype != torch.int32 or keep.device != q.device
            or keep.shape != (b * h, lq, (k.shape[2] + 31) // 32) or not keep.is_contiguous()):
        raise ValueError(f"{name}: the 16-bit backward reads the dropout mask the 16-bit "
                         "forward returned, keep_words(B, H, Lq, Lk) on the device of q")
    return [keep.data_ptr(), 1.0 / (1.0 - rate)]


def _launch(name, dtype, args):
    """Launch the entry ``name``'s kernel for ``dtype`` on ``args`` and the
    current stream, and count it."""
    lib, counter = _KERNELS[(name, dtype)]
    symbol = name + _WGMMA_SUFFIX.get(dtype, "")
    err = _bind(lib, symbol)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(err, symbol)
    with _count_lock:
        bump(globals(), counter)


def _checked(name, dtype, *outs):
    """Hand the outputs of the entry ``name``'s kernel for ``dtype`` to the
    NaN check (``_tally.check_outputs``)."""
    check_outputs(globals(), _KERNELS[(name, dtype)][1], *outs)


def _pairs(lq, lk, causal):
    """The (query, key) pairs attention computes: all of them, or under
    ``causal`` (bottom-right aligned) those with ``i + lk - lq >= j``."""
    if not causal:
        return lq * lk
    off = lk - lq
    return sum(min(lk, max(0, i + off + 1)) for i in range(lq))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _bias_bytes(bias):
    """A bias operand's bytes, its broadcast dimensions counted once."""
    if bias is None:
        return 0
    n = bias.element_size()
    for size, stride in zip(bias.shape, bias.stride()):
        n *= size if stride else 1
    return n


def _products(q, k, causal, count):
    """``count`` products of ``[Lq, D]`` by ``[D, Lk]`` for every (batch,
    head): ``2·count·B·H·pairs·D`` FLOPs."""
    b, h, lq, d = q.shape
    return 2 * count * b * h * _pairs(lq, k.shape[2], causal) * d


def _fwd_cost(q, k, v, bias=None, causal=False, scale=None, dropout_rate=0.0, seed=None):
    """The forward's work (``PERF.md`` rows 3-4): ``4·B·H·L²·D`` FLOPs
    (QKᵀ and PV, counted once also in 3xTF32); q, k, v and the bias read,
    out and the f32 lse written; a stored dropout mask left out."""
    return (_products(q, k, causal, 2),
            _nbytes(q, k, v) + _bias_bytes(bias) + _nbytes(q) + 4 * q.shape[0] * q.shape[1]
            * q.shape[2])


def _dq_cost(q, k, v, bias, lse, delta, dout, causal=False, scale=None, dropout_rate=0.0,
             seed=None):
    """dQ's work (row 6): ``6·B·H·L²·D`` FLOPs (S, dP and dQ); its inputs
    read and dq written."""
    return (_products(q, k, causal, 3),
            _nbytes(q, k, v, lse, delta, dout) + _bias_bytes(bias) + _nbytes(q))


def _dq_delta_cost(q, k, v, bias, lse, out, dout, causal=False, scale=None, dropout_rate=0.0,
                   keep=None):
    """The 16-bit dQ's work (rows 6b, 6h): as :func:`_dq_cost`, reading O for
    delta, which it writes."""
    return (_products(q, k, causal, 3),
            _nbytes(q, k, v, lse, out, dout) + _bias_bytes(bias) + _nbytes(q, lse))


def _dkv_cost(q, k, v, bias, lse, delta, dout, causal=False, scale=None, dropout_rate=0.0,
              drop=None):
    """dK/dV's work (row 7): ``8·B·H·L²·D`` FLOPs (S, dP, dV and dK); its
    inputs read, dk and dv written."""
    return (_products(q, k, causal, 4),
            _nbytes(q, k, v, lse, delta, dout) + _bias_bytes(bias) + _nbytes(k, v))


@counted(_fwd_cost)
def flash_attention_fwd(q, k, v, bias=None, causal=False, scale=None, dropout_rate=0.0,
                        seed=None):
    """``(out, lse)`` on the card: ``out`` ``[B, H, Lq, D]`` in q's dtype
    (float32, bfloat16 or float16) and the f32 logsumexp ``lse`` ``[B*H,
    Lq]``; with ``dropout_rate > 0`` the probabilities are dropped with the
    mask of ``seed`` (int32 ``[2]`` on the device). bfloat16 or float16 with
    dropout returns ``(out, lse, keep)``: the kernel also stores the mask it
    drew (:func:`keep_words`), which the 16-bit backward reads in place of
    the seed. CUDA tensors only."""
    _check(q, k, v, bias)
    b, h, lq, _ = q.shape
    stores = q.dtype in _WGMMA_SUFFIX and float(dropout_rate) > 0.0
    out, lse = torch.empty_like(q), q.new_empty(b * h, lq, dtype=torch.float32)
    keep = keep_words(b, h, lq, k.shape[2], q.device) if stores else None
    if b * h and lq:  # else no query rows: nothing is launched or counted
        if scale is None:
            scale = float(q.shape[-1]) ** -0.5
        head, tail, bias32 = _kernel_args("flash_attention_fwd", q, k, v, bias, causal, scale,
                                          (q, k, v))
        outs = [out.data_ptr(), lse.data_ptr()]
        if q.dtype in _WGMMA_SUFFIX:
            outs.append(None if keep is None else keep.data_ptr())
        tail += _seed_args("flash_attention_fwd", q, dropout_rate, seed)
        with torch.cuda.device(q.device):
            _launch("flash_attention_fwd", q.dtype, [*head, *outs, *tail])
        _checked("flash_attention_fwd", q.dtype, out, lse)
        del bias32  # launched: the stream orders any reuse of its memory after the kernel
    return (out, lse, keep) if stores else (out, lse)


def _bwd_args(name, q, k, v, bias, lse, delta, dout, causal, scale, more=()):
    _check(q, k, v, bias)
    b, h, lq, d = q.shape
    if dout.shape != q.shape or lse.shape != (b * h, lq) or delta.shape != (b * h, lq):
        raise ValueError(f"{name}: dout must be shaped as q, lse and delta [B*H, Lq]")
    scale = float(d) ** -0.5 if scale is None else scale
    head, tail, bias32 = _kernel_args(name, q, k, v, bias, causal, scale,
                                      (q, k, v, dout, *more), (lse, delta))
    return head + [dout.data_ptr(), lse.data_ptr(), delta.data_ptr()], tail, bias32


@counted(_dq_cost)
def flash_attention_bwd_dq(q, k, v, bias, lse, delta, dout, causal=False, scale=None,
                           dropout_rate=0.0, seed=None):
    """``dq`` on the card (the float32 dQ kernel) from the forward's
    ``lse``, ``delta = rowsum(dout * out)`` (f32 ``[B*H, Lq]``) and the
    forward's dropout ``seed``. The 16-bit dQ kernels compute delta
    themselves: :func:`flash_attention_bwd_dq_delta`. CUDA tensors only."""
    b, h, lq, _ = q.shape
    if b * h == 0 or lq == 0:  # no query rows: nothing is launched or counted
        return torch.zeros_like(q)
    head, tail, bias32 = _bwd_args("flash_attention_bwd_dq", q, k, v, bias, lse, delta, dout,
                                   causal, scale)
    if q.dtype != torch.float32:
        raise TypeError("flash_attention_bwd_dq: the 16-bit dQ kernels compute delta "
                        "themselves; call flash_attention_bwd_dq_delta")
    tail += _seed_args("flash_attention_bwd_dq", q, dropout_rate, seed)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("flash_attention_bwd_dq", q.dtype, [*head, dq.data_ptr(), *tail])
        _checked("flash_attention_bwd_dq", q.dtype, dq)
    del bias32  # held past the allocation of dq, which could otherwise reuse its memory
    return dq


@counted(_dq_delta_cost)
def flash_attention_bwd_dq_delta(q, k, v, bias, lse, out, dout, causal=False, scale=None,
                                 dropout_rate=0.0, keep=None):
    """``(dq, delta)`` on the card from bfloat16 or float16 operands: the
    16-bit dQ kernel computes ``delta = rowsum(dout * out)`` (f32 ``[B*H,
    Lq]``) for the query rows it owns, uses it and returns it for the dK/dV
    kernel. With dropout it reads the mask ``keep`` the 16-bit forward
    returned. CUDA tensors only."""
    b, h, lq, _ = q.shape
    if q.dtype not in _WGMMA_SUFFIX:
        raise TypeError(f"flash_attention_bwd_dq_delta: the fused delta takes bfloat16 or "
                        f"float16, got {q.dtype}")
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("flash_attention_bwd_dq_delta: out must be shaped and typed as q")
    delta = torch.empty(b * h, lq, device=q.device, dtype=torch.float32)
    if b * h == 0 or lq == 0:  # no query rows: nothing is launched or counted
        return torch.zeros_like(q), delta
    head, tail, bias32 = _bwd_args("flash_attention_bwd_dq", q, k, v, bias, lse, delta, dout,
                                   causal, scale, (out,))
    tail += _keep_args("flash_attention_bwd_dq", q, k, dropout_rate, keep)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("flash_attention_bwd_dq", q.dtype, [*head, out.data_ptr(), dq.data_ptr(), *tail])
        _checked("flash_attention_bwd_dq", q.dtype, dq, delta)
    del bias32
    return dq, delta


@counted(_dkv_cost)
def flash_attention_bwd_dkv(q, k, v, bias, lse, delta, dout, causal=False, scale=None,
                            dropout_rate=0.0, drop=None):
    """``(dk, dv)`` on the card (the dK/dV kernel) from the forward's
    ``lse``, ``delta = rowsum(dout * out)`` (f32 ``[B*H, Lq]``) and, with
    dropout, ``drop``: the forward's seed in float32, the mask the forward
    returned in bfloat16 and float16. CUDA tensors only."""
    b, h, lq, _ = q.shape
    if b * h == 0 or lq == 0:  # no query rows: nothing is launched or counted
        return torch.zeros_like(k), torch.zeros_like(v)
    head, tail, bias32 = _bwd_args("flash_attention_bwd_dkv", q, k, v, bias, lse, delta, dout,
                                   causal, scale)
    if q.dtype in _WGMMA_SUFFIX:
        tail += _keep_args("flash_attention_bwd_dkv", q, k, dropout_rate, drop)
    else:
        tail += _seed_args("flash_attention_bwd_dkv", q, dropout_rate, drop)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("flash_attention_bwd_dkv", q.dtype, [*head, dk.data_ptr(), dv.data_ptr(), *tail])
        _checked("flash_attention_bwd_dkv", q.dtype, dk, dv)
    del bias32  # held past the allocation of dk and dv, as in the dQ entry
    return dk, dv


def flash_attention_bwd(q, k, v, bias, out, lse, dout, causal=False, scale=None,
                        dropout_rate=0.0, drop=None):
    """``(dq, dk, dv)`` on the card from the forward's ``out`` and ``lse``
    and the output gradient ``dout``, with dropout from ``drop`` (the
    forward's seed in float32, the mask it returned in bfloat16 and
    float16): the dQ kernel, then the dK/dV kernel. ``delta = rowsum(dout *
    out)`` (f32) comes in the 16-bit types from the dQ kernel itself
    (:func:`flash_attention_bwd_dq_delta`) and in float32 from one torch op
    before it (as the JAX package leaves it to XLA). CUDA tensors only."""
    if out.shape != q.shape:
        raise ValueError("flash_attention_bwd: out must be shaped as q")
    if q.dtype in _WGMMA_SUFFIX:
        dq, delta = flash_attention_bwd_dq_delta(q, k, v, bias, lse, out, dout, causal, scale,
                                                 dropout_rate, drop)
        dk, dv = flash_attention_bwd_dkv(q, k, v, bias, lse, delta, dout, causal, scale,
                                         dropout_rate, drop)
        return dq, dk, dv
    delta = (dout.float() * out.float()).sum(-1).reshape(-1, q.shape[2])
    args = (q, k, v, bias, lse, delta, dout, causal, scale, dropout_rate, drop)
    dq = flash_attention_bwd_dq(*args)
    dk, dv = flash_attention_bwd_dkv(*args)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward and backward through the kernel entries (the module's names
    are looked up at call time)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, rate, seed):
        if q.dtype in _WGMMA_SUFFIX and rate > 0.0:
            # the 16-bit forward returns the mask it drew, which its backward reads
            out, lse, drop = flash_attention_fwd(q, k, v, bias, causal, scale, rate, seed)
        else:
            (out, lse), drop = flash_attention_fwd(q, k, v, bias, causal, scale, rate, seed), seed
        ctx.save_for_backward(q, k, v, bias, out, lse, drop)
        ctx.cfg = (causal, scale, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse, drop = ctx.saved_tensors
        causal, scale, rate = ctx.cfg
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, out, lse, dout.contiguous(), causal,
                                         scale, rate, drop)
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
    version; CUDA tensors launch the kernels of their dtype (float32 or,
    under AMP, bfloat16 or float16).
    """
    q, k, v, bias = amp_cast("flash_attention", [q, k, v, bias])
    _check(q, k, v, bias)
    if q.device.type != "cpu" and q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: the kernels take float32, bfloat16 or float16, got "
                        f"{q.dtype}")
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
