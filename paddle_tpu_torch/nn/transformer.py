"""Transformer stack of the serving, training, seq2seq and generation paths (``paddle_tpu/nn/transformer.py``).

The attention with its flash dispatch (``:290-327`` of the JAX module; a
separate key and value make it cross-attention), the post-norm encoder and
decoder layers whose residual-add + LayerNorm pairs go through the fused
kernel (``_residual_norm``, ``:28-43``), the encoder and decoder stacks and
the encoder-decoder ``Transformer`` (``:576-704``).

Incremental decoding (``:74-205``, ``:251-505``): a ``cache`` argument is
the concat cache ``(k, v)`` of :meth:`MultiHeadAttention.gen_cache`, which
grows by the step's keys and values, or one of four fixed-shape caches:

- :class:`StaticCache`, the ring ``[B, H, C, D]`` of
  :meth:`MultiHeadAttention.gen_static_cache`;
- :class:`QuantizedStaticCache`, the ring at int8 with one f32 scale per
  written head vector (:func:`quantize_kv` on the write,
  :func:`dequantize_kv` of the whole window on the read);
- :class:`PagedStaticCache` and :class:`QuantizedPagedCache`, the same
  logical ring over a shared page pool ``[P, H, ps, D]`` through a page
  table ``[B, NP]``: the write scatters into the pool at ``(table[b, idx //
  ps], idx % ps)``, the read gathers ``pool[table]`` back into the
  ``[B, H, NP * ps, D]`` window.

The JAX package writes these caches functionally; the port writes the
step's keys and values (and scales) into the cache tensors **in place**
(``index_put_`` at each row's ``pos % C``, a span at ``(pos + t) % C``) and
hands the same tensors back, so a CUDA graph that decodes through them
writes the engine's persistent buffers. A cached call never takes the
flash kernel (the JAX package's rule), and a pre-norm block runs plain
LayerNorms: the GPT path launches none of the hand-written kernels, and
the quantized and paged reads and writes are plain PyTorch, as the JAX
package's are plain ``jnp``. ``kdim``/``vdim``, ``need_weights`` and
ring/Ulysses attention are not ported yet.
"""
from __future__ import annotations

import copy
from typing import Any, NamedTuple

import torch

from ..flags import flag
from ..ops.cuda import flash_attention, layernorm_residual
from . import functional as F
from .layer_base import Layer
from .layers import Dropout, LayerList, LayerNorm, Linear

__all__ = ["FLASH_ATTENTION_MIN_SEQ", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
           "StaticCache", "QuantizedStaticCache", "PagedStaticCache", "QuantizedPagedCache",
           "causal_mask", "quantize_kv", "dequantize_kv", "KV_QUANT_BNT", "KV_QUANT_EPS"]

# Key length from which use_flash_attention dispatches to the flash kernel.
# The value is the JAX package's; the H100 crossover is not measured yet.
# Tests may lower it to force the kernel.
FLASH_ATTENTION_MIN_SEQ = 512


def _residual_norm(norm, residual, y):
    """Post-norm ``LayerNorm(residual + y)`` through the fused residual-add +
    LayerNorm kernel (``FLAGS_use_fused_layernorm``) when the norm is a
    plain last-dim LayerNorm with affine parameters."""
    if (flag("use_fused_layernorm") and isinstance(norm, LayerNorm)
            and norm.weight is not None and norm.bias is not None
            and len(norm.normalized_shape) == 1):
        return layernorm_residual.layernorm_residual(y, residual, norm.weight, norm.bias,
                                                     norm.epsilon)
    return norm(residual + y)


def _convert_attention_mask(attn_mask, dtype):
    """An additive mask broadcastable against the ``[B, H, Lq, Lk]`` scores.

    Bool masks keep where True (Paddle's meaning) and add -1e9 elsewhere;
    float masks are additive. Rank 2 ``[Lq, Lk]`` and rank 3
    ``[B, Lq, Lk]`` gain their missing axes; rank 4 passes as it is.
    """
    if attn_mask is None:
        return None
    if attn_mask.dtype == torch.bool:
        attn_mask = torch.where(attn_mask, torch.zeros((), dtype=dtype, device=attn_mask.device),
                                torch.full((), -1e9, dtype=dtype, device=attn_mask.device))
    else:
        attn_mask = attn_mask.to(dtype)
    if attn_mask.dim() == 2:
        attn_mask = attn_mask[None, None]
    elif attn_mask.dim() == 3:
        attn_mask = attn_mask[:, None]
    return attn_mask


def causal_mask(length, window=None, dtype="float32", device=None):
    """The additive causal mask ``[length, length]`` (-1e9 where masked);
    ``window=W`` also masks keys more than ``W - 1`` positions behind the
    query (sliding-window attention): the full-sequence equivalent of
    decoding through a ring cache of capacity ``W``. Made on ``device``
    (a capture on the card copies nothing from the host)."""
    i = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    keep = j <= i
    if window is not None:
        keep = keep & (j > i - int(window))
    return torch.where(keep, torch.zeros((), dtype=getattr(torch, dtype), device=device),
                       torch.full((), -1e9, dtype=getattr(torch, dtype), device=device))


class StaticCache(NamedTuple):
    """The fixed-shape ring KV cache of ONE attention layer: ``k``/``v``
    ``[B, H, C, D]`` (C the capacity) and ``pos [B]`` int32, the tokens each
    row has written. A cached attention writes the step's keys and values at
    ``pos % C`` in place; the caller's mask hides what is not yet written or
    out of the window (``generation/cache.py``), and the caller advances
    ``pos``."""

    k: Any
    v: Any
    pos: Any


class QuantizedStaticCache(NamedTuple):
    """:class:`StaticCache` at int8: ``k``/``v`` int8 ``[B, H, C, D]`` and
    ``k_scale``/``v_scale`` f32 ``[B, H, C]``, one abs-max scale per written
    head vector, computed when it is written (no calibration). The read
    dequantizes the whole window; ring, mask and ``pos`` contracts are
    :class:`StaticCache`'s."""

    k: Any
    v: Any
    k_scale: Any
    v_scale: Any
    pos: Any


class PagedStaticCache(NamedTuple):
    """:class:`StaticCache` semantics over a page pool: ``k``/``v``
    ``[P, H, ps, D]`` are the whole pool of ONE layer, ``table`` ``[B, NP]``
    int32 maps row ``b``'s logical ring pages to pool pages, ``pos [B]``.
    Ring index ``pos % (NP * ps)`` splits into page ``// ps`` and offset
    ``% ps``, so every mask carries over. Page 0 is the trash page that
    vacant rows and unallocated pages point at; the pool's owner makes
    every page a busy row writes private before the step
    (``generation/paging.py``)."""

    k: Any
    v: Any
    table: Any
    pos: Any


class QuantizedPagedCache(NamedTuple):
    """:class:`PagedStaticCache` at int8: int8 ``k``/``v`` ``[P, H, ps, D]``
    and f32 scale pools ``k_scale``/``v_scale`` ``[P, H, ps]``."""

    k: Any
    v: Any
    k_scale: Any
    v_scale: Any
    table: Any
    pos: Any


#: int8 grid half-width of the KV-cache quantization
KV_QUANT_BNT = 127.0
#: scale floor: an all-zero head vector must not dequantize to NaN
KV_QUANT_EPS = 1e-8


def quantize_kv(x):
    """``[..., D]`` -> (int8 values, f32 abs-max scales ``[...]``): one
    dynamic scale per trailing vector. The JAX order of operations (divide,
    then multiply; ``torch.round`` rounds half to even as ``jnp.round``)."""
    x = x.to(torch.float32)
    scale = torch.clamp_min(x.abs().amax(dim=-1), KV_QUANT_EPS)
    q = torch.round(torch.clamp(x / scale[..., None] * KV_QUANT_BNT, -KV_QUANT_BNT,
                                KV_QUANT_BNT))
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv`: ``q * (scale / 127)``, the quotient
    taken first, as the JAX package takes it. The int8 values widen inside
    the product (exactly: ``|q| <= 127``), one pass over the window."""
    return q * (scale[..., None] / KV_QUANT_BNT).to(dtype)


def _ring_index(pos, t, store):
    """``[B, T]`` ring indices ``(pos + j) % store`` of a ``t``-token write."""
    return torch.remainder(pos.to(torch.int64)[:, None]
                           + torch.arange(t, device=pos.device)[None, :], store)


class MultiHeadAttention(Layer):
    """Scaled dot-product multi-head attention with the JAX signature: the
    plain and flash paths, and the cached paths of incremental decoding
    (a :class:`StaticCache` ring written in place, or the ``(k, v)`` concat
    cache), the int8 and the paged caches. What is not ported raises:
    ``kdim``/``vdim`` other than ``embed_dim``, ``need_weights``, ring and
    Ulysses attention."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None, use_ring_attention=False,
                 use_flash_attention=False, use_ulysses_attention=False, generator=None,
                 device=None):
        super().__init__()
        if (kdim or embed_dim) != embed_dim or (vdim or embed_dim) != embed_dim:
            raise NotImplementedError("MultiHeadAttention: kdim/vdim other than embed_dim are "
                                      "not ported yet")
        if need_weights or use_ring_attention or use_ulysses_attention:
            raise NotImplementedError("MultiHeadAttention: need_weights, ring and Ulysses "
                                      "attention are not ported")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.use_flash_attention = use_flash_attention
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, generator=generator,
                  device=device)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _shape(self, x):
        # [B, L, E] -> [B, H, L, D], contiguous for the kernel
        b, l = x.shape[0], x.shape[1]
        return x.reshape(b, l, self.num_heads, self.head_dim).transpose(1, 2).contiguous()

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        """``out``, or ``(out, new_cache)`` when ``cache`` is given: the same
        :class:`StaticCache` (its tensors written in place) or the grown
        ``(k, v)``."""
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        if isinstance(cache, (StaticCache, QuantizedStaticCache, PagedStaticCache,
                              QuantizedPagedCache)):
            k, v, new_cache = self._update_static_cache(cache, k, v)
        elif cache is not None:
            pk, pv = cache
            k = torch.cat([pk, k], dim=2)
            v = torch.cat([pv, v], dim=2)
            new_cache = (k, v)
        scale = float(self.head_dim) ** -0.5
        # in q's dtype, bf16 under AMP, as the JAX package makes it
        mask = _convert_attention_mask(attn_mask, q.dtype)
        if (self.use_flash_attention and cache is None
                and k.shape[2] >= FLASH_ATTENTION_MIN_SEQ):
            out = flash_attention.flash_attention(
                q, k, v, bias=mask, scale=scale,
                dropout_rate=self.dropout if self.training else 0.0)
        else:
            scores = F.matmul(q, k, transpose_y=True) * scale
            if mask is not None:
                scores = scores + mask
            weights = F.softmax(scores, axis=-1)
            if self.dropout:
                weights = F.dropout(weights, p=self.dropout, training=self.training)
            out = F.matmul(weights, v)
        b, l = out.shape[0], out.shape[2]
        out = self.out_proj(out.transpose(1, 2).reshape(b, l, self.embed_dim))
        return out if cache is None else (out, new_cache)

    def gen_cache(self, key, value=None, type=None):
        """An empty concat cache ``(k, v)``, each ``[B, H, 0, D]``."""
        shape = (key.shape[0], self.num_heads, 0, self.head_dim)
        return (torch.zeros(shape, dtype=key.dtype, device=key.device),
                torch.zeros(shape, dtype=key.dtype, device=key.device))

    def gen_static_cache(self, batch, cache_len, dtype="float32", device=None):
        """A zeroed :class:`StaticCache` of capacity ``cache_len``."""
        shape = (int(batch), self.num_heads, int(cache_len), self.head_dim)
        return StaticCache(torch.zeros(shape, dtype=getattr(torch, dtype), device=device),
                           torch.zeros(shape, dtype=getattr(torch, dtype), device=device),
                           torch.zeros((int(batch),), dtype=torch.int32, device=device))

    @classmethod
    def _update_static_cache(cls, cache, k, v):
        """Write the step's ``k``/``v`` ``[B, H, T, D]`` into the ring in
        place: row ``b`` writes its position ``t`` at ``(pos[b] + t) % C``
        (decode is ``T = 1``). The index plane ``[B, T]`` addresses the
        ``[B, C, H, D]`` view of each cache tensor, so the payload is laid
        out ``[B, T, H, D]``, as the JAX scatter's split advanced indices
        put it. Returns the whole windows and the cache. The int8 and
        paged caches go to their own writes."""
        if isinstance(cache, QuantizedStaticCache):
            return cls._update_quantized_cache(cache, k, v)
        if isinstance(cache, (PagedStaticCache, QuantizedPagedCache)):
            return cls._update_paged_cache(cache, k, v)
        kc, vc, pos = cache
        rows = torch.arange(kc.shape[0], device=kc.device)[:, None]
        idx = _ring_index(pos, k.shape[2], kc.shape[2])
        kc.transpose(1, 2)[rows, idx] = k.transpose(1, 2).to(kc.dtype)
        vc.transpose(1, 2)[rows, idx] = v.transpose(1, 2).to(vc.dtype)
        return kc, vc, cache

    @staticmethod
    def _update_quantized_cache(cache, k, v):
        """Int8 twin of :meth:`_update_static_cache`: the step's ``k``/``v``
        quantize per head vector (:func:`quantize_kv`), and int8 values and
        f32 scales land in place at the ring index the f32 cache would
        write (scales through their ``[B, C, H]`` view). Returns the whole
        windows dequantized in ``k``'s dtype; masked entries dequantize to
        whatever they hold, and the caller's mask hides them."""
        kc, vc, ks, vs, pos = cache
        out_dtype = k.dtype
        kq, ksc = quantize_kv(k)
        vq, vsc = quantize_kv(v)
        rows = torch.arange(kc.shape[0], device=kc.device)[:, None]
        idx = _ring_index(pos, k.shape[2], kc.shape[2])
        kc.transpose(1, 2)[rows, idx] = kq.transpose(1, 2)
        vc.transpose(1, 2)[rows, idx] = vq.transpose(1, 2)
        ks.transpose(1, 2)[rows, idx] = ksc.transpose(1, 2)
        vs.transpose(1, 2)[rows, idx] = vsc.transpose(1, 2)
        return dequantize_kv(kc, ks, out_dtype), dequantize_kv(vc, vs, out_dtype), cache

    @staticmethod
    def _paged_indices(table, pos, t, store, ps):
        """Pool coordinates ``(page, offset)``, each ``[B, T]`` int64, of a
        ``t``-token write from each row's ``pos``: the ring index ``(pos +
        j) % store`` split by the page table."""
        idx = _ring_index(pos, t, store)
        rows = torch.arange(table.shape[0], device=table.device)[:, None]
        return table[rows, idx // ps].to(torch.int64), torch.remainder(idx, ps)

    @classmethod
    def _update_paged_cache(cls, cache, k, v):
        """Paged twin of :meth:`_update_static_cache`, f32 or int8: the
        write scatters in place into the layer's pool at ``(page, offset)``
        (values through the pool's ``[P, ps, H, D]`` view, scales through
        ``[P, ps, H]``, so the payload is ``[B, T, H(, D)]``); the read
        gathers each row's ``NP`` pages in one pass, as ``[B, H, NP, ps,
        D]``, the ``[B, H, NP * ps, D]`` window the ring would hold.
        The pool's owner made every written page private (copy-on-write)
        before the step."""
        quant = isinstance(cache, QuantizedPagedCache)
        if quant:
            kc, vc, ks, vs, table, pos = cache
        else:
            kc, vc, table, pos = cache
        out_dtype = k.dtype
        ps = kc.shape[2]
        b, np_ = table.shape
        store = np_ * ps
        phys, off = cls._paged_indices(table, pos, k.shape[2], store, ps)
        if quant:
            kq, ksc = quantize_kv(k)
            vq, vsc = quantize_kv(v)
            kc.transpose(1, 2)[phys, off] = kq.transpose(1, 2)
            vc.transpose(1, 2)[phys, off] = vq.transpose(1, 2)
            ks.transpose(1, 2)[phys, off] = ksc.transpose(1, 2)
            vs.transpose(1, 2)[phys, off] = vsc.transpose(1, 2)
        else:
            kc.transpose(1, 2)[phys, off] = k.transpose(1, 2).to(kc.dtype)
            vc.transpose(1, 2)[phys, off] = v.transpose(1, 2).to(vc.dtype)
        h, d = kc.shape[1], kc.shape[3]
        # one gather straight into [B, H, NP, ps(, D)]: the page and head
        # indices broadcast to [B, H, NP]
        pages = table.to(torch.int64)[:, None, :]
        heads = torch.arange(h, device=table.device)[None, :, None]

        def window(pool):
            return pool[pages, heads].reshape(b, h, store, d)

        if quant:
            def swindow(spool):
                return spool[pages, heads].reshape(b, h, store)

            return (dequantize_kv(window(kc), swindow(ks), out_dtype),
                    dequantize_kv(window(vc), swindow(vs), out_dtype), cache)
        return window(kc).to(out_dtype), window(vc).to(out_dtype), cache


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, use_flash_attention=False,
                 sp_attention="none", generator=None, device=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        if sp_attention not in ("none", "ring", "ulysses"):
            raise ValueError(f"sp_attention must be none|ring|ulysses, got {sp_attention!r}")
        kw = dict(generator=generator, device=device)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr,
                                            use_ring_attention=sp_attention == "ring",
                                            use_flash_attention=use_flash_attention,
                                            use_ulysses_attention=sp_attention == "ulysses",
                                            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, src_mask)
        if self.normalize_before:
            src = residual + self.dropout1(src)
        else:
            src = _residual_norm(self.norm1, residual, self.dropout1(src))

        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        if self.normalize_before:
            src = residual + self.dropout2(src)
        else:
            src = _residual_norm(self.norm2, residual, self.dropout2(src))
        return src


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [copy.deepcopy(encoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    """Decoder block: self-attention, cross-attention over ``memory`` and an
    FFN. ``with_cross_attention=False`` builds a decoder-only block: no
    cross-attention parameters exist at all, and ``memory`` may be
    omitted. ``weight_attr`` and ``bias_attr`` go to every Linear."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, with_cross_attention=True, generator=None,
                 device=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(generator=generator, device=device)
        lin = dict(weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=attn_dropout, **lin)
        if with_cross_attention:
            self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=attn_dropout, **lin)
            self.norm2 = LayerNorm(d_model, device=device)
            self.dropout2 = Dropout(dropout)
        else:
            self.cross_attn = None
        self.linear1 = Linear(d_model, dim_feedforward, **lin)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **lin)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def _sublayer(self, norm, dropout, x, fn):
        """``x`` plus ``fn`` of it, pre-norm (``x + dropout(fn(norm(x)))``) or
        post-norm (``norm(x + dropout(fn(x)))``, the fused kernel)."""
        if self.normalize_before:
            return x + dropout(fn(norm(x)))
        return _residual_norm(norm, x, dropout(fn(x)))

    def forward(self, tgt, memory=None, tgt_mask=None, memory_mask=None, cache=None):
        """``tgt``, or ``(tgt, new_cache)`` when the self-attention's
        ``cache`` is given (:meth:`MultiHeadAttention.forward`)."""
        new_cache = []

        def self_attn(x):
            if cache is None:
                return self.self_attn(x, x, x, tgt_mask)
            out, c = self.self_attn(x, x, x, tgt_mask, cache)
            new_cache.append(c)
            return out

        tgt = self._sublayer(self.norm1, self.dropout1, tgt, self_attn)
        if self.cross_attn is not None:
            if memory is None:
                raise ValueError("this TransformerDecoderLayer was built with cross-attention; "
                                 "pass memory (or build it with with_cross_attention=False "
                                 "for decoder-only use)")
            tgt = self._sublayer(self.norm2, self.dropout2, tgt,
                                 lambda x: self.cross_attn(x, memory, memory, memory_mask))
        tgt = self._sublayer(self.norm3, self.dropout3, tgt, lambda x: self.linear2(
            self.dropout(self.activation(self.linear1(x)))))
        return tgt if cache is None else (tgt, new_cache[0])


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [copy.deepcopy(decoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    """The encoder-decoder transformer; the defaults are Transformer-base
    (512 wide, 8 heads, 6 + 6 layers, FFN 2048). As in the JAX package each
    stack deep-copies one layer, so its layers start from equal weights."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, activation="relu", attn_dropout=None,
                 act_dropout=None, normalize_before=False, custom_encoder=None,
                 custom_decoder=None, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation, attn_dropout, act_dropout,
                normalize_before, **kw)
            enc_norm = LayerNorm(d_model, device=device) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers, enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation, attn_dropout, act_dropout,
                normalize_before, **kw)
            dec_norm = LayerNorm(d_model, device=device) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers, dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The additive causal mask ``[length, length]``: float32, -1e9 above
        the diagonal, 0 elsewhere, made on ``device`` (a capture on the card
        copies nothing from the host)."""
        return torch.full((length, length), -1e9, dtype=torch.float32,
                          device=device).triu_(1)
