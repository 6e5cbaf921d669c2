"""Transformer encoder of the serving and training paths (``paddle_tpu/nn/transformer.py``).

The non-cache attention path with its flash dispatch (``:290-327`` of the
JAX module), the post-norm encoder layer whose residual-add + LayerNorm
pairs go through the fused kernel (``_residual_norm``, ``:28-43``), and
the encoder stack. Incremental KV caches, ring/Ulysses attention and the
decoder are not ported yet.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ..flags import flag
from ..ops.cuda import flash_attention, layernorm_residual
from . import functional as F
from .layers import Dropout, LayerList, LayerNorm, Linear

__all__ = ["FLASH_ATTENTION_MIN_SEQ", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]

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


class MultiHeadAttention(nn.Module):
    """Scaled dot-product multi-head attention, the non-cache path."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, use_flash_attention=False,
                 generator=None, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.use_flash_attention = use_flash_attention
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        kw = dict(generator=generator, device=device)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _shape(self, x):
        # [B, L, E] -> [B, H, L, D], contiguous for the kernel
        b, l = x.shape[0], x.shape[1]
        return x.reshape(b, l, self.num_heads, self.head_dim).transpose(1, 2).contiguous()

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        scale = float(self.head_dim) ** -0.5
        mask = _convert_attention_mask(attn_mask, q.dtype)
        if self.use_flash_attention and k.shape[2] >= FLASH_ATTENTION_MIN_SEQ:
            out = flash_attention.flash_attention(
                q, k, v, bias=mask, scale=scale,
                dropout_rate=self.dropout if self.training else 0.0)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) * scale
            if mask is not None:
                scores = scores + mask
            weights = F.softmax(scores, axis=-1)
            if self.dropout:
                weights = F.dropout(weights, p=self.dropout, training=self.training)
            out = torch.matmul(weights, v)
        b, l = out.shape[0], out.shape[2]
        return self.out_proj(out.transpose(1, 2).reshape(b, l, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 use_flash_attention=False, generator=None, device=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(generator=generator, device=device)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=attn_dropout,
                                            use_flash_attention=use_flash_attention, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
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


class TransformerEncoder(nn.Module):
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
