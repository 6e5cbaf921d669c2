"""The engine's ring KV cache and its masks (``paddle_tpu/generation/cache.py:57-227``), float32.

An all-layers cache is ``(k [L, B, H, C, D], v [...], pos [B])`` with one
``pos`` shared by every layer. The JAX package replaces these arrays
functionally; the port writes them **in place** (a CUDA graph replays
writes into the buffers it was captured with), so every helper that
updates a cache returns the same tensors it was given:

- :func:`layer_caches` slices views, :class:`StaticCache` per layer, whose
  writes land in the stacked tensors;
- :func:`insert_slot` / :func:`insert_slot_kv` install a prefilled slot by
  ``index_copy_`` with ``slot`` and ``length`` as device tensors, so one
  captured prefill serves every slot.

:func:`decode_mask` and :func:`prefill_mask` compose causality with cache
validity into one additive mask (-1e9): decoding through a ring of
capacity ``C`` equals a full forward under ``causal_mask(T, window=C)``.
The store may be wider than the window (the JAX package's speculative
scratch margin), which :func:`verify_mask` serves. The int8 form (5-tuple
with scale planes) raises :class:`~paddle_tpu_torch.errors.UnimplementedError`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from ..errors import UnimplementedError
from ..nn.transformer import StaticCache

__all__ = [
    "init_cache", "layer_caches", "stack_layer_caches", "insert_slot",
    "insert_slot_kv", "fresh_layer_caches", "cache_nbytes",
    "kv_bytes_per_token", "decode_mask", "prefill_mask", "verify_mask",
    "pad_slot_arrays",
]

NEG_INF = -1e9

#: storage dtypes the KV cache supports (FLAGS_generation_kv_cache_dtype)
KV_CACHE_DTYPES = ("float32", "int8")

INT8_ENTRY = "the int8 ring (ROADMAP.md Queue A item 3, entry 1)"


def _float32_only(dtype):
    if str(dtype) == "int8":
        raise UnimplementedError(f"an int8 KV cache is not ported yet; it comes with "
                                 f"{INT8_ENTRY}")
    if str(dtype) != "float32":
        raise UnimplementedError(f"KV cache dtype {dtype!r}: the port keeps float32")


def init_cache(num_layers, batch, num_heads, cache_len, head_dim, dtype="float32",
               device=None):
    """Zeroed whole-model cache ``(k [L, B, H, C, D], v [...], pos [B] int32)``
    on ``device``."""
    _float32_only(dtype)
    shape = (int(num_layers), int(batch), int(num_heads), int(cache_len), int(head_dim))
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros((int(batch),), dtype=torch.int32, device=device))


def layer_caches(*kv):
    """Per-layer :class:`StaticCache` views of the stacked cache (``pos`` is
    shared: every layer writes the same step)."""
    if len(kv) == 1:  # the whole-cache tuple as one argument
        kv = tuple(kv[0])
    if len(kv) != 3:
        _float32_only("int8")
    k, v, pos = kv
    return [StaticCache(k[i], v[i], pos) for i in range(k.shape[0])]


def stack_layer_caches(caches):
    """``(k, v)`` stacked from per-layer caches. The engine never needs it:
    its layers' caches are views of the stacked tensors and write them in
    place."""
    return (torch.stack([c.k for c in caches]), torch.stack([c.v for c in caches]))


def fresh_layer_caches(num_layers, batch, num_heads, cache_len, head_dim, dtype="float32",
                       device=None):
    """Zeroed per-layer caches for a prefill forward."""
    return layer_caches(*init_cache(num_layers, batch, num_heads, cache_len, head_dim, dtype,
                                    device))


def insert_slot(ck, cv, pos, slot, new_k, new_v, length):
    """Install one prefilled sequence (``new_k``/``new_v`` ``[L, H, C, D]``)
    into decode slot ``slot`` and set its position to ``length``, in place.
    ``slot`` and ``length`` are integers or device tensors of one element
    (a captured prefill takes them as inputs). Returns ``(ck, cv, pos)``."""
    slot = torch.as_tensor(slot, device=ck.device).reshape(1).to(torch.int64)
    ck.index_copy_(1, slot, new_k.unsqueeze(1).to(ck.dtype))
    cv.index_copy_(1, slot, new_v.unsqueeze(1).to(cv.dtype))
    pos.index_copy_(0, slot, torch.as_tensor(length, device=pos.device).reshape(1)
                    .to(pos.dtype))
    return ck, cv, pos


def insert_slot_kv(kv, slot, new_arrays, length):
    """:func:`insert_slot` over the whole-cache tuple ``(k, v, pos)`` and the
    slot's ``(new_k, new_v)``."""
    if len(kv) != 3 or len(new_arrays) != 2:
        _float32_only("int8")
    return insert_slot(kv[0], kv[1], kv[2], slot, new_arrays[0], new_arrays[1], length)


def cache_nbytes(kv) -> int:
    """Device bytes the whole-model cache occupies (values + positions),
    read off the real tensors."""
    return int(sum(a.numel() * a.element_size() for a in kv))


def kv_bytes_per_token(num_layers, num_heads, head_dim, dtype="float32") -> int:
    """Cache bytes one decoded token occupies across all layers (K + V; at
    int8 the values plus their scales, the JAX package's count)."""
    per_vec = int(head_dim) + 4 if str(dtype) == "int8" else int(head_dim) * 4
    return 2 * int(num_layers) * int(num_heads) * per_vec


def _additive(keep, dtype):
    zero = torch.zeros((), dtype=getattr(torch, dtype), device=keep.device)
    return torch.where(keep, zero, torch.full_like(zero, NEG_INF))


def decode_mask(pos, cache_len, window=None, dtype="float32"):
    """Additive ``[B, 1, 1, store]`` mask of one decode step at positions
    ``pos [B]`` (a device tensor): entry ``j`` holds the token ``(pos - j)
    mod store`` behind the query, kept when that distance is inside the
    window (``window`` defaults to the store) and the entry was ever
    written."""
    store = int(cache_len)
    w = store if window is None else int(window)
    p = pos.to(torch.int64)[:, None]
    dd = torch.remainder(p - torch.arange(store, device=pos.device)[None, :], store)
    keep = (dd < w) & (dd <= p)
    return _additive(keep, dtype)[:, None, None, :]


def verify_mask(pos, cache_len, span, window=None, dtype="float32"):
    """Additive ``[B, 1, span, store]`` mask of ``span`` queries at
    ``pos .. pos + span - 1`` over a ring already holding all of them: query
    ``i`` keeps entry ``j`` iff its token is causally visible and inside the
    window. Row 0 is :func:`decode_mask`."""
    store = int(cache_len)
    w = store if window is None else int(window)
    q = pos.to(torch.int64)[:, None, None] + torch.arange(int(span), device=pos.device)[None, :,
                                                                                         None]
    dd = torch.remainder(q - torch.arange(store, device=pos.device)[None, None, :], store)
    keep = (dd < w) & (dd <= q)
    return _additive(keep, dtype)[:, None]


def pad_slot_arrays(arrays, store):
    """Zero-pad per-slot planes ``[L, H, C, D]`` along the cache axis from
    the window ``C`` to a wider ring ``store``."""
    out = []
    for a in arrays:
        c = a.shape[2]
        if c > int(store):
            raise ValueError(f"slot plane cache axis {c} exceeds the target store {store}")
        if c < int(store):
            pad = [0, 0] * (a.dim() - 3) + [0, int(store) - c]
            a = _F.pad(a, pad)
        out.append(a)
    return tuple(out)


def prefill_mask(bucket, cache_len, length, dtype="float32", device=None):
    """Additive ``[1, 1, P, C]`` mask of a bucketed prefill: query ``t``
    keeps entry ``j`` iff ``j <= t`` and ``j < length``, the true prompt
    length (an integer or a device tensor; bucket padding is never
    attended, and its queries' logits are never read)."""
    if isinstance(length, torch.Tensor):
        device = length.device
        length = length.reshape(())
    t = torch.arange(int(bucket), device=device)[:, None]
    j = torch.arange(int(cache_len), device=device)[None, :]
    keep = (j <= t) & (j < length)
    return _additive(keep, dtype)[None, None]
