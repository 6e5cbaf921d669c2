"""The paged KV layout: a shared page pool, page tables and a radix prefix index with copy-on-write (``paddle_tpu/generation/paging.py``).

The ring cache (``generation/cache.py``) gives every slot its own window.
This module cuts the same logical ring into fixed-size pages drawn from one
pool (``FLAGS_kv_cache_layout=paged``):

- **Page pool.** Per layer, page-major planes ``[L, P, H, ps, D]`` (and
  ``[L, P, H, ps]`` scales at int8). Page 0 is the **trash page**: vacant
  slots and unallocated logical pages point at it, so the decode graph
  writes every row unconditionally and a vacant row's writes land there.
- **Page tables.** A row ``[NP]`` int32 per slot maps logical ring pages to
  pool pages; the attention gathers through it (``nn.PagedStaticCache``).
  The ring index ``pos % (NP * ps)`` splits into page ``// ps`` and offset
  ``% ps``, so every ring mask carries over unchanged.
- **Radix prefix index.** A trie keyed on chain hashes of full prompt pages
  (page ``i``'s hash commits to pages ``0..i``). A request maps the longest
  indexed prefix copy-on-write (refcounted; a wrap write into a shared page
  first copies it) and prefills only its suffix. The index holds a
  reference of its own on each page, so prefixes outlive their slot; LRU
  leaf eviction returns index-only pages under pressure.

All allocation, refcounting and copy-on-write is host bookkeeping in plain
Python and numpy, call for call the JAX package's; it runs between graph
replays, and the device tensors keep their shapes and storage.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..errors import InvalidArgumentError
from ..nn.transformer import PagedStaticCache, QuantizedPagedCache
from .cache import NEG_INF, kv_bytes_per_token

__all__ = [
    "TRASH_PAGE", "PagePool", "PrefixIndex", "PagePoolExhaustedError",
    "page_nbytes", "chain_hashes", "split_planes", "init_paged_cache",
    "paged_layer_caches", "stack_paged_planes", "suffix_prefill_mask",
]

#: the pool page reserved as the write sink of vacant slots and unallocated
#: logical pages; never allocated, never read unmasked
TRASH_PAGE = 0


class PagePoolExhaustedError(InvalidArgumentError):
    """The pool has no free page and nothing evictable: the admission (or a
    decode step's first visit or copy-on-write) cannot proceed. Size the
    pool with ``FLAGS_generation_kv_pool_pages`` or admit less."""


def page_nbytes(num_layers, num_heads, head_dim, page_size, dtype="float32") -> int:
    """Pool bytes ONE page costs across all layers (values, and scales at
    int8)."""
    return int(page_size) * kv_bytes_per_token(num_layers, num_heads, head_dim, dtype)


def chain_hashes(tokens, page_size):
    """A hash for every FULL page of ``tokens``: SHA-256 over the parent's
    digest and the page's tokens as little-endian int64 bytes, hex cut to
    32 characters, so equal hashes mean equal full prefixes. A partial tail
    page is not hashed (not shareable)."""
    ps = int(page_size)
    toks = np.asarray([int(t) for t in tokens], "<i8")
    out, parent = [], b""
    for i in range(len(toks) // ps):
        d = hashlib.sha256(parent + toks[i * ps:(i + 1) * ps].tobytes()).digest()
        parent = d
        out.append(d.hex()[:32])
    return out


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def split_planes(planes, page_size):
    """Window-wide per-slot planes (``[L, H, C, D]`` values, ``[L, H, C]``
    scales; tensors or arrays, ``C % ps == 0``) as a list of per-page tuples
    of host arrays, cut along the cache axis: the page view a page-granular
    handoff ships."""
    ps = int(page_size)
    c = int(planes[0].shape[2])
    if c % ps:
        raise InvalidArgumentError(f"cache window {c} is not a multiple of the page size {ps}")
    host = [_host(p) for p in planes]
    return [tuple(np.ascontiguousarray(p[:, :, i * ps:(i + 1) * ps]) for p in host)
            for i in range(c // ps)]


def init_paged_cache(num_layers, num_heads, head_dim, page_size, pool_pages, slots,
                     pages_per_slot, dtype="float32", device=None):
    """Zeroed whole-model paged cache on ``device``: ``(k [L, P, H, ps, D],
    v, table [S, NP] int32, pos [S] int32)``; at int8 also the scale pools
    ``(k, v, k_scale [L, P, H, ps], v_scale, table, pos)``. ``P`` is
    ``pool_pages + 1``, the trash page included, and every table entry
    starts at :data:`TRASH_PAGE`."""
    shape = (int(num_layers), int(pool_pages) + 1, int(num_heads), int(page_size),
             int(head_dim))
    table = torch.full((int(slots), int(pages_per_slot)), TRASH_PAGE, dtype=torch.int32,
                       device=device)
    pos = torch.zeros((int(slots),), dtype=torch.int32, device=device)
    if str(dtype) == "int8":
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device), table, pos)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device), table, pos)


def paged_layer_caches(kv, table=None, pos=None):
    """Per-layer :class:`~paddle_tpu_torch.nn.transformer.PagedStaticCache`
    (or ``QuantizedPagedCache``) views of the stacked pool, by arity.
    ``table``/``pos`` override the cache's own (a prefill passes the
    admitted slot's row)."""
    kv = tuple(kv)
    t = kv[-2] if table is None else table
    p = kv[-1] if pos is None else pos
    arrays = kv[:-2]
    cls = PagedStaticCache if len(arrays) == 2 else QuantizedPagedCache
    return [cls(*(a[i] for a in arrays), t, p) for i in range(arrays[0].shape[0])]


def stack_paged_planes(caches):
    """The whole-model pool planes ``(k, v)`` (``(k, v, k_scale, v_scale)``
    at int8) stacked from per-layer paged caches. The engine never needs it:
    its layers' caches are views of the pool, written in place."""
    names = (("k", "v", "k_scale", "v_scale") if isinstance(caches[0], QuantizedPagedCache)
             else ("k", "v"))
    return tuple(torch.stack([getattr(c, n) for c in caches]) for n in names)


def suffix_prefill_mask(bucket, store, shared_len, length, dtype="float32"):
    """Additive ``[1, 1, P, store]`` mask of a suffix prefill: query ``t``
    sits at ``shared_len + t`` and keeps entry ``j`` iff ``j <= shared_len +
    t`` and ``j < shared_len + length`` (bucket padding is never attended).
    ``shared_len`` and ``length`` are device tensors of one element, so one
    graph a bucket serves full (``shared_len == 0``: ``cache.prefill_mask``)
    and suffix prefills."""
    device = shared_len.device
    shared = shared_len.reshape(()).to(torch.int64)
    n = torch.as_tensor(length, device=device).reshape(()).to(torch.int64)
    t = torch.arange(int(bucket), device=device)[:, None]
    j = torch.arange(int(store), device=device)[None, :]
    keep = (j <= shared + t) & (j < shared + n)
    zero = torch.zeros((), dtype=getattr(torch, dtype), device=device)
    return torch.where(keep, zero, torch.full_like(zero, NEG_INF))[None, None]


class PagePool:
    """Host allocator over the shared pool: a LIFO free list, per-page
    refcounts, and the alloc/retain/release bookkeeping the engine runs
    between steps. Page ids are pool indices (1-based; 0 is
    :data:`TRASH_PAGE`). The device tensors belong to the engine."""

    def __init__(self, pages, page_size):
        if int(pages) < 1:
            raise InvalidArgumentError(f"a page pool needs at least 1 usable page, got {pages}")
        self.pages = int(pages)
        self.page_size = int(page_size)
        # ref[0] (trash) stays 0; LIFO free list
        self.ref = np.zeros(self.pages + 1, np.int64)
        self._free = list(range(self.pages, 0, -1))
        self.peak_used = 0
        self.cow_copies = 0

    def free_pages(self) -> int:
        return len(self._free)

    def used_pages(self) -> int:
        return self.pages - len(self._free)

    def shared_pages(self) -> int:
        """Pages with more than one holder (slots and/or the index): the
        copy-on-write exposure."""
        return int(np.sum(self.ref > 1))

    def alloc(self):
        """One free page at refcount 1, or None when none is free (the
        caller evicts or refuses)."""
        if not self._free:
            return None
        pid = self._free.pop()
        self.ref[pid] = 1
        self.peak_used = max(self.peak_used, self.used_pages())
        return pid

    def retain(self, pid):
        """One more holder of ``pid`` (a slot mapping a shared prefix page,
        or the index registering it)."""
        if pid == TRASH_PAGE:
            raise InvalidArgumentError("the trash page cannot be retained")
        if self.ref[pid] <= 0:
            raise InvalidArgumentError(f"page {pid} is free; retain() needs a live page")
        self.ref[pid] += 1

    def release(self, pid) -> bool:
        """Drop one holder; True when the page went back to the free list."""
        if pid == TRASH_PAGE:
            return False
        if self.ref[pid] <= 0:
            raise InvalidArgumentError(f"page {pid} released below refcount 0 (double free)")
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self._free.append(pid)
            return True
        return False


class _Node:
    __slots__ = ("hash", "page", "parent", "children", "clock")

    def __init__(self, h, page, parent):
        self.hash = h
        self.page = page
        self.parent = parent
        self.children = {}
        self.clock = 0


class PrefixIndex:
    """Radix trie over page chain hashes -> pool pages. Each node is one
    full page of an admitted prompt; a root-to-node path is a shared
    full-page prefix. The index retains every page it registers;
    :meth:`evict` drops least-recently-matched leaves no slot maps."""

    def __init__(self, pool):
        self._pool = pool
        self._roots = {}
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.pages = 0  # nodes (= pages) registered
        self.evictions = 0

    def _walk(self, hashes):
        nodes, children = [], self._roots
        for h in hashes:
            node = children.get(h)
            if node is None:
                break
            nodes.append(node)
            children = node.children
        return nodes

    def match(self, hashes):
        """Pool pages of the longest indexed prefix of ``hashes`` (possibly
        none); touches the path for LRU and counts a hit when a page
        matched."""
        nodes = self._walk(hashes)
        self._clock += 1
        for node in nodes:
            node.clock = self._clock
        self.lookups += 1
        if nodes:
            self.hits += 1
        return [node.page for node in nodes]

    def known(self, hashes):
        """The indexed prefix of ``hashes``, as a set."""
        return {node.hash for node in self._walk(hashes)}

    def insert(self, hashes, pages):
        """Register a prompt's full-page chain: existing nodes are reused
        (their pages are canonical for that content), each new node retains
        its page."""
        children, parent = self._roots, None
        self._clock += 1
        for h, page in zip(hashes, pages):
            node = children.get(h)
            if node is None:
                page = int(page)
                if page == TRASH_PAGE:
                    raise InvalidArgumentError("cannot index the trash page as prefix content")
                node = _Node(h, page, parent)
                self._pool.retain(page)
                children[h] = node
                self.pages += 1
            node.clock = self._clock
            children, parent = node.children, node

    def evictable(self) -> int:
        """Pages eviction could free now: leaves whose page only the index
        holds."""
        return sum(1 for node in self._iter_nodes()
                   if not node.children and self._pool.ref[node.page] == 1)

    def _iter_nodes(self):
        stack = list(self._roots.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def evict(self, need) -> int:
        """Drop LRU leaves whose pages only the index holds until ``need``
        pages went back to the free list or nothing evictable is left;
        returns the count freed."""
        freed = 0
        while freed < int(need):
            victim = None
            for node in self._iter_nodes():
                if node.children or self._pool.ref[node.page] != 1:
                    continue
                if victim is None or node.clock < victim.clock:
                    victim = node
            if victim is None:
                break
            siblings = victim.parent.children if victim.parent is not None else self._roots
            del siblings[victim.hash]
            self._pool.release(victim.page)
            self.pages -= 1
            self.evictions += 1
            freed += 1
        return freed

    def forget_page(self, page) -> int:
        """Drop ``page`` and its subtree from the index, releasing the
        index's reference on each: the pressure valve when a slot's ring
        wraps into a page the index pins and no copy page is free. Returns
        the nodes dropped."""
        page = int(page)
        victim = next((n for n in self._iter_nodes() if n.page == page), None)
        if victim is None:
            return 0
        siblings = victim.parent.children if victim.parent is not None else self._roots
        del siblings[victim.hash]
        dropped = 0
        stack = [victim]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self._pool.release(node.page)
            self.pages -= 1
            self.evictions += 1
            dropped += 1
        return dropped

    def stats(self) -> dict:
        return {
            "pages": self.pages,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": round(self.hits / self.lookups, 4) if self.lookups else None,
            "evictions": self.evictions,
        }
