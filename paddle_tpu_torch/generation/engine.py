"""The generation engine: bucketed prefill + cached decode, as CUDA graphs (``paddle_tpu/generation/engine.py:87-1642``; ring and paged layouts, float32 and int8).

The JAX engine compiles one program per prefill bucket and one decode
program over every slot, and replaces its cache arrays functionally. The
port keeps the same split and the same compile accounting with CUDA graphs
in two ``runtime/compiled.py`` stores:

- **Persistent cache.** The engine owns its cache tensors for its
  lifetime: the ring ``k, v [L, S, H, C, D]`` (int8 values with f32 scale
  planes ``[L, S, H, C]`` at ``kv_cache_dtype="int8"``) and ``pos [S]``, or
  under ``kv_cache_layout="paged"`` the page pool ``[L, P, H, ps, D]`` (and
  scale pools), the page table ``[S, NP]`` and ``pos``
  (``generation/paging.py``). Every write goes into them in place: a ring
  prefill installs a slot with ``index_copy_``, a paged prefill writes the
  suffix straight into the slot's pages, a decode step writes each row's
  ring entry (``nn/transformer.py``) and advances ``pos``, and
  :meth:`reset` zeroes them with ``zero_()``, so the graphs captured over
  them stay valid.
- **One graph per prefill bucket.** Its inputs (the slot, the padded
  tokens, the true length and the temperature; paged: also the shared
  prefix length and the prompt's total) are device tensors, so every slot
  and every prefix share it; the paged graph reads the slot's table row on
  the device. The first token is sampled from the last real position.
- **One decode graph** over all ``S`` slots: last tokens and temperatures
  in, next tokens out.
- **Page management on the host, between replays** (paged): allocation,
  refcounts, the prefix index, copy-on-write and eviction are plain Python
  (:class:`~paddle_tpu_torch.generation.paging.PagePool`,
  :class:`~paddle_tpu_torch.generation.paging.PrefixIndex`) over a pinned
  int32 mirror of the table. Before the next replay, on the engine's
  stream, :meth:`GenerationEngine._sync_table` copies the mirror into the
  device table (a blocking copy: the host edits the mirror only after it
  landed) and :meth:`GenerationEngine._copy_page` copies a page across
  every layer. No graph reads the mirror.
- **Compile accounting.** The first call of a signature (the bucket, TF32
  in matrix products) runs eagerly as the real call, then captures; the
  stores' misses are the JAX ``generation::compile`` counter
  (:data:`COMPILE_COUNTER`, :meth:`GenerationEngine.compile_count`).
  :meth:`~GenerationEngine.warmup` makes exactly ``len(buckets) + 1`` (with
  prefix sharing off, so every bucket captures its own) and arms
  :attr:`~GenerationEngine.watch`; ``extra_compiles()`` must then stay 0.
- **Sampling.** One ``torch.Generator`` on the card, registered with every
  graph, so each replay draws anew.
- **No host decision inside a graph.** Slots and lengths are gathered and
  ``index_copy_``'d as device tensors; positions are clamped on the device;
  the sampled tokens are copied out after the replay through a pinned
  buffer. One lock serializes every dispatch and every page operation:
  prefill and decode write the same cache.

On the CPU (``device="cpu"``) the same bodies run eagerly at every call.
Speculative decoding and the disaggregated prefill/decode kinds raise
:class:`~paddle_tpu_torch.errors.UnimplementedError` naming their ROADMAP
entries. The JAX engine's registry gauges and ``prefix_reuse`` flight
events wait for the monitor (ROADMAP.md Queue A item 10); the accounting
behind them is here (:meth:`GenerationEngine.paging_stats`).
"""
from __future__ import annotations

import itertools
import threading
import warnings
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from ..errors import EnforceNotMet, InvalidArgumentError, UnimplementedError
from ..flags import flag
from ..framework.jit import _captures, _first_run, _set_precision
from ..runtime.compiled import CompileWatch, GraphStore, precision_key
from ..serving.batcher import parse_buckets
from . import cache as _cache
from . import paging as _paging
from .sampling import sample_logits

__all__ = ["GenerationEngine", "COMPILE_COUNTER", "MemoryBudgetError"]

#: the JAX package's counter of generation compiles; the port's count is
#: the misses of an engine's two stores (:meth:`GenerationEngine.compile_count`)
COMPILE_COUNTER = "generation::compile"

_SPECULATIVE = "speculative decoding (ROADMAP.md Queue A item 3, entry 3)"
_HANDOFF = "the disaggregated prefill/decode handoff (ROADMAP.md Queue A item 3, entry 4)"

_instances = itertools.count()


class MemoryBudgetError(EnforceNotMet):
    """The engine's weights and KV cache exceed the card's memory
    (``FLAGS_memory_budget_check=strict``)."""

    code = "MEMORY_BUDGET"

    def __init__(self, message, budget_bytes=None):
        self.budget_bytes = budget_bytes
        super().__init__(message)


def _fmt_bytes(n) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0


class GenerationEngine:
    """Slot-structured generation over a causal LM.

    ``model`` exposes ``forward(input_ids, position_ids, attention_mask,
    caches) -> (logits, caches)`` with per-layer :class:`nn.StaticCache`
    (and its int8 and paged forms) and ``cache_spec()``
    (:class:`~paddle_tpu_torch.models.GPTForCausalLM`). The two scheduler
    primitives are :meth:`admit` (prefill a prompt into a slot, return the
    first token) and :meth:`step` (one token for every slot). ``device`` is
    the card unless the caller names another (the model moves there);
    ``jit=False`` runs every call eagerly on the card too (the captured
    path's control)."""

    def __init__(self, model, *, slots=None, cache_len=None, prefill_buckets=None, eos_id=None,
                 pad_id=None, max_new_tokens=None, temperature=None, top_k=None,
                 kv_cache_dtype=None, kv_cache_layout=None, kv_page_size=None,
                 kv_pool_pages=None, draft_model=None, draft_k=None, seed=0, device=None,
                 jit=True):
        if draft_model is not None:
            raise UnimplementedError(f"GenerationEngine(draft_model=...): {_SPECULATIVE} is "
                                     "not ported yet")
        self.kv_cache_dtype = str(kv_cache_dtype if kv_cache_dtype is not None
                                  else flag("generation_kv_cache_dtype"))
        if self.kv_cache_dtype not in _cache.KV_CACHE_DTYPES:
            raise InvalidArgumentError(f"generation_kv_cache_dtype must be one of "
                                       f"{_cache.KV_CACHE_DTYPES}, got {self.kv_cache_dtype!r}")
        self.kv_cache_layout = str(kv_cache_layout if kv_cache_layout is not None
                                   else flag("kv_cache_layout"))
        if self.kv_cache_layout not in ("ring", "paged"):
            raise InvalidArgumentError(f"kv_cache_layout must be ring | paged, got "
                                       f"{self.kv_cache_layout!r}")
        self.paged = self.kv_cache_layout == "paged"
        self.device = resolve_device(device)
        _set_precision()
        self.model = model.to(self.device)
        model.eval()  # generation never wants dropout
        cfg = getattr(model, "config", None)
        self.slots = int(slots if slots is not None else flag("generation_decode_slots"))
        self.cache_len = int(cache_len if cache_len is not None
                             else flag("generation_kv_cache_len"))
        self.prefill_buckets = parse_buckets(prefill_buckets if prefill_buckets is not None
                                             else flag("generation_prefill_buckets"))
        if self.slots <= 0:
            raise InvalidArgumentError(f"generation needs at least one decode slot, got "
                                       f"{self.slots}")
        if self.prefill_buckets[-1] > self.cache_len:
            raise InvalidArgumentError(
                f"largest prefill bucket {self.prefill_buckets[-1]} exceeds the KV cache "
                f"window {self.cache_len}; prompts must fit the cache")
        self.page_size = int(kv_page_size if kv_page_size is not None
                             else flag("generation_kv_page_size"))
        if self.paged:
            if self.page_size < 1 or self.cache_len % self.page_size:
                raise InvalidArgumentError(
                    f"generation_kv_page_size {self.page_size} must be >= 1 and divide the "
                    f"cache window {self.cache_len}")
            self._pages_per_slot = self.cache_len // self.page_size
            self._pool_pages_cfg = int(kv_pool_pages if kv_pool_pages is not None
                                       else flag("generation_kv_pool_pages"))
            if self._pool_pages_cfg < 0:
                raise InvalidArgumentError(f"generation_kv_pool_pages must be >= 0, got "
                                           f"{self._pool_pages_cfg}")
            if self._pool_pages_cfg and self._pool_pages_cfg < self._pages_per_slot:
                raise InvalidArgumentError(
                    f"generation_kv_pool_pages {self._pool_pages_cfg} cannot hold even one "
                    f"slot's window ({self._pages_per_slot} pages)")
        self.eos_id = eos_id if eos_id is not None else getattr(cfg, "eos_token_id", None)
        self.pad_id = int(pad_id if pad_id is not None else getattr(cfg, "pad_token_id", 0))
        self.max_positions = int(getattr(cfg, "max_position_embeddings", 1 << 30))
        self.vocab_size = getattr(cfg, "vocab_size", None)
        self.default_max_new_tokens = int(max_new_tokens if max_new_tokens is not None
                                          else flag("generation_max_new_tokens"))
        self.default_temperature = float(temperature if temperature is not None
                                         else flag("generation_temperature"))
        # engine-wide: a different top_k is a different graph
        self.top_k = int(top_k if top_k is not None else flag("generation_top_k"))
        spec = model.cache_spec()
        self._num_layers, self._num_heads, self._head_dim = (int(spec[0]), int(spec[1]),
                                                             int(spec[2]))
        # no speculative scratch margin: the store is the window
        self.store_len = self.cache_len
        self.jit = bool(jit)
        self.check_memory_budget()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # one lock around every dispatch and page operation: prefill (HTTP
        # handlers' admissions through the batcher) and decode write the
        # same cache, and /statz reads the pool
        self._lock = threading.RLock()
        self._kv = None
        self._pinned = {}
        self.last_logits = None
        # warmup turns prefix sharing off: every bucket must capture its
        # own graph, not a shorter suffix's
        self._prefix_enabled = True
        self.reset()
        self._stores = {label: GraphStore(f"generation_{label}") for label in ("prefill",
                                                                               "decode")}
        self._instance = next(_instances)
        self.warmed = False
        self.watch = CompileWatch(self.compile_count)

    # -- state ------------------------------------------------------------------

    def reset(self):
        """Zero every slot (caches empty, positions 0) in place, so the
        graphs captured over the cache stay valid; a paged engine also
        starts its pool, page tables and prefix index afresh."""
        with self._lock:
            if self._kv is None:
                if self.paged:
                    self._kv = _paging.init_paged_cache(
                        self._num_layers, self._num_heads, self._head_dim, self.page_size,
                        self._pool_usable(), self.slots, self._pages_per_slot,
                        self.kv_cache_dtype, self.device)
                    # the host mirror of the table: pinned, so _sync_table
                    # copies it straight to the card
                    self._table_buf = torch.full(
                        (self.slots, self._pages_per_slot), _paging.TRASH_PAGE,
                        dtype=torch.int32, pin_memory=self.device.type == "cuda")
                    self._table_host = self._table_buf.numpy()
                else:
                    self._kv = _cache.init_cache(self._num_layers, self.slots, self._num_heads,
                                                 self.store_len, self._head_dim,
                                                 self.kv_cache_dtype, self.device)
            else:
                for a in self._kv:
                    a.zero_()
            if self.paged:
                self._kv[-2].fill_(_paging.TRASH_PAGE)
                self._table_host[:] = _paging.TRASH_PAGE
                self._pool = _paging.PagePool(self._pool_usable(), self.page_size)
                self._index = _paging.PrefixIndex(self._pool)
                self._pos_host = np.zeros(self.slots, np.int64)
                self._slot_live = [False] * self.slots
                self._slot_tenant = ["default"] * self.slots
                # per-tenant prefix accounting (prompt vs shared tokens)
                self._prefix_tenants = {}
        return self

    @property
    def kv(self):
        """The persistent cache: ``(k [L, S, H, C, D], v, pos [S])`` (int8:
        ``(k, v, k_scale, v_scale, pos)``); paged, ``(k [L, P, H, ps, D], v,
        [k_scale, v_scale,] table [S, NP], pos)``."""
        return self._kv

    def cache_nbytes(self) -> int:
        """Device bytes the whole decode cache occupies (values, scales,
        table, positions), read off the tensors."""
        return _cache.cache_nbytes(self._kv)

    def kv_bytes_per_token(self) -> int:
        """Cache bytes one decoded token occupies across all layers."""
        return _cache.kv_bytes_per_token(self._num_layers, self._num_heads, self._head_dim,
                                         self.kv_cache_dtype)

    # -- memory planning --------------------------------------------------------

    def param_nbytes(self) -> int:
        """Device bytes of the model's parameters and buffers."""
        return int(sum(t.numel() * t.element_size()
                       for t in itertools.chain(self.model.parameters(), self.model.buffers())))

    def _pool_usable(self, slots=None) -> int:
        """Usable pages (the trash page apart) of the pool for ``slots``
        slots: the configured count, or slots x pages-per-slot."""
        n = int(slots if slots is not None else self.slots)
        return self._pool_pages_cfg or n * self._pages_per_slot

    def page_nbytes(self, kv_cache_dtype=None) -> int:
        """Pool bytes ONE page costs across all layers (values, and scales
        at int8)."""
        dtype = str(kv_cache_dtype if kv_cache_dtype is not None else self.kv_cache_dtype)
        return _paging.page_nbytes(self._num_layers, self._num_heads, self._head_dim,
                                   self.page_size, dtype)

    def slot_nbytes(self, kv_cache_dtype=None) -> int:
        """Cache bytes one decode slot costs. Ring: ``store_len x
        kv_bytes_per_token`` plus its position word. Paged: its window's
        pages x ``page_nbytes`` plus its table row and position word."""
        dtype = str(kv_cache_dtype if kv_cache_dtype is not None else self.kv_cache_dtype)
        if self.paged:
            return (self._pages_per_slot * self.page_nbytes(dtype)
                    + self._pages_per_slot * 4 + 4)
        return self.store_len * _cache.kv_bytes_per_token(
            self._num_layers, self._num_heads, self._head_dim, dtype) + 4

    def hbm_required_bytes(self, slots=None, kv_cache_dtype=None) -> int:
        """Device bytes the geometry holds resident: weights plus ``slots``
        rings, or weights plus the pool, the trash page and the tables;
        equal to ``param_nbytes() + cache_nbytes()`` on the real tensors in
        both layouts."""
        n = int(slots if slots is not None else self.slots)
        if self.paged:
            pool = self._pool_pages_cfg or n * self._pages_per_slot
            return (self.param_nbytes() + (pool + 1) * self.page_nbytes(kv_cache_dtype)
                    + n * (self._pages_per_slot * 4 + 4))
        return self.param_nbytes() + n * self.slot_nbytes(kv_cache_dtype)

    def _budget_bytes(self) -> int:
        """The card's memory (``torch.cuda.mem_get_info``); 0, unknown, on
        the CPU."""
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.mem_get_info(self.device)[1])

    def suggest_decode_slots(self, hbm_budget_bytes=None, kv_cache_dtype=None) -> int:
        """Decode slots that fit ``hbm_budget_bytes`` (default: the card's
        memory): ``(budget - weights) // slot_nbytes``, the trash page taken
        off first under the paged layout."""
        budget = self._budget_bytes() if hbm_budget_bytes is None else int(hbm_budget_bytes)
        avail = budget - self.param_nbytes()
        if self.paged:
            avail -= self.page_nbytes(kv_cache_dtype)  # the trash page
        if avail <= 0:
            return 0
        return int(avail // self.slot_nbytes(kv_cache_dtype))

    def check_memory_budget(self, level=None, budget_bytes=None):
        """Refuse (``strict``) or warn about a geometry whose weights and
        cache exceed the card's memory; ``level`` defaults to
        ``FLAGS_memory_budget_check``. Returns the required bytes when
        admitted (and None when the check is off)."""
        lvl = str(level if level is not None else flag("memory_budget_check")).strip().lower()
        if lvl in ("", "0", "off", "false", "no"):
            return None
        budget = int(budget_bytes if budget_bytes is not None else self._budget_bytes())
        required = self.hbm_required_bytes()
        if budget <= 0 or required <= budget:
            return required
        fits = self.suggest_decode_slots(budget)
        msg = (f"generation geometry cannot fit: {self.slots} slot(s) x cache_len "
               f"{self.cache_len} (store {self.store_len}) x {self.kv_cache_dtype} KV "
               f"({self.kv_cache_layout}) needs {_fmt_bytes(required)} (weights "
               f"{_fmt_bytes(self.param_nbytes())} + {_fmt_bytes(self.slot_nbytes())}/slot) "
               f"against {_fmt_bytes(budget)} HBM; suggest_decode_slots({budget}) = {fits}"
               + ("" if self.kv_cache_dtype == "int8" else
                  f" (int8 KV would fit {self.suggest_decode_slots(budget, 'int8')})"))
        if lvl == "strict":
            raise MemoryBudgetError(msg, budget_bytes=budget)
        warnings.warn(f"memory_budget_check={lvl}: {msg}", RuntimeWarning, stacklevel=3)
        return required

    # -- compile accounting -----------------------------------------------------

    def compile_count(self) -> int:
        """Graphs this engine has captured (its stores' misses): the JAX
        ``profiler.counters()[COMPILE_COUNTER]`` of one engine."""
        return sum(s.misses for s in self._stores.values())

    def graphs(self) -> int:
        """Graphs this engine holds."""
        return sum(len(s) for s in self._stores.values())

    def extra_compiles(self) -> int:
        """Captures since warmup: steady state keeps this 0."""
        return self.watch.extra()

    def expected_compiles(self, kind="generate") -> int:
        """Graphs :meth:`warmup` captures: one per prefill bucket and the
        decode graph, in every layout and dtype. The disaggregated kinds
        raise."""
        if kind == "generate":
            return len(self.prefill_buckets) + 1
        if kind in ("prefill", "decode"):
            raise UnimplementedError(f"backend kind {kind!r}: {_HANDOFF} is not ported yet")
        raise InvalidArgumentError(f"unknown backend kind {kind!r}; expected generate | "
                                   "prefill | decode")

    def warmup(self, kind="generate"):
        """Capture exactly ``expected_compiles(kind)`` graphs (every bucket,
        then the decode step), zero the cache, arm the watch. Prefix sharing
        is off meanwhile: a bucket's pad prompt would otherwise share the
        previous bucket's pages and prefill a shorter, captured suffix.
        Idempotent."""
        if self.warmed:
            return self
        self.expected_compiles(kind)  # validates the kind loudly
        self._prefix_enabled = False
        try:
            for bucket in self.prefill_buckets:
                self.admit(0, [self.pad_id] * int(bucket))
            self.step(np.zeros(self.slots, np.int32), np.zeros(self.slots, np.float32))
        finally:
            self._prefix_enabled = True
        self.reset()  # warmup traffic must not look like live context
        self.watch.arm()
        self.warmed = True
        return self

    # -- dispatch ---------------------------------------------------------------

    def _host(self, t) -> np.ndarray:
        """``t`` on the host: through a pinned buffer from the card, after
        the stream's work is done."""
        if t.device.type != "cuda":
            return t.detach().numpy().copy()
        buf = self._pinned.get((t.shape, t.dtype))
        if buf is None:
            buf = self._pinned[(t.shape, t.dtype)] = torch.empty(t.shape, dtype=t.dtype,
                                                                 pin_memory=True)
        buf.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return buf.numpy().copy()

    def _dispatch(self, label, key, body, inputs):
        """``body(*inputs) -> (tokens, logits)`` through the label's store:
        replayed when its signature was captured, else run eagerly (the
        first run of a signature, then captured). Returns the tokens on the
        host; :attr:`last_logits` holds the logits (a graph's output, which
        its next replay overwrites)."""

        def read(out):
            self.last_logits = out[1]
            return self._host(out[0])

        with self._lock:
            if not (self.jit and _captures(self.device)):
                with torch.no_grad():
                    return read(body(*[x.to(self.device) for x in inputs]))
            store = self._stores[label]
            sig = (self._instance, precision_key(), self.kv_cache_layout,
                   self.kv_cache_dtype) + key
            entry = store.find(sig)
            if entry is None:
                with store.capturing:
                    entry = store.lookup(sig)
                    if entry is None:
                        static = [x.to(self.device, copy=True) for x in inputs]
                        out = _first_run(self.device, lambda: body(*static))
                        store.capture(sig, body, static, generators=[self._gen])
                        return read(out)
            return store.replay(entry, *inputs, read=read)

    @torch.no_grad()
    def _prefill_body(self, slot, tokens, length, temp):
        """The ring's bucketed forward over zeroed window-wide caches,
        installed into ``slot``; the first token from the last real
        position."""
        p = tokens.shape[1]
        fresh = _cache.init_cache(self._num_layers, 1, self._num_heads, self.cache_len,
                                  self._head_dim, self.kv_cache_dtype, tokens.device)
        mask = _cache.prefill_mask(p, self.cache_len, length)
        pos_ids = torch.clamp(torch.arange(p, device=tokens.device),
                              max=self.max_positions - 1)[None]
        logits, _ = self.model(tokens, position_ids=pos_ids, attention_mask=mask,
                               caches=_cache.layer_caches(fresh))
        _cache.insert_slot_kv(self._kv, slot, tuple(a[:, 0] for a in fresh[:-1]), length)
        last = logits[0].index_select(0, (length - 1).reshape(1))
        return sample_logits(last, self._gen, temp, self.top_k), last

    @torch.no_grad()
    def _paged_prefill_body(self, slot, tokens, shared_len, suffix_len, total_len, temp):
        """Full or suffix prefill straight into the pool: ``tokens`` are the
        prompt past its ``shared_len`` mapped prefix tokens (0: a full
        prefill), written at logical positions ``shared_len + t`` through
        the slot's table row, read on the device; the first token from the
        last real suffix position. Admission keeps ``shared_len + bucket``
        inside the window, so the write never wraps into shared pages."""
        p = tokens.shape[1]
        table, pos = self._kv[-2], self._kv[-1]
        row = table.index_select(0, slot)  # [1, NP]
        caches = _paging.paged_layer_caches(self._kv, table=row, pos=shared_len)
        mask = _paging.suffix_prefill_mask(p, self.cache_len, shared_len, suffix_len)
        pos_ids = torch.clamp(shared_len + torch.arange(p, device=tokens.device),
                              max=self.max_positions - 1)[None]
        logits, _ = self.model(tokens, position_ids=pos_ids, attention_mask=mask,
                               caches=caches)
        pos.index_copy_(0, slot, total_len.to(pos.dtype))
        last = logits[0].index_select(0, (suffix_len - 1).reshape(1))
        return sample_logits(last, self._gen, temp, self.top_k), last

    @torch.no_grad()
    def _decode_body(self, tokens, temps):
        """One token for every slot: attend the ring (or its pages), write
        it, advance ``pos``, sample."""
        pos = self._kv[-1]
        caches = (_paging.paged_layer_caches(self._kv) if self.paged
                  else _cache.layer_caches(self._kv))
        pos_ids = torch.clamp(pos.to(torch.int64), max=self.max_positions - 1)[:, None]
        mask = _cache.decode_mask(pos, self.store_len, window=self.cache_len)
        logits, _ = self.model(tokens[:, None], position_ids=pos_ids, attention_mask=mask,
                               caches=caches)
        pos.add_(1)
        last = logits[:, 0]
        return sample_logits(last, self._gen, temps, self.top_k), last

    # -- scheduler primitives ---------------------------------------------------

    def bucket_for(self, prompt_len) -> int:
        """Smallest prefill bucket covering ``prompt_len``."""
        for b in self.prefill_buckets:
            if b >= prompt_len:
                return int(b)
        raise InvalidArgumentError(
            f"prompt of {prompt_len} tokens exceeds the largest prefill bucket "
            f"{self.prefill_buckets[-1]}; raise FLAGS_generation_prefill_buckets or truncate")

    def validate(self, prompt, max_new_tokens) -> int:
        """Admission checks shared by offline generate and the serving
        scheduler; also every token id inside the vocabulary (a CUDA gather
        out of range would fault the card). Returns the prompt length."""
        n = len(prompt)
        if n < 1:
            raise InvalidArgumentError("generation needs a non-empty prompt")
        self.bucket_for(n)  # raises if no bucket covers it
        if max_new_tokens < 1:
            raise InvalidArgumentError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        total = n + int(max_new_tokens)
        if total > self.max_positions:
            raise InvalidArgumentError(
                f"prompt ({n}) + max_new_tokens ({max_new_tokens}) = {total} exceeds the "
                f"model's max_position_embeddings {self.max_positions}")
        if self.vocab_size is not None and not all(0 <= int(t) < self.vocab_size
                                                   for t in prompt):
            raise InvalidArgumentError(f"prompt token ids must lie in [0, {self.vocab_size})")
        return n

    def _padded(self, tokens):
        padded = np.full((1, self.bucket_for(len(tokens))), self.pad_id, np.int64)
        padded[0, :len(tokens)] = np.asarray(tokens, np.int64)
        return torch.from_numpy(padded)

    def admit(self, slot, prompt, temperature=None, tenant=None) -> int:
        """Prefill ``prompt`` into ``slot`` and return the first sampled
        token. A ring slot's previous occupant is overwritten; a paged
        slot's pages are released first. ``tenant`` labels the paged
        layout's prefix accounting; the ring ignores it."""
        temp = self.default_temperature if temperature is None else float(temperature)
        if self.paged:
            return self._admit_paged(int(slot), prompt, temp, tenant)
        tok = self._dispatch("prefill", (self.bucket_for(len(prompt)),), self._prefill_body, [
            torch.tensor([int(slot)], dtype=torch.int64), self._padded(prompt),
            torch.tensor([len(prompt)], dtype=torch.int64),
            torch.tensor([temp], dtype=torch.float32)])
        return int(tok[0])

    def step(self, tokens, temps) -> np.ndarray:
        """Decode one token for every slot from host ``tokens``/``temps``
        ``[S]`` (vacant slots: anything; their output is ignored). Paged:
        every busy slot's write page is made private first. Returns ``[S]``
        int32."""
        toks = torch.from_numpy(np.asarray(tokens, np.int64).reshape(self.slots).copy())
        ts = torch.from_numpy(np.asarray(temps, np.float32).reshape(self.slots).copy())
        with self._lock:
            if self.paged:
                self._prepare_decode_writes()
            out = self._dispatch("decode", (), self._decode_body, [toks, ts]).astype(np.int32)
            if self.paged:
                for s, live in enumerate(self._slot_live):
                    if live:
                        self._pos_host[s] += 1
        return out

    # -- paged layout: host-side page management --------------------------------
    #
    # Everything below runs on the host between replays, under the engine's
    # lock; the device tensors keep their shapes and storage, so nothing
    # here can add a capture.

    def _sync_table(self):
        """Copy the host mirror into the persistent device table, on the
        engine's stream before the next replay. The copy blocks until it
        has landed, so the host may edit the mirror right after."""
        self._kv[-2].copy_(self._table_buf)

    def _copy_page(self, src, dst):
        """Copy pool page ``src`` onto ``dst`` in place across every layer
        (values, and scales at int8): the copy half of copy-on-write."""
        for a in self._kv[:-2]:
            a[:, dst].copy_(a[:, src])

    def _alloc_pages(self, need):
        """``need`` private pages off the free list, evicting LRU
        index-only prefix pages when it runs dry. Raises
        :class:`~paddle_tpu_torch.generation.paging.PagePoolExhaustedError`,
        handing out nothing, when the pool cannot supply them."""
        need = int(need)
        if need > self._pool.free_pages():
            self._index.evict(need - self._pool.free_pages())
        if need > self._pool.free_pages():
            raise _paging.PagePoolExhaustedError(
                f"page pool exhausted: need {need} pages, {self._pool.free_pages()} free and "
                f"nothing evictable (pool {self._pool.pages} pages x {self.page_size} tokens; "
                "raise FLAGS_generation_kv_pool_pages or lower concurrency)")
        return [self._pool.alloc() for _ in range(need)]

    def release_slot(self, slot):
        """Reclaim a vacated slot's pages: drop its reference on every mapped
        page (pages the prefix index holds stay as prefix cache, private
        ones go back to the free list) and point its table row at the trash
        page. Nothing to do on the ring: its slots are overwritten."""
        if not self.paged:
            return
        with self._lock:
            slot = int(slot)
            row = self._table_host[slot]
            if not self._slot_live[slot] and not row.any():
                return
            for pid in row:
                if int(pid) != _paging.TRASH_PAGE:
                    self._pool.release(int(pid))
            self._table_host[slot] = _paging.TRASH_PAGE
            self._slot_live[slot] = False
            self._pos_host[slot] = 0
            self._sync_table()

    def _cap_matched(self, n, m):
        """Cap a prefix match of ``m`` pages so the suffix's bucket fits the
        window without wrapping into the shared pages."""
        while m:
            bucket = self.bucket_for(n - m * self.page_size)
            if m * self.page_size + bucket <= self.cache_len:
                break
            m -= 1
        return m

    def has_capacity(self, prompt_or_length) -> bool:
        """Whether :meth:`admit` would find pages for this prompt now: free
        plus evictable pages against the pages it needs beyond its indexed
        prefix (a length: no prefix). Always on the ring."""
        if not self.paged:
            return True
        ps = self.page_size
        with self._lock:
            if isinstance(prompt_or_length, (int, np.integer)):
                n, m = int(prompt_or_length), 0
            else:
                prompt = list(prompt_or_length)
                n = len(prompt)
                m = self._cap_matched(n, len(self._index.known(
                    _paging.chain_hashes(prompt, ps)[:(n - 1) // ps]))) \
                    if self._prefix_enabled else 0
            need = -(-n // ps) - m
            return self._pool.free_pages() + self._index.evictable() >= need

    def _admit_paged(self, slot, prompt, temp, tenant):
        """Paged admission: map the longest indexed prefix (full pages only,
        capped so the suffix keeps a real token and its bucket cannot
        wrap), allocate private pages for the rest, register the prompt's
        full pages in the index, copy the table to the card, and replay the
        suffix's bucket."""
        n = self.validate(prompt, 1)
        ps = self.page_size
        with self._lock:
            self.release_slot(slot)
            hashes = _paging.chain_hashes(prompt, ps)
            matched = []
            if self._prefix_enabled:
                # at most (n - 1) // ps pages: the suffix keeps a token to
                # sample the first one from
                matched = self._index.match(hashes[:(n - 1) // ps])
                matched = matched[:self._cap_matched(n, len(matched))]
            m = len(matched)
            shared_len = m * ps
            suffix = list(prompt)[shared_len:]
            total_pages = -(-n // ps)
            # retain before allocating: _alloc_pages may evict index pages
            # held only by the index, which the matched ones are until now
            for pid in matched:
                self._pool.retain(pid)
            try:
                new_pages = self._alloc_pages(total_pages - m)
            except _paging.PagePoolExhaustedError:
                for pid in matched:
                    self._pool.release(pid)
                raise
            row = np.full(self._pages_per_slot, _paging.TRASH_PAGE, np.int32)
            row[:m] = matched
            row[m:total_pages] = new_pages
            self._table_host[slot] = row
            self._pos_host[slot] = n
            self._slot_live[slot] = True
            t = "default" if tenant is None else str(tenant)
            self._slot_tenant[slot] = t
            if self._prefix_enabled:
                self._index.insert(hashes[:n // ps], [int(p) for p in row[:n // ps]])
            self._sync_table()
            self._note_prefix(t, n, shared_len, m)
            tok = self._dispatch("prefill", (self.bucket_for(len(suffix)),),
                                 self._paged_prefill_body, [
                                     torch.tensor([slot], dtype=torch.int64),
                                     self._padded(suffix),
                                     torch.tensor([shared_len], dtype=torch.int64),
                                     torch.tensor([len(suffix)], dtype=torch.int64),
                                     torch.tensor([n], dtype=torch.int64),
                                     torch.tensor([temp], dtype=torch.float32)])
        return int(tok[0])

    def _note_prefix(self, tenant, prompt_tokens, shared_tokens, matched_pages):
        """Per-tenant prefix-reuse accounting (``paging_stats()
        ["per_tenant"]``). The JAX engine also sets its registry gauges and
        records a ``prefix_reuse`` flight event here; those wait for the
        monitor (ROADMAP.md Queue A item 10)."""
        st = self._prefix_tenants.setdefault(tenant, {"lookups": 0, "hits": 0,
                                                      "prompt_tokens": 0, "shared_tokens": 0})
        st["lookups"] += 1
        st["prompt_tokens"] += int(prompt_tokens)
        if matched_pages:
            st["hits"] += 1
            st["shared_tokens"] += int(shared_tokens)

    def _prepare_decode_writes(self):
        """Make every busy slot's next write safe before the decode replay:
        it lands on logical page ``(pos % window) // ps``. A first visit (the
        trash page there) allocates; a shared page (a prefix page the ring
        wraps back into, or one the index holds) is copied private first
        (copy-on-write). When no copy page can be had, the index forgets the
        page's chain: a page then private is written in place."""
        changed = False
        for s, live in enumerate(self._slot_live):
            if not live:
                continue
            lp = (int(self._pos_host[s]) % self.cache_len) // self.page_size
            pid = int(self._table_host[s, lp])
            if pid == _paging.TRASH_PAGE:
                (new,) = self._alloc_pages(1)
                self._table_host[s, lp] = new
                changed = True
            elif self._pool.ref[pid] > 1:
                try:
                    (new,) = self._alloc_pages(1)
                except _paging.PagePoolExhaustedError:
                    self._index.forget_page(pid)
                    if self._pool.ref[pid] == 1:
                        continue
                    (new,) = self._alloc_pages(1)
                self._copy_page(pid, new)
                self._pool.release(pid)
                self._table_host[s, lp] = new
                self._pool.cow_copies += 1
                changed = True
        if changed:
            self._sync_table()

    def paging_stats(self) -> dict:
        """The ``/statz`` ``paging`` block: the layout, the pool's occupancy
        and the prefix index's accounting, overall and per tenant."""
        if not self.paged:
            return {"layout": self.kv_cache_layout}
        with self._lock:
            per = {t: dict(st, hit_rate=round(st["shared_tokens"] / st["prompt_tokens"], 4)
                           if st["prompt_tokens"] else None)
                   for t, st in self._prefix_tenants.items()}
            return {
                "layout": self.kv_cache_layout,
                "page_size": self.page_size,
                "pages_per_slot": self._pages_per_slot,
                "pages_total": self._pool.pages,
                "pages_free": self._pool.free_pages(),
                "pages_used": self._pool.used_pages(),
                "pages_shared": self._pool.shared_pages(),
                "peak_pages_used": self._pool.peak_used,
                "cow_copies": self._pool.cow_copies,
                "page_nbytes": self.page_nbytes(),
                "prefix_index": self._index.stats(),
                "per_tenant": per,
            }

    def known_page_hashes(self, hashes):
        """The prefix of ``hashes`` this engine's index holds (empty on the
        ring)."""
        if not self.paged:
            return set()
        with self._lock:
            return self._index.known(list(hashes))

    # -- offline API ------------------------------------------------------------

    def generate(self, prompts, max_new_tokens=None, temperature=None, stop_at_eos=True,
                 continuous=True):
        """Generate for a list of prompts, continuous-batched across the
        slots: a finished sequence vacates its slot and the next prompt is
        admitted at the next step (``continuous=False``: a new group only
        when every slot has drained). Returns one token list per prompt (EOS
        included when hit)."""
        max_new = (self.default_max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        for prompt in prompts:
            self.validate(prompt, max_new)
        pending = deque(enumerate(prompts))
        results = [None] * len(prompts)
        active = {}  # slot -> (prompt_idx, tokens)
        last = np.zeros(self.slots, np.int32)
        temps = np.zeros(self.slots, np.float32)
        temp = self.default_temperature if temperature is None else float(temperature)

        def finished(tokens):
            return (len(tokens) >= max_new
                    or (stop_at_eos and self.eos_id is not None and tokens[-1] == self.eos_id))

        while pending or active:
            admit_ok = bool(pending) and (continuous or not active)
            while admit_ok and pending and len(active) < self.slots:
                slot = next(s for s in range(self.slots) if s not in active)
                idx, prompt = pending.popleft()
                tok = self.admit(slot, prompt, temp)
                temps[slot] = temp
                if finished([tok]):
                    results[idx] = [tok]
                    self.release_slot(slot)
                else:
                    active[slot] = (idx, [tok])
                    last[slot] = tok
            if not active:
                continue
            nxt = self.step(last, temps)
            for slot in list(active):
                idx, tokens = active[slot]
                tokens.append(int(nxt[slot]))
                last[slot] = nxt[slot]
                if finished(tokens):
                    results[idx] = tokens
                    del active[slot]
                    self.release_slot(slot)
        return results

    # -- not ported -------------------------------------------------------------

    def spec_step(self, tokens, temps, busy=None):
        raise UnimplementedError(f"spec_step: {_SPECULATIVE} is not ported yet")

    def spec_stats(self) -> dict:
        raise UnimplementedError(f"spec_stats: {_SPECULATIVE} is not ported yet")

    def prefill_export(self, prompt, temperature=None):
        raise UnimplementedError(f"prefill_export: {_HANDOFF} is not ported yet")

    def admit_prefilled(self, slot, planes, length, first_token, prompt=None) -> int:
        raise UnimplementedError(f"admit_prefilled: {_HANDOFF} is not ported yet")

    def admit_prefilled_pages(self, slot, pages, length, first_token, page_size=None,
                              tenant=None) -> int:
        raise UnimplementedError(f"admit_prefilled_pages: {_HANDOFF} is not ported yet")

    def prefill_export_pages(self, prompt, temperature=None, known_hashes=()):
        raise UnimplementedError(f"prefill_export_pages: {_HANDOFF} is not ported yet")
