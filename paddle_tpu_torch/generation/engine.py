"""The generation engine: bucketed prefill + cached decode, as CUDA graphs (``paddle_tpu/generation/engine.py:87-1642``; ring and paged layouts, float32 and int8, speculative decoding and the prefill/decode handoff).

The JAX engine compiles one program per prefill bucket and one decode
program over every slot, and replaces its cache arrays functionally. The
port keeps the same split and the same compile accounting with CUDA graphs
in ``runtime/compiled.py`` stores (``prefill``, ``decode``, ``draft``,
``verify``):

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
- **Speculative decoding** (``draft_model=``, ring layout): the store
  widens to ``cache_len + draft_k`` entries, and a persistent draft ring of
  the draft's layers shares the target's ``pos``. A prefill graph fills
  both rings; a round is the **draft graph** (``k + 1`` chained greedy
  draft steps over every slot, the proposals fed forward on the device)
  and the **verify graph** (one target forward over ``[last | proposals]``
  that writes the span at ``(pos + t) % store``, draws ``k + 1`` samples,
  accepts the proposals' longest prefix equal to them and advances ``pos``
  by the emitted count on the device). Greedy output equals the plain
  engine's.
- **The handoff** (the ``prefill`` and ``decode`` backend kinds): a graph
  per bucket writes the window-wide planes into a persistent export buffer
  (:meth:`~GenerationEngine.prefill_export`), copied to the host through a
  pinned buffer before the lock is released; a decode tier installs them
  with a pinned host-to-device copy and ``index_copy_``
  (:meth:`~GenerationEngine.admit_prefilled`), or page by page under the
  paged layout (:meth:`~GenerationEngine.admit_prefilled_pages`). A
  prefill tier's warmup drops the decode cache: it holds no ring.
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
  :meth:`~GenerationEngine.warmup` makes exactly
  :meth:`~GenerationEngine.expected_compiles` of the backend kind (with
  prefix sharing off, so every bucket captures its own) and arms
  :attr:`~GenerationEngine.watch`; ``extra_compiles()`` must then stay 0.
- **Sampling.** One ``torch.Generator`` on the card, registered with every
  graph that samples, so each replay draws anew.
- **No host decision inside a graph.** Slots and lengths are gathered and
  ``index_copy_``'d as device tensors; positions are clamped on the device;
  the sampled tokens are copied out after the replay through a pinned
  buffer. One lock serializes every dispatch and every page operation:
  prefill and decode write the same cache.

On the CPU (``device="cpu"``) the same bodies run eagerly at every call.
A speculative round bumps the registry's ``generation/spec_rounds_total``,
``spec_proposed_total`` and ``spec_accepted_total``, and a capture after
warmup ``serving/gen_unexpected_compiles``, as the JAX engine does. Its
registry gauges and flight events are not wired yet (ROADMAP.md Queue A
item 10, the part left); the accounting behind them is here
(:meth:`GenerationEngine.paging_stats`, :meth:`GenerationEngine.spec_stats`).
"""
from __future__ import annotations

import itertools
import operator
import threading
import warnings
from collections import deque

import numpy as np
import torch

from ..analysis.memory import MemoryBudgetError, _fmt_bytes, hbm_budget_bytes
from ..device import resolve_device
from ..errors import InvalidArgumentError, PreconditionNotMetError
from ..flags import flag
from ..framework.jit import _captures, _first_run, _set_precision
from ..monitor import counter
from ..runtime.compiled import CompileWatch, GraphStore, precision_key
from ..serving.batcher import parse_buckets
from . import cache as _cache
from . import paging as _paging
from .handoff import HandoffError
from .sampling import sample_logits

__all__ = ["GenerationEngine", "COMPILE_COUNTER", "MemoryBudgetError"]

#: the JAX package's counter of generation compiles; the port's count is
#: the misses of an engine's two stores (:meth:`GenerationEngine.compile_count`)
COMPILE_COUNTER = "generation::compile"

_instances = itertools.count()


class GenerationEngine:
    """Slot-structured generation over a causal LM.

    ``model`` exposes ``forward(input_ids, position_ids, attention_mask,
    caches) -> (logits, caches)`` with per-layer :class:`nn.StaticCache`
    (and its int8 and paged forms) and ``cache_spec()``
    (:class:`~paddle_tpu_torch.models.GPTForCausalLM`). The two scheduler
    primitives are :meth:`admit` (prefill a prompt into a slot, return the
    first token) and :meth:`step` (one token for every slot), or with a
    ``draft_model`` :meth:`spec_step` (one draft/verify round). ``device``
    is the card unless the caller names another (the models move there);
    ``jit=False`` runs every call eagerly on the card too (the captured
    path's control)."""

    def __init__(self, model, *, slots=None, cache_len=None, prefill_buckets=None, eos_id=None,
                 pad_id=None, max_new_tokens=None, temperature=None, top_k=None,
                 kv_cache_dtype=None, kv_cache_layout=None, kv_page_size=None,
                 kv_pool_pages=None, draft_model=None, draft_k=None, seed=0, device=None,
                 jit=True):
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
        self.speculative = draft_model is not None
        self.draft_k = int(draft_k if draft_k is not None else flag("speculative_draft_k"))
        if self.paged and self.speculative:
            raise InvalidArgumentError(
                "speculative decoding does not compose with kv_cache_layout=paged yet; run the "
                "draft engine on the ring layout")
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
        self.draft_model = None
        if self.speculative:
            self._check_draft(draft_model, cfg)
            self.draft_model = draft_model.to(self.device)
            draft_model.eval()
        # the verify span writes k entries past the window: the ring store
        # carries them as scratch, so no write lands on a live window entry
        self.store_len = self.cache_len + (self.draft_k if self.speculative else 0)
        self.jit = bool(jit)
        self.check_memory_budget()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # one lock around every dispatch and page operation: prefill (HTTP
        # handlers' admissions through the batcher) and decode write the
        # same cache, and /statz reads the pool
        self._lock = threading.RLock()
        self._kv = None
        # slots the decode cache holds: all of them, or none on a prefill
        # tier (set by warmup(kind="prefill"))
        self._ring_slots = self.slots
        self._export = None  # the prefill-export buffer, made at first use
        self._pinned = {}
        self.last_logits = None
        # warmup turns prefix sharing off: every bucket must capture its
        # own graph, not a shorter suffix's
        self._prefix_enabled = True
        self._stats_lock = threading.Lock()
        self._spec_rounds = self._spec_proposed = self._spec_accepted = 0
        self.reset()
        self._stores = {label: GraphStore(f"generation_{label}")
                        for label in ("prefill", "decode", "draft", "verify")}
        self._instance = next(_instances)
        self.warmed = False
        self.watch = CompileWatch(self.compile_count, metric="serving/gen_unexpected_compiles",
                                  event="generation_unexpected_compile")

    def _check_draft(self, draft, cfg):
        """The JAX engine's draft checks: ``draft_k >= 1``, the target's
        vocabulary, and positions covering the target's (the draft decodes
        the same positions; a shorter table would gather clamped
        embeddings)."""
        if self.draft_k < 1:
            raise InvalidArgumentError(f"speculative draft_k must be >= 1, got {self.draft_k}")
        dspec = draft.cache_spec()
        self._draft_layers, self._draft_heads, self._draft_dim = (int(dspec[0]), int(dspec[1]),
                                                                  int(dspec[2]))
        dcfg = getattr(draft, "config", None)
        self._draft_max_positions = int(getattr(dcfg, "max_position_embeddings", 1 << 30))
        dvocab, tvocab = getattr(dcfg, "vocab_size", None), getattr(cfg, "vocab_size", None)
        if dvocab is not None and tvocab is not None and int(dvocab) != int(tvocab):
            raise InvalidArgumentError(f"draft model vocab ({dvocab}) must match the target "
                                       f"({tvocab}); proposals are target token ids")
        tmax = int(getattr(cfg, "max_position_embeddings", 1 << 30))
        if self._draft_max_positions < tmax:
            raise InvalidArgumentError(
                f"draft max_position_embeddings ({self._draft_max_positions}) must cover the "
                f"target's ({tmax}); the draft decodes the same positions")

    # -- state ------------------------------------------------------------------

    def reset(self):
        """Zero every slot (caches empty, positions 0) in place, so the
        graphs captured over the cache stay valid; a paged engine also
        starts its pool, page tables and prefix index afresh. The cache is
        made anew only when its slot count changed (a prefill tier's
        warmup drops it)."""
        with self._lock:
            n = self._ring_slots
            if self._kv is None or self._kv[-1].shape[0] != n:
                self._kv = None  # the old cache goes before the new one is made
                self._kv_draft = None
                if self.paged:
                    # a prefill tier (no slots) keeps only the trash page
                    self._kv = _paging.init_paged_cache(
                        self._num_layers, self._num_heads, self._head_dim, self.page_size,
                        self._pool_usable() if n else 0, n, self._pages_per_slot,
                        self.kv_cache_dtype, self.device)
                    # the host mirror of the table: pinned, so _sync_table
                    # copies it straight to the card
                    self._table_buf = torch.full(
                        (n, self._pages_per_slot), _paging.TRASH_PAGE,
                        dtype=torch.int32, pin_memory=self.device.type == "cuda")
                    self._table_host = self._table_buf.numpy()
                else:
                    self._kv = _cache.init_cache(self._num_layers, n, self._num_heads,
                                                 self.store_len, self._head_dim,
                                                 self.kv_cache_dtype, self.device)
                if self.speculative:
                    # the draft ring: the draft's layers, no pos of its own
                    # (the target's serves both: they hold the same history)
                    self._kv_draft = _cache.init_cache(
                        self._draft_layers, n, self._draft_heads, self.store_len,
                        self._draft_dim, self.kv_cache_dtype, self.device)[:-1]
            else:
                for a in self._kv + (self._kv_draft or ()):
                    a.zero_()
            if self.paged:
                self._kv[-2].fill_(_paging.TRASH_PAGE)
                self._table_host[:] = _paging.TRASH_PAGE
                self._pool = _paging.PagePool(self._pool_usable(), self.page_size) if n else None
                self._index = _paging.PrefixIndex(self._pool) if n else None
                self._pos_host = np.zeros(n, np.int64)
                self._slot_live = [False] * n
                self._slot_tenant = ["default"] * n
                # per-tenant prefix accounting (prompt vs shared tokens)
                self._prefix_tenants = {}
        return self

    def _need_ring(self, what):
        if not self._ring_slots:
            raise PreconditionNotMetError(
                f"{what}: this engine was warmed up as a prefill tier and holds no decode "
                "cache; it serves prefill_export only")

    @property
    def kv(self):
        """The persistent cache: ``(k [L, S, H, C, D], v, pos [S])`` (int8:
        ``(k, v, k_scale, v_scale, pos)``); paged, ``(k [L, P, H, ps, D], v,
        [k_scale, v_scale,] table [S, NP], pos)``."""
        return self._kv

    def cache_nbytes(self) -> int:
        """Device bytes the whole decode cache occupies (values, scales,
        table, positions, and the draft ring when speculative), read off
        the tensors."""
        return _cache.cache_nbytes(self._kv + (self._kv_draft or ()))

    def kv_bytes_per_token(self) -> int:
        """Cache bytes one decoded token occupies across all layers."""
        return _cache.kv_bytes_per_token(self._num_layers, self._num_heads, self._head_dim,
                                         self.kv_cache_dtype)

    # -- memory planning --------------------------------------------------------

    def param_nbytes(self) -> int:
        """Device bytes of the model's parameters and buffers, and the
        draft's when speculative (a tensor both hold, as in a self-draft,
        once)."""
        models = (self.model,) + ((self.draft_model,) if self.speculative else ())
        tensors = {id(t): t for m in models
                   for t in itertools.chain(m.parameters(), m.buffers())}
        return int(sum(t.numel() * t.element_size() for t in tensors.values()))

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
        kv_bytes_per_token`` plus its position word, plus the draft ring's
        when speculative. Paged: its window's pages x ``page_nbytes`` plus
        its table row and position word."""
        dtype = str(kv_cache_dtype if kv_cache_dtype is not None else self.kv_cache_dtype)
        if self.paged:
            return (self._pages_per_slot * self.page_nbytes(dtype)
                    + self._pages_per_slot * 4 + 4)
        per = self.store_len * _cache.kv_bytes_per_token(
            self._num_layers, self._num_heads, self._head_dim, dtype) + 4
        if self.speculative:
            per += self.store_len * _cache.kv_bytes_per_token(
                self._draft_layers, self._draft_heads, self._draft_dim, dtype)
        return per

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
        """The memory budget of the engine's device
        (``analysis.hbm_budget_bytes``: the card's memory, or
        ``FLAGS_device_peaks`` ``hbm_bytes=``); 0, unknown, on the CPU
        without the flag."""
        return hbm_budget_bytes(self.device)

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
        """Graphs :meth:`warmup` captures for a backend ``kind``, in every
        layout and dtype: ``generate``, one per prefill bucket and the
        decode graph (speculative: the draft and verify graphs);
        ``prefill``, one export graph per bucket; ``decode``, the decode
        graph (speculative: draft and verify, and a draft-prefill graph per
        bucket, since a handed-off slab holds the target's cache only)."""
        buckets = len(self.prefill_buckets)
        decode = 2 if self.speculative else 1
        if kind == "generate":
            return buckets + decode
        if kind == "prefill":
            return buckets
        if kind == "decode":
            return decode + (buckets if self.speculative else 0)
        raise InvalidArgumentError(f"unknown backend kind {kind!r}; expected generate | "
                                   "prefill | decode")

    def warmup(self, kind="generate"):
        """Capture exactly ``expected_compiles(kind)`` graphs, zero the
        cache, reset the speculative accounting, arm the watch. Prefix
        sharing is off meanwhile: a bucket's pad prompt would otherwise
        share the previous bucket's pages and prefill a shorter, captured
        suffix. A prefill tier first drops the decode cache (it never
        decodes). Idempotent."""
        if self.warmed:
            return self
        self.expected_compiles(kind)  # validates the kind loudly
        self._prefix_enabled = False
        try:
            self._warmup_drive(kind)
        finally:
            self._prefix_enabled = True
        self.reset()  # warmup traffic must not look like live context
        with self._stats_lock:
            self._spec_rounds = self._spec_proposed = self._spec_accepted = 0
        self.watch.arm()
        self.warmed = True
        return self

    def _warmup_drive(self, kind):
        pad = self.pad_id
        if kind == "prefill":
            self._ring_slots = 0
            self.reset()
            for bucket in self.prefill_buckets:
                self.prefill_export([pad] * int(bucket))
            return
        if kind == "generate":
            for bucket in self.prefill_buckets:
                self.admit(0, [pad] * int(bucket))
        else:  # decode: the handoff's admission (no graph), and the draft's prefills
            if self.speculative:
                for bucket in self.prefill_buckets:
                    self._admit_draft(0, [pad] * int(bucket))
            self.admit_prefilled(0, self._fresh_slot_planes(), 1, 0,
                                 prompt=[pad] if self.speculative else None)
        zeros = np.zeros(self.slots, np.int32), np.zeros(self.slots, np.float32)
        if self.speculative:
            self.spec_step(*zeros)
        else:
            self.step(*zeros)

    def _fresh_slot_planes(self):
        """Zeroed window-wide planes of one slot on the host: warmup's
        stand-in for a handed-off slab."""
        shape = (self._num_layers, self._num_heads, self.cache_len, self._head_dim)
        if self.kv_cache_dtype == "int8":
            return (np.zeros(shape, np.int8), np.zeros(shape, np.int8),
                    np.zeros(shape[:-1], np.float32), np.zeros(shape[:-1], np.float32))
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32)

    # -- dispatch ---------------------------------------------------------------

    def _host(self, t) -> np.ndarray:
        """``t`` on the host: through a pinned buffer from the card, after
        the stream's work is done."""
        if t.device.type != "cuda":
            return t.detach().numpy().copy()
        buf = self._pinned_buf(t.shape, t.dtype)
        buf.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return buf.numpy().copy()

    def _pinned_buf(self, shape, dtype):
        """The pinned host buffer of ``(shape, dtype)``: a copy through it
        blocks until it is done, so one buffer serves every call."""
        key = (tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(key[0], dtype=dtype, pin_memory=True)
        return buf

    def _upload(self, a, dtype=None):
        """A host plane (numpy, or a tensor on the host) on the engine's
        device, through a pinned buffer (a blocking copy); a tensor already
        there is used as it is. A tensor on another card is refused: it
        never takes a silent trip through the host."""
        if isinstance(a, torch.Tensor):
            if a.device == self.device:
                return a if dtype is None else a.to(dtype)
            if a.device.type != "cpu":
                raise InvalidArgumentError(f"handoff plane on {a.device}; this engine runs on "
                                           f"{self.device}")
            a = a.detach().numpy()
        a = np.asarray(a)
        if a.dtype.kind not in "fiu":
            raise HandoffError(f"handoff plane of dtype {a.dtype}; numeric planes only")
        if self.device.type != "cuda":
            # a copy of its own: a slab's bytes are read-only and shared
            t = torch.from_numpy(np.array(a, copy=True))
        else:
            buf = self._pinned_buf(a.shape, torch.from_numpy(np.empty(0, a.dtype)).dtype)
            buf.numpy()[...] = a
            t = buf.to(self.device)
        return t if dtype is None else t.to(dtype)

    def _upload_pages(self, planes, pool):
        """Shipped page planes (``[L, ...]`` host arrays, one a page) as
        ``[L, n, ...]`` on the engine's device in ``pool``'s dtype. On the
        card they go through one pinned buffer of a slot's whole window of
        pages and a ``[:n]`` view of it: the count varies by request, and a
        buffer a count would pin host memory for every count seen."""
        arrays = [np.asarray(p) for p in planes]
        for a in arrays:
            if a.dtype.kind not in "fiu":
                raise HandoffError(f"handoff plane of dtype {a.dtype}; numeric planes only")
        if self.device.type != "cuda":
            return self._upload(np.stack(arrays, axis=1), pool.dtype)
        page = tuple(pool.shape[:1] + pool.shape[2:])
        buf = self._pinned_buf((self._pages_per_slot,) + page, pool.dtype)
        host = buf.numpy()
        for i, a in enumerate(arrays):
            host[i] = a
        return buf[:len(arrays)].to(self.device).transpose(0, 1)

    def _dispatch(self, label, key, body, inputs, read=None, sample=True):
        """``body(*inputs)`` (a tuple of tensors) through the label's store:
        replayed when its signature was captured, else run eagerly (the
        first run of a signature, then captured; ``sample``: with the
        engine's generator registered). Returns ``read(outputs)``, by
        default the tokens ``outputs[0]`` on the host with
        :attr:`last_logits` set to ``outputs[1]`` (a graph's output, which
        its next replay overwrites)."""

        if read is None:
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
                        out = store.first_run(
                            sig, self.device,
                            lambda: _first_run(self.device, lambda: body(*static)), static)
                        store.capture(sig, body, static,
                                      generators=[self._gen] if sample else [])
                        return read(out)
            return store.replay(entry, *inputs, read=read)

    def _forward_fresh(self, model, dims, tokens, length):
        """One bucketed forward of ``model`` (``dims``: its layers, heads,
        head width) into zeroed window-wide caches: (logits ``[1, P, V]``,
        the slot's planes ``[L, H, C, D]`` and, at int8, scales)."""
        fresh = _cache.init_cache(dims[0], 1, dims[1], self.cache_len, dims[2],
                                  self.kv_cache_dtype, tokens.device)
        logits = self._forward_into(model, fresh, tokens, length)
        return logits, tuple(a[:, 0] for a in fresh[:-1])

    def _forward_into(self, model, cache, tokens, length):
        """The bucketed prefill forward of ``tokens [1, P]`` written into
        ``cache`` (one slot, positions from 0) under the prefill mask of
        the true ``length``; returns the logits."""
        p = tokens.shape[1]
        mask = _cache.prefill_mask(p, self.cache_len, length)
        limit = self.max_positions if model is self.model else self._draft_max_positions
        pos_ids = torch.clamp(torch.arange(p, device=tokens.device), max=limit - 1)[None]
        logits, _ = model(tokens, position_ids=pos_ids, attention_mask=mask,
                          caches=_cache.layer_caches(cache))
        return logits

    def _install_draft(self, slot, tokens, length):
        """The draft's prefill of the prompt, installed into its ring slot
        (no position of its own to set)."""
        _, planes = self._forward_fresh(
            self.draft_model, (self._draft_layers, self._draft_heads, self._draft_dim), tokens,
            length)
        slot = slot.reshape(1).to(torch.int64)
        for a, n in zip(self._kv_draft, _cache.pad_slot_arrays(planes, self.store_len)):
            a.index_copy_(1, slot, n.unsqueeze(1).to(a.dtype))

    def _sample_first(self, logits, length, temp):
        last = logits[0].index_select(0, (length - 1).reshape(1))
        return sample_logits(last, self._gen, temp, self.top_k), last

    @torch.no_grad()
    def _prefill_body(self, slot, tokens, length, temp):
        """The ring's bucketed forward over zeroed window-wide caches,
        installed into ``slot`` (padded to the store); speculative: the
        draft's prefill into its ring too, in the same graph. The first
        token from the last real position."""
        logits, planes = self._forward_fresh(
            self.model, (self._num_layers, self._num_heads, self._head_dim), tokens, length)
        _cache.insert_slot_kv(self._kv, slot, _cache.pad_slot_arrays(planes, self.store_len),
                              length)
        if self.speculative:
            self._install_draft(slot, tokens, length)
        return self._sample_first(logits, length, temp)

    @torch.no_grad()
    def _draft_prefill_body(self, slot, tokens, length):
        """The draft-only prefill of a decode tier's speculative admission:
        the handed-off slab holds the target's cache only."""
        self._install_draft(slot, tokens, length)
        return ()

    @torch.no_grad()
    def _export_body(self, tokens, length, temp):
        """The prefill tier's forward: the persistent export buffer zeroed
        and written by the bucketed forward (the decode cache untouched);
        the first token from the last real position."""
        for a in self._export:
            a.zero_()
        logits = self._forward_into(self.model, self._export, tokens, length)
        return self._sample_first(logits, length, temp)

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
        return self._sample_first(logits, suffix_len, temp)

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

    @torch.no_grad()
    def _draft_body(self, tokens):
        """The draft graph: ``k + 1`` chained greedy draft steps over every
        slot. Step ``j`` writes its input's K/V at ``pos + j`` (so the draft
        ring ends the round holding the whole chain, the last proposal
        included) and feeds its argmax to the next step on the device.
        Returns the proposals ``[S, k]``."""
        pos = self._kv[-1]
        cur, proposals = tokens, []
        for j in range(self.draft_k + 1):
            pj = pos + j
            pos_ids = torch.clamp(pj.to(torch.int64), max=self._draft_max_positions - 1)[:, None]
            mask = _cache.decode_mask(pj, self.store_len, window=self.cache_len)
            logits, _ = self.draft_model(cur[:, None], position_ids=pos_ids,
                                         attention_mask=mask,
                                         caches=_cache.layer_caches(self._kv_draft + (pj,)))
            cur = torch.argmax(logits[:, 0], dim=-1)
            if j < self.draft_k:
                proposals.append(cur)
        return (torch.stack(proposals, dim=1),)

    @torch.no_grad()
    def _verify_body(self, tokens, proposals, temps):
        """The verify graph: one target forward over ``[S, k + 1] = [last |
        proposals]``, its K/V written at ``(pos + t) % store`` (the store's
        scratch margin keeps the span off live window entries); ``k + 1``
        samples ``ts``; the proposals' longest prefix equal to ``ts`` is
        accepted and ``ts`` one past it is the correction or bonus token,
        so a slot emits ``ts[:counts]``, ``counts = accepted + 1``, and
        ``pos`` advances by it, all on the device. Entries written past
        the accepted span stay masked until the next round overwrites
        them."""
        span = self.draft_k + 1
        seq = torch.cat([tokens[:, None], proposals], dim=1)
        pos = self._kv[-1]
        steps = torch.arange(span, device=pos.device)
        pos_ids = torch.clamp(pos.to(torch.int64)[:, None] + steps[None, :],
                              max=self.max_positions - 1)
        mask = _cache.verify_mask(pos, self.store_len, span, window=self.cache_len)
        logits, _ = self.model(seq, position_ids=pos_ids, attention_mask=mask,
                               caches=_cache.layer_caches(self._kv))
        ts = torch.stack([sample_logits(logits[:, i], self._gen, temps, self.top_k)
                          for i in range(span)], dim=1)
        match = (proposals == ts[:, :self.draft_k]).to(torch.int32)
        # int32, as the JAX engine pins it: pos keeps its dtype
        counts = (torch.cumprod(match, dim=1).sum(dim=1) + 1).to(torch.int32)
        pos.add_(counts)
        return ts, counts, logits

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

    def check_handoff(self, length, first_token, prompt=None):
        """A handed-off slab's scalars, checked before anything lands: the
        length inside the window, the first token inside the vocabulary (it
        feeds the next round's embedding gather, and a CUDA gather out of
        range would fault the card), a riding prompt of ``length`` ids
        inside the vocabulary. Returns ``(length, first_token, prompt)`` as
        ints (``prompt`` a list, or None)."""
        try:
            length, tok = operator.index(length), operator.index(first_token)
        except TypeError:
            raise InvalidArgumentError(f"handoff length {length!r} and first token "
                                       f"{first_token!r} must be integers") from None
        if not 1 <= length <= self.cache_len:
            raise InvalidArgumentError(f"handoff length {length} outside [1, {self.cache_len}]")
        if self.vocab_size is not None and not 0 <= tok < self.vocab_size:
            raise InvalidArgumentError(f"handoff first token {tok} outside "
                                       f"[0, {self.vocab_size})")
        if prompt is not None:
            try:
                prompt = [operator.index(t) for t in prompt]
            except TypeError:
                raise InvalidArgumentError("handoff prompt must be a list of token ids "
                                           "(ints)") from None
            if len(prompt) != length:
                raise InvalidArgumentError(f"handoff prompt has {len(prompt)} tokens, the slab's "
                                           f"length is {length}")
            if self.vocab_size is not None and not all(0 <= t < self.vocab_size
                                                       for t in prompt):
                raise InvalidArgumentError(f"prompt token ids must lie in [0, {self.vocab_size})")
        return length, tok, prompt

    def _padded(self, tokens):
        padded = np.full((1, self.bucket_for(len(tokens))), self.pad_id, np.int64)
        padded[0, :len(tokens)] = np.asarray(tokens, np.int64)
        return torch.from_numpy(padded)

    def admit(self, slot, prompt, temperature=None, tenant=None) -> int:
        """Prefill ``prompt`` into ``slot`` and return the first sampled
        token. A ring slot's previous occupant is overwritten; a paged
        slot's pages are released first; a speculative engine prefills the
        draft's ring in the same graph. ``tenant`` labels the paged
        layout's prefix accounting; the ring ignores it."""
        self._need_ring("admit")
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
        self._need_ring("step")
        toks, ts = self._slot_inputs(tokens, temps)
        with self._lock:
            if self.paged:
                self._prepare_decode_writes()
            out = self._dispatch("decode", (), self._decode_body, [toks, ts]).astype(np.int32)
            if self.paged:
                for s, live in enumerate(self._slot_live):
                    if live:
                        self._pos_host[s] += 1
        return out

    def _slot_inputs(self, tokens, temps):
        return (torch.from_numpy(np.asarray(tokens, np.int64).reshape(self.slots).copy()),
                torch.from_numpy(np.asarray(temps, np.float32).reshape(self.slots).copy()))

    def spec_step(self, tokens, temps, busy=None):
        """One speculative round for every slot from host ``tokens``/``temps``
        ``[S]``: the draft graph (``k`` proposals a slot) and the verify
        graph (one target forward over the ``k + 1`` positions). Returns
        ``(ts [S, k + 1], counts [S])`` int32: slot ``s`` produced
        ``ts[s, :counts[s]]`` (the caller truncates at EOS or budget).
        ``busy`` (slot indices; None: all) scopes the acceptance
        accounting to the slots generating."""
        if not self.speculative:
            raise InvalidArgumentError("spec_step needs a draft model; construct the engine "
                                       "with draft_model=")
        self._need_ring("spec_step")
        toks, temps_t = self._slot_inputs(tokens, temps)

        def read(out):
            self.last_logits = out[2]
            return self._host(out[0]), self._host(out[1])

        with self._lock:
            # the proposals stay on the card: the draft graph's output is
            # the verify graph's input
            (proposals,) = self._dispatch("draft", (), self._draft_body, [toks],
                                          read=lambda out: out, sample=False)
            ts, counts = self._dispatch("verify", (), self._verify_body,
                                        [toks, proposals, temps_t], read=read)
        ts, counts = ts.astype(np.int32), counts.astype(np.int32)
        n_busy = self.slots if busy is None else len(busy)
        if n_busy:
            accepted = int(counts.sum() - self.slots if busy is None
                           else sum(int(counts[s]) - 1 for s in busy))
            with self._stats_lock:
                self._spec_rounds += 1
                self._spec_proposed += self.draft_k * n_busy
                self._spec_accepted += accepted
            counter("generation/spec_rounds_total").inc()
            counter("generation/spec_proposed_total").inc(self.draft_k * n_busy)
            counter("generation/spec_accepted_total").inc(accepted)
        return ts, counts

    def spec_stats(self) -> dict:
        """Speculative accounting since the last warmup: rounds, proposed
        and accepted draft tokens, the acceptance rate (``/statz``
        ``speculative``)."""
        with self._stats_lock:
            rounds, proposed, accepted = (self._spec_rounds, self._spec_proposed,
                                          self._spec_accepted)
        return {"enabled": self.speculative,
                "draft_k": self.draft_k if self.speculative else 0,
                "rounds": rounds, "proposed": proposed, "accepted": accepted,
                "acceptance_rate": round(accepted / proposed, 4) if proposed else None}

    # -- the disaggregated handoff ----------------------------------------------

    def prefill_export(self, prompt, temperature=None):
        """The prefill tier's primitive: the bucketed forward into the
        persistent export buffer (the decode cache untouched) and the first
        sampled token. Returns ``(planes, length, first_token)``: the
        window-wide planes (``[L, H, C, D]`` values; int8 also ``[L, H, C]``
        scales) copied to the host through a pinned buffer before the lock
        is released (the next export overwrites the buffer)."""
        n = self.validate(prompt, 1)
        temp = self.default_temperature if temperature is None else float(temperature)

        def read(out):
            self.last_logits = out[1]
            return self._host(out[0]), tuple(self._host(a[:, 0]) for a in self._export[:-1])

        with self._lock:
            if self._export is None:
                self._export = _cache.init_cache(self._num_layers, 1, self._num_heads,
                                                 self.cache_len, self._head_dim,
                                                 self.kv_cache_dtype, self.device)
            tok, planes = self._dispatch(
                "prefill", ("export", self.bucket_for(n)), self._export_body,
                [self._padded(prompt), torch.tensor([n], dtype=torch.int64),
                 torch.tensor([temp], dtype=torch.float32)], read=read)
        return planes, n, int(tok[0])

    def _admit_draft(self, slot, prompt):
        """The draft-only prefill of ``prompt`` into draft slot ``slot``: a
        speculative decode tier's half of a handoff admission."""
        self.validate(prompt, 1)
        self._dispatch("prefill", ("draft", self.bucket_for(len(prompt))),
                       self._draft_prefill_body,
                       [torch.tensor([int(slot)], dtype=torch.int64), self._padded(prompt),
                        torch.tensor([len(prompt)], dtype=torch.int64)],
                       read=lambda out: None, sample=False)

    def admit_prefilled(self, slot, planes, length, first_token, prompt=None) -> int:
        """Land a handed-off slab in decode slot ``slot``: the window-wide
        planes padded to the store and installed in place (a pinned
        host-to-device copy and ``index_copy_``), ``pos[slot]`` set on the
        device. The prefill tier sampled the first token; it is checked
        (:meth:`check_handoff`) and returned. A speculative engine needs the
        ``prompt`` too (the slab holds the target's cache only) for the
        draft's prefill. A paged engine splits the slab into anonymous
        pages."""
        self._need_ring("admit_prefilled")
        length, first_token, prompt = self.check_handoff(length, first_token, prompt)
        slot = int(slot)
        if self.paged:
            arity = len(self._kv) - 2
            if len(planes) != arity:
                raise InvalidArgumentError(
                    f"handoff slab has {len(planes)} planes, this engine's {self.kv_cache_dtype} "
                    f"cache needs {arity} (kv_cache_dtype mismatch between tiers?)")
            per_page = _paging.split_planes(planes, self.page_size)
            pages = [{"id": i, "hash": None, "planes": per_page[i]}
                     for i in range(-(-length // self.page_size))]
            return self.admit_prefilled_pages(slot, pages, length, first_token)
        arity = len(self._kv) - 1
        if len(planes) != arity:
            raise InvalidArgumentError(
                f"handoff slab has {len(planes)} planes, this engine's {self.kv_cache_dtype} "
                f"cache needs {arity} (kv_cache_dtype mismatch between tiers?)")
        if self.speculative and prompt is None:
            raise InvalidArgumentError("a speculative decode tier needs the prompt tokens with "
                                       "the KV slab (the draft ring must be prefilled)")
        with self._lock:
            try:
                padded = _cache.pad_slot_arrays(tuple(self._upload(p) for p in planes),
                                                self.store_len)
            except ValueError as e:
                raise InvalidArgumentError(f"handoff slab does not fit this engine: {e}") from None
            for a, p in zip(self._kv[:-1], padded):
                if tuple(p.shape) != tuple(a.shape[:1] + a.shape[2:]) or p.dtype != a.dtype:
                    raise InvalidArgumentError(
                        f"handoff slab plane {tuple(p.shape)}/{p.dtype} does not fit this "
                        f"engine's cache {tuple(a.shape)}/{a.dtype}")
            if self.speculative:
                self._admit_draft(slot, prompt)
            _cache.insert_slot_kv(self._kv, slot, padded, length)
        return first_token

    def prefill_export_pages(self, prompt, temperature=None, known_hashes=()):
        """Page-granular :meth:`prefill_export`: the same forward, its slab
        cut into pages with chain hashes. Returns ``(pages, length,
        first_token)``, ``pages`` a list of ``{"id", "hash", "planes"}``
        (the partial tail page's hash None); a page whose hash is in
        ``known_hashes`` ships header-only (``planes`` None): the decode
        tier maps it from its own prefix index."""
        planes, n, tok = self.prefill_export(prompt, temperature)
        ps = self.page_size
        per_page = _paging.split_planes(planes, ps)
        hashes = _paging.chain_hashes(prompt, ps)
        known = set(known_hashes)
        pages = []
        for i in range(-(-n // ps)):
            h = hashes[i] if i < len(hashes) else None
            pages.append({"id": i, "hash": h,
                          "planes": None if (h is not None and h in known) else per_page[i]})
        return pages, n, int(tok)

    def admit_prefilled_pages(self, slot, pages, length, first_token, page_size=None,
                              tenant=None) -> int:
        """Land a page-granular handoff in decode slot ``slot``: shipped
        pages go into freshly allocated pool pages (a pinned copy and one
        ``index_copy_`` a plane); header-only pages (``planes`` None) must
        resolve through this engine's prefix index and are mapped
        copy-on-write, retained before the allocation. The whole slab is
        checked before anything is allocated: an unknown header-only page
        refuses it with no page taken. Full shipped pages with hashes join
        the index."""
        if not self.paged:
            raise InvalidArgumentError("page-granular handoff needs kv_cache_layout=paged on "
                                       "the decode tier (ring tiers speak the slab format)")
        self._need_ring("admit_prefilled_pages")
        length, first_token, _ = self.check_handoff(length, first_token)
        slot, ps = int(slot), self.page_size
        if page_size is not None and int(page_size) != ps:
            raise HandoffError(f"page-granular slab page_size {page_size} does not match this "
                               f"engine's {ps}")
        npages = -(-length // ps)
        if len(pages) != npages:
            raise HandoffError(f"page-granular slab carries {len(pages)} pages; length {length} "
                               f"at page size {ps} needs {npages}")
        arrays = self._kv[:-2]
        hashes = [p.get("hash") for p in pages]
        full = length // ps
        chain = []  # the contiguous hashed prefix, resolved by a prefix walk
        for h in hashes[:full]:
            if h is None:
                break
            chain.append(h)
        plan = []
        for i, page in enumerate(pages):
            planes = page.get("planes")
            if planes is None:
                plan.append(("map", i))
                continue
            if len(planes) != len(arrays):
                raise HandoffError(f"page {i} carries {len(planes)} planes, this engine's "
                                   f"{self.kv_cache_dtype} cache needs {len(arrays)}")
            for a, p in zip(arrays, planes):
                if tuple(np.shape(p)) != tuple(a.shape[:1] + a.shape[2:]):
                    raise HandoffError(f"page {i} plane {tuple(np.shape(p))} does not match "
                                       f"this engine's page {tuple(a.shape[:1] + a.shape[2:])}")
            plan.append(("ship", i))
        with self._lock:
            mapped = self._index.match(chain)
            for kind, i in plan:
                if kind == "map" and i >= len(mapped):
                    raise HandoffError(f"page {i} shipped header-only but this tier does not "
                                       "hold its hash chain; the sender must ship the payload")
            self.release_slot(slot)
            # retain the mapped pages before allocating: the allocation may
            # evict pages only the index holds, which these are until now
            map_ids = [mapped[i] for k, i in plan if k == "map"]
            for pid in map_ids:
                self._pool.retain(pid)
            try:
                fresh = self._alloc_pages(sum(1 for k, _ in plan if k == "ship"))
            except _paging.PagePoolExhaustedError:
                for pid in map_ids:
                    self._pool.release(pid)
                raise
            row = np.full(self._pages_per_slot, _paging.TRASH_PAGE, np.int32)
            ship_ids, ship_planes = [], []
            it = iter(fresh)
            for kind, i in plan:
                if kind == "map":
                    row[i] = mapped[i]
                else:
                    row[i] = next(it)
                    ship_ids.append(int(row[i]))
                    ship_planes.append(pages[i]["planes"])
            if ship_ids:
                ids = torch.tensor(ship_ids, dtype=torch.int64, device=self.device)
                for j, a in enumerate(arrays):
                    a.index_copy_(1, ids, self._upload_pages([pl[j] for pl in ship_planes], a))
            self._table_host[slot] = row
            self._pos_host[slot] = length
            self._slot_live[slot] = True
            t = "default" if tenant is None else str(tenant)
            self._slot_tenant[slot] = t
            if self._prefix_enabled and full and all(h is not None for h in hashes[:full]):
                self._index.insert(hashes[:full], [int(p) for p in row[:full]])
            self._sync_table()
            self._kv[-1][slot] = length
            self._note_prefix(t, length, len(map_ids) * ps, len(map_ids))
        return first_token

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
        records a ``prefix_reuse`` flight event here; those are not wired
        yet (ROADMAP.md Queue A item 10, the part left)."""
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
        and the prefix index's accounting, overall and per tenant (a
        prefill tier's: its layout and page size, no pool)."""
        if not self.paged:
            return {"layout": self.kv_cache_layout}
        if self._pool is None:
            return {"layout": self.kv_cache_layout, "page_size": self.page_size,
                    "pages_total": 0}
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
        if not self.paged or self._index is None:
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
            if self.speculative:
                ts, counts = self.spec_step(last, temps, busy=list(active))
                emitted = {s: ts[s, :counts[s]] for s in active}
            else:
                nxt = self.step(last, temps)
                emitted = {s: nxt[s:s + 1] for s in active}
            for slot, toks in emitted.items():
                idx, tokens = active[slot]
                for tok in toks:
                    tokens.append(int(tok))
                    last[slot] = tok
                    if finished(tokens):
                        break
                if finished(tokens):
                    results[idx] = tokens
                    del active[slot]
                    self.release_slot(slot)
        return results
