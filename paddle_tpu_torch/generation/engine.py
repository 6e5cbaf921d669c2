"""The generation engine: bucketed prefill + ring-cache decode, as CUDA graphs (``paddle_tpu/generation/engine.py:87-1642``, the ring path in float32).

The JAX engine compiles one program per prefill bucket and one decode
program over every slot, and replaces its cache arrays functionally. The
port keeps the same split and the same compile accounting with CUDA graphs
in two ``runtime/compiled.py`` stores:

- **Persistent cache.** The engine owns one ``k, v [L, S, H, C, D]`` and
  ``pos [S]`` for its lifetime. Every write goes into them in place: a
  prefill installs a slot with ``index_copy_``, a decode step writes each
  row's ring entry (``nn/transformer.py``) and advances ``pos``, and
  :meth:`reset` zeroes them with ``zero_()``, so the graphs captured over
  them stay valid.
- **One graph per prefill bucket.** Its inputs (the slot, the padded
  tokens, the true length and the temperature) are device tensors, so every
  slot shares it. The forward runs over zeroed window-wide caches, which
  are installed into the slot; the first token is sampled from the last
  real position.
- **One decode graph** over all ``S`` slots: last tokens and temperatures
  in, next tokens out.
- **Compile accounting.** The first call of a signature (the bucket, TF32
  in matrix products) runs eagerly as the real call, then captures; the
  stores' misses are the JAX ``generation::compile`` counter
  (:data:`COMPILE_COUNTER`, :meth:`GenerationEngine.compile_count`).
  :meth:`~GenerationEngine.warmup` makes exactly ``len(buckets) + 1`` and
  arms :attr:`~GenerationEngine.watch`; ``extra_compiles()`` must then stay 0.
- **Sampling.** One ``torch.Generator`` on the card, registered with every
  graph, so each replay draws anew.
- **No host decision inside a graph.** Slots and lengths are gathered and
  ``index_copy_``'d as device tensors; positions are clamped on the device;
  the sampled tokens are copied out after the replay through a pinned
  buffer. One lock serializes every dispatch: prefill and decode write the
  same cache.

On the CPU (``device="cpu"``) the same bodies run eagerly at every call.
The int8 and paged caches, speculative decoding and the disaggregated
prefill/decode kinds raise :class:`~paddle_tpu_torch.errors.UnimplementedError`
naming their ROADMAP entries.
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
from .sampling import sample_logits

__all__ = ["GenerationEngine", "COMPILE_COUNTER", "MemoryBudgetError"]

#: the JAX package's counter of generation compiles; the port's count is
#: the misses of an engine's two stores (:meth:`GenerationEngine.compile_count`)
COMPILE_COUNTER = "generation::compile"

_PAGED = "the paged layout (ROADMAP.md Queue A item 3, entry 2)"
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
    and ``cache_spec()`` (:class:`~paddle_tpu_torch.models.GPTForCausalLM`).
    The two scheduler primitives are :meth:`admit` (prefill a prompt into a
    slot, return the first token) and :meth:`step` (one token for every
    slot). ``device`` is the card unless the caller names another (the
    model moves there); ``jit=False`` runs every call eagerly on the card
    too (the captured path's control)."""

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
        if self.kv_cache_dtype == "int8":
            raise UnimplementedError(f"an int8 KV cache is not ported yet; it comes with "
                                     f"{_cache.INT8_ENTRY}")
        self.kv_cache_layout = str(kv_cache_layout if kv_cache_layout is not None
                                   else flag("kv_cache_layout"))
        if self.kv_cache_layout not in ("ring", "paged"):
            raise InvalidArgumentError(f"kv_cache_layout must be ring | paged, got "
                                       f"{self.kv_cache_layout!r}")
        if self.kv_cache_layout == "paged":
            raise UnimplementedError(f"kv_cache_layout=paged: {_PAGED} is not ported yet")
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
        # the ring store is the window: no speculative scratch margin
        self.store_len = self.cache_len
        self.jit = bool(jit)
        self.check_memory_budget()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        # one lock around every dispatch: prefill (HTTP handlers' admissions
        # through the batcher) and decode write the same cache
        self._lock = threading.RLock()
        self._kv = None
        self._pinned = {}
        self.last_logits = None
        self.reset()
        self._stores = {label: GraphStore(f"generation_{label}") for label in ("prefill",
                                                                               "decode")}
        self._instance = next(_instances)
        self.warmed = False
        self.watch = CompileWatch(self.compile_count)

    # -- state ------------------------------------------------------------------

    def reset(self):
        """Zero every slot (caches empty, positions 0) in place: the graphs
        captured over the cache stay valid."""
        with self._lock:
            if self._kv is None:
                self._kv = _cache.init_cache(self._num_layers, self.slots, self._num_heads,
                                             self.store_len, self._head_dim,
                                             self.kv_cache_dtype, self.device)
            else:
                for a in self._kv:
                    a.zero_()
        return self

    @property
    def kv(self):
        """The persistent cache ``(k [L, S, H, C, D], v, pos [S])``."""
        return self._kv

    def cache_nbytes(self) -> int:
        """Device bytes the whole decode cache occupies (values + positions)."""
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

    def slot_nbytes(self, kv_cache_dtype=None) -> int:
        """Cache bytes one decode slot costs: ``store_len x
        kv_bytes_per_token`` plus its position word."""
        dtype = str(kv_cache_dtype if kv_cache_dtype is not None else self.kv_cache_dtype)
        return self.store_len * _cache.kv_bytes_per_token(
            self._num_layers, self._num_heads, self._head_dim, dtype) + 4

    def hbm_required_bytes(self, slots=None, kv_cache_dtype=None) -> int:
        """Device bytes the geometry holds resident: weights plus ``slots``
        rings; equal to ``param_nbytes() + cache_nbytes()`` on the real
        tensors."""
        n = int(slots if slots is not None else self.slots)
        return self.param_nbytes() + n * self.slot_nbytes(kv_cache_dtype)

    def _budget_bytes(self) -> int:
        """The card's memory (``torch.cuda.mem_get_info``); 0, unknown, on
        the CPU."""
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.mem_get_info(self.device)[1])

    def suggest_decode_slots(self, hbm_budget_bytes=None, kv_cache_dtype=None) -> int:
        """Decode slots that fit ``hbm_budget_bytes`` (default: the card's
        memory): ``(budget - weights) // slot_nbytes``."""
        budget = self._budget_bytes() if hbm_budget_bytes is None else int(hbm_budget_bytes)
        avail = budget - self.param_nbytes()
        if avail <= 0:
            return 0
        return int(avail // self.slot_nbytes(kv_cache_dtype))

    def check_memory_budget(self, level=None, budget_bytes=None):
        """Refuse (``strict``) or warn about a geometry whose weights and
        rings exceed the card's memory; ``level`` defaults to
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
               f"{self.cache_len} (store {self.store_len}) x {self.kv_cache_dtype} KV needs "
               f"{_fmt_bytes(required)} (weights {_fmt_bytes(self.param_nbytes())} + "
               f"{_fmt_bytes(self.slot_nbytes())}/slot) against {_fmt_bytes(budget)} HBM; "
               f"suggest_decode_slots({budget}) = {fits}")
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
        decode graph. The disaggregated kinds raise."""
        if kind == "generate":
            return len(self.prefill_buckets) + 1
        if kind in ("prefill", "decode"):
            raise UnimplementedError(f"backend kind {kind!r}: {_HANDOFF} is not ported yet")
        raise InvalidArgumentError(f"unknown backend kind {kind!r}; expected generate | "
                                   "prefill | decode")

    def warmup(self, kind="generate"):
        """Capture exactly ``expected_compiles(kind)`` graphs (every bucket,
        then the decode step), zero the cache, arm the watch. Idempotent."""
        if self.warmed:
            return self
        self.expected_compiles(kind)  # validates the kind loudly
        for bucket in self.prefill_buckets:
            self.admit(0, [self.pad_id] * int(bucket))
        self.step(np.zeros(self.slots, np.int32), np.zeros(self.slots, np.float32))
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
            sig = (self._instance, precision_key()) + key
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
        """The bucketed forward over zeroed window-wide caches, installed
        into ``slot``; the first token from the last real position."""
        p = tokens.shape[1]
        fk, fv, fpos = _cache.init_cache(self._num_layers, 1, self._num_heads, self.cache_len,
                                         self._head_dim, self.kv_cache_dtype, tokens.device)
        mask = _cache.prefill_mask(p, self.cache_len, length)
        pos_ids = torch.clamp(torch.arange(p, device=tokens.device),
                              max=self.max_positions - 1)[None]
        logits, _ = self.model(tokens, position_ids=pos_ids, attention_mask=mask,
                               caches=_cache.layer_caches(fk, fv, fpos))
        _cache.insert_slot(*self._kv, slot, fk[:, 0], fv[:, 0], length)
        last = logits[0].index_select(0, (length - 1).reshape(1))
        return sample_logits(last, self._gen, temp, self.top_k), last

    @torch.no_grad()
    def _decode_body(self, tokens, temps):
        """One token for every slot: attend the ring, write it, advance
        ``pos``, sample."""
        k, v, pos = self._kv
        pos_ids = torch.clamp(pos.to(torch.int64), max=self.max_positions - 1)[:, None]
        mask = _cache.decode_mask(pos, self.store_len, window=self.cache_len)
        logits, _ = self.model(tokens[:, None], position_ids=pos_ids, attention_mask=mask,
                               caches=_cache.layer_caches(k, v, pos))
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

    def has_capacity(self, prompt_or_length) -> bool:
        """Whether :meth:`admit` finds room: always on the ring layout."""
        return True

    def admit(self, slot, prompt, temperature=None, tenant=None) -> int:
        """Prefill ``prompt`` into ``slot`` (its previous occupant is
        overwritten) and return the first sampled token. ``tenant`` is the
        paged layout's label; the ring ignores it."""
        n = len(prompt)
        bucket = self.bucket_for(n)
        padded = np.full((1, bucket), self.pad_id, np.int64)
        padded[0, :n] = np.asarray(prompt, np.int64)
        temp = self.default_temperature if temperature is None else float(temperature)
        tok = self._dispatch("prefill", (bucket,), self._prefill_body, [
            torch.tensor([int(slot)], dtype=torch.int64), torch.from_numpy(padded),
            torch.tensor([n], dtype=torch.int64), torch.tensor([temp], dtype=torch.float32)])
        return int(tok[0])

    def release_slot(self, slot):
        """A vacated ring slot is simply overwritten at its next admission:
        nothing to do (the paged layout reclaims pages here)."""

    def step(self, tokens, temps) -> np.ndarray:
        """Decode one token for every slot from host ``tokens``/``temps``
        ``[S]`` (vacant slots: anything; their output is ignored). Returns
        ``[S]`` int32."""
        toks = torch.from_numpy(np.asarray(tokens, np.int64).reshape(self.slots).copy())
        ts = torch.from_numpy(np.asarray(temps, np.float32).reshape(self.slots).copy())
        return self._dispatch("decode", (), self._decode_body, [toks, ts]).astype(np.int32)

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
        raise UnimplementedError(f"prefill_export_pages: {_PAGED} is not ported yet")

    def page_nbytes(self, kv_cache_dtype=None) -> int:
        raise UnimplementedError(f"page_nbytes: {_PAGED} is not ported yet")

    def paging_stats(self) -> dict:
        raise UnimplementedError(f"paging_stats: {_PAGED} is not ported yet")

    def known_page_hashes(self, hashes):
        raise UnimplementedError(f"known_page_hashes: {_PAGED} is not ported yet")
