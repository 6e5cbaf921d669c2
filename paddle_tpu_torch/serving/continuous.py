"""Continuous batching: slot-turnover scheduling over a GenerationEngine (``paddle_tpu/serving/continuous.py:51-631``).

The decode graph always runs all ``engine.slots`` rows; a sequence that hits
EOS or its token budget vacates its slot mid-batch, and the next queued
request is admitted into it at the next step (a prefill replay that
installs the slot in place: nothing is captured anew). A speculative engine
runs a draft/verify round instead of a step: each busy slot emits 1 to
``k + 1`` tokens, cut at its own EOS or budget. A decode tier takes
handed-off slabs (:meth:`ContinuousBatcher.submit_prefilled`, and
:meth:`~ContinuousBatcher.submit_prefilled_pages` for the page-granular
form): admission installs the slab instead of running a prefill. Admission follows the
serving queue's contracts: a bounded queue (:class:`QueueFullError`, HTTP
429), deadlines that expire queued requests without dispatch,
:class:`ServingClosedError` after close, and drain. Growth of the engine's
captures after warmup is noted through ``engine.watch``. Pass ``on_token``
to :meth:`ContinuousBatcher.submit` to have every token delivered as it is
decoded (``/generate``'s streaming mode). Under the paged layout
admission also waits for pages (``engine.has_capacity``), and every path
that vacates a slot (finished, failed, stopped) returns its pages through
``engine.release_slot``.

The counters of :attr:`ContinuousBatcher.stats` and the latency samples of
:meth:`ContinuousBatcher.quantiles` feed ``/statz``. The same events feed
the process registry under the JAX names (``serving/gen_*_total``,
``serving/gen_token_ms`` labeled by kind, ``gen_ttft_ms`` and
``gen_e2e_ms`` by kind and tenant), which ``/loadz``, ``/histz`` and
``/metrics`` read; the JAX batcher's per-slot tracing spans and flight
events are not wired into it yet (ROADMAP Queue A item 10, the part left).
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from ..errors import ExecutionTimeoutError, InvalidArgumentError
from ..flags import flag
from ..generation.handoff import PageSlab
from ..monitor import counter, gauge, histogram
from .batcher import DeadlineExceededError, QueueFullError, ServingClosedError

__all__ = ["ContinuousBatcher", "GenerationRequest"]

# latency samples kept per series for /statz quantiles
_SAMPLES = 4096


class GenerationRequest:
    """One submitted generation: the token prompt (or a handed-off slab
    standing in for it), its budget and sampling override, the tokens
    produced so far and a completion event."""

    __slots__ = ("prompt", "prompt_len", "max_new_tokens", "temperature", "deadline", "t_submit",
                 "t_first_token", "tokens", "finish_reason", "on_token", "error", "tenant",
                 "handoff", "_done")

    def __init__(self, prompt, max_new_tokens, temperature, deadline, t_submit, on_token=None,
                 tenant=None, handoff=None, prompt_len=None):
        self.prompt = prompt
        # a handed-off request knows its prompt's length from the slab even
        # when the tokens did not ride along
        self.prompt_len = len(prompt) if prompt_len is None else int(prompt_len)
        # (planes, length, first_token) or a PageSlab: admission installs it
        self.handoff = handoff
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.deadline = deadline  # absolute monotonic seconds, or None
        self.t_submit = t_submit
        self.tenant = "default" if tenant is None else str(tenant)
        self.t_first_token = None
        self.tokens = []
        self.finish_reason = None  # "eos" | "length" | None
        self.on_token = on_token
        self.error = None
        self._done = threading.Event()

    def expired(self, now) -> bool:
        return self.deadline is not None and now > self.deadline

    def done(self, error=None):
        self.error = error
        self._done.set()

    @property
    def finished(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout=None):
        """Block until generation completes; the token list, or the stored
        error raised."""
        if not self._done.wait(timeout):
            raise ExecutionTimeoutError(f"generation not completed within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.tokens


class ContinuousBatcher:
    """Slot scheduler + decode-loop worker over one GenerationEngine."""

    def __init__(self, engine, queue_capacity=None, clock=time.monotonic, kind="generate"):
        self.engine = engine
        self.kind = str(kind)
        self.queue_capacity = int(queue_capacity if queue_capacity is not None
                                  else flag("generation_queue_capacity"))
        if self.queue_capacity <= 0:
            raise InvalidArgumentError(f"generation queue capacity must be positive, got "
                                       f"{self.queue_capacity}")
        self._clock = clock
        self._q = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._drain = True
        self._thread = None
        s = engine.slots
        self._slots = [None] * s  # slot -> GenerationRequest
        self._last = np.zeros(s, np.int32)
        self._temps = np.zeros(s, np.float32)
        # the engine owns the watch (armed by warmup()); the loop notes
        # growth through it after every step
        self._watch = engine.watch
        #: counters read by /statz (written under the lock)
        self.stats = {"requests": 0, "responses": 0, "rejected": 0, "expired": 0, "errors": 0,
                      "tokens": 0, "midbatch_admissions": 0}
        self._latency = {name: deque(maxlen=_SAMPLES) for name in ("token", "ttft", "e2e")}
        # the process registry's series (JAX names), keyed like self.stats
        self._m = {k: counter(f"serving/gen_{m}_total") for k, m in (
            ("requests", "requests"), ("responses", "responses"), ("rejected", "rejected"),
            ("expired", "expired"), ("errors", "errors"), ("tokens", "tokens"),
            ("midbatch_admissions", "midbatch_admissions"))}
        self._m_depth = gauge("serving/gen_queue_depth")
        self._m_busy = gauge("serving/gen_slots_busy")
        self._h = {name: histogram(f"serving/gen_{name}_ms") for name in ("token", "ttft", "e2e")}

    def _count(self, **inc):
        with self._lock:
            for k, v in inc.items():
                self.stats[k] += v
        for k, v in inc.items():
            self._m[k].inc(v)

    def _observe(self, name, ms, tenant=None):
        """A latency sample for ``/statz`` and the registry's histogram,
        labeled by kind (and tenant, except the per-step ``token``: one step
        serves slots of several tenants)."""
        with self._lock:
            self._latency[name].append(ms)
        dims = {"kind": self.kind} if tenant is None else {"kind": self.kind, "tenant": tenant}
        self._h[name].labels(**dims).observe(ms)

    def quantiles(self, name):
        """``{"p50_ms", "p99_ms", "count"}`` of the ``token`` (a decode
        step, what a stream waits between tokens), ``ttft`` or ``e2e``
        samples (the latest 4096), or None before the first."""
        with self._lock:
            xs = np.asarray(self._latency[name], np.float64)
        if xs.size == 0:
            return None
        return {"p50_ms": round(float(np.quantile(xs, 0.5)), 3),
                "p99_ms": round(float(np.quantile(xs, 0.99)), 3), "count": int(xs.size)}

    # -- client side -------------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def live_slots(self) -> int:
        return sum(r is not None for r in self._slots)

    def occupancy(self) -> float:
        return self.live_slots / self.engine.slots

    def extra_compiles(self) -> int:
        return self.engine.extra_compiles()

    def submit(self, prompt, max_new_tokens=None, temperature=None, deadline_ms=None,
               on_token=None, tenant=None) -> GenerationRequest:
        """Enqueue one generation request, validated now (a malformed prompt
        never occupies a slot); a full queue raises :class:`QueueFullError`
        (HTTP 429)."""
        prompt = [int(t) for t in prompt]
        max_new = (self.engine.default_max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        self.engine.validate(prompt, max_new)
        now = self._clock()
        deadline = (now + float(deadline_ms) / 1e3
                    if deadline_ms is not None and float(deadline_ms) > 0 else None)
        req = GenerationRequest(prompt, max_new, temperature, deadline, now, on_token=on_token,
                                tenant=tenant)
        return self._enqueue(req)

    def _enqueue(self, req):
        """The admission gate every submit shares: refused after close, 429
        when the queue is full, else queued."""
        with self._lock:
            if self._closed:
                raise ServingClosedError("generation scheduler is shut down; no new requests")
            if len(self._q) >= self.queue_capacity:
                self.stats["rejected"] += 1
                self._m["rejected"].inc()
                raise QueueFullError(f"generation queue full ({self.queue_capacity} requests "
                                     "queued); backpressure — retry with backoff")
            self._q.append(req)
            self._m_depth.set(len(self._q))
            self.stats["requests"] += 1
            self._not_empty.notify()
        self._m["requests"].inc()
        return req

    def _handoff_request(self, length, first_token, max_new_tokens, temperature, deadline_ms,
                         on_token, prompt, tenant, handoff):
        """A handed-off request, checked as ``submit`` checks a prompt: the
        slab's scalars by the engine's :meth:`check_handoff` (the length
        inside the window, the first token and a riding prompt inside the
        vocabulary), a budget of at least one token inside the model's
        positions."""
        engine = self.engine
        length, _, prompt = engine.check_handoff(length, first_token, prompt)
        max_new = (engine.default_max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        if max_new < 1:
            raise InvalidArgumentError(f"max_new_tokens must be >= 1, got {max_new}")
        if length + max_new > engine.max_positions:
            raise InvalidArgumentError(f"prompt ({length}) + max_new_tokens ({max_new}) exceeds "
                                       f"max_position_embeddings {engine.max_positions}")
        now = self._clock()
        deadline = (now + float(deadline_ms) / 1e3
                    if deadline_ms is not None and float(deadline_ms) > 0 else None)
        return self._enqueue(GenerationRequest(
            prompt, max_new, temperature, deadline, now, on_token=on_token, tenant=tenant,
            handoff=handoff, prompt_len=length))

    def submit_prefilled(self, planes, length, first_token, max_new_tokens=None,
                         temperature=None, deadline_ms=None, on_token=None, prompt=None,
                         tenant=None) -> GenerationRequest:
        """Enqueue a handed-off generation: the prompt was prefilled on a
        prefill tier and arrives as a slab (window-wide planes, the true
        length, the first sampled token). Admission installs it instead of
        running a prefill; the rest is the normal request path. A
        speculative engine needs ``prompt`` (its draft ring is prefilled at
        admission)."""
        if self.engine.speculative and prompt is None:
            raise InvalidArgumentError("a speculative decode tier needs the prompt tokens with "
                                       "the KV slab (draft ring prefill at admission)")
        length, first_token, _ = self.engine.check_handoff(length, first_token)
        return self._handoff_request(length, first_token, max_new_tokens, temperature,
                                     deadline_ms, on_token, prompt, tenant,
                                     (planes, length, first_token))

    def submit_prefilled_pages(self, slab, max_new_tokens=None, temperature=None,
                               deadline_ms=None, on_token=None, tenant=None,
                               prompt=None) -> GenerationRequest:
        """Enqueue a page-granular handoff (a :class:`PageSlab`): admission
        maps the pages this tier's prefix index holds copy-on-write and
        installs the shipped ones. Needs ``kv_cache_layout=paged``."""
        if not getattr(self.engine, "paged", False):
            raise InvalidArgumentError("page-granular handoff needs kv_cache_layout=paged on "
                                       "the decode tier")
        if not isinstance(slab, PageSlab):
            raise InvalidArgumentError(f"submit_prefilled_pages takes a PageSlab, got "
                                       f"{type(slab).__name__}")
        return self._handoff_request(slab.length, slab.first_token, max_new_tokens, temperature,
                                     deadline_ms, on_token, prompt, tenant, slab)

    def generate(self, prompt, max_new_tokens=None, temperature=None, timeout=None) -> list:
        """Synchronous convenience: submit + wait."""
        return self.submit(prompt, max_new_tokens, temperature).wait(timeout)

    # -- decode loop -------------------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._thread = threading.Thread(target=self._loop, name="ptt-generation-decode",
                                        daemon=True)
        self._thread.start()
        return self

    def _pop_expired_locked(self, now):
        while self._q and self._q[0].expired(now):
            req = self._q.popleft()
            self.stats["expired"] += 1
            self._m["expired"].inc()
            self._m_depth.set(len(self._q))
            req.done(error=DeadlineExceededError(
                f"generation deadline passed after {(now - req.t_submit) * 1e3:.1f}ms in "
                "queue; never admitted to a slot"))

    def _finished_reason(self, req):
        if self.engine.eos_id is not None and req.tokens and req.tokens[-1] == self.engine.eos_id:
            return "eos"
        if len(req.tokens) >= req.max_new_tokens:
            return "length"
        return None

    def _deliver(self, req, tok):
        req.tokens.append(int(tok))
        self._count(tokens=1)
        if req.on_token is not None:
            try:
                req.on_token(int(tok))
            except Exception:  # noqa: BLE001 — a slow or broken stream must not stall decode
                req.on_token = None

    def _complete(self, req, reason):
        req.finish_reason = reason
        self._observe("e2e", (self._clock() - req.t_submit) * 1e3, req.tenant)
        self._count(responses=1)
        req.done()

    def _admit_ready(self):
        """Fill vacant slots from the queue, between decode steps (the
        running batch is never torn down)."""
        engine = self.engine
        while True:
            with self._lock:
                self._pop_expired_locked(self._clock())
                if not self._q:
                    return
                free = next((s for s, r in enumerate(self._slots) if r is None), None)
                if free is None:
                    return
                # paged layout: a vacant slot is not capacity, the page pool
                # is. The head stays queued until finishing slots free pages.
                # With no slot busy nothing will, and every page left is the
                # prefix index's alone: admission evicts what it needs.
                head = self._q[0]
                if self.live_slots and not engine.has_capacity(
                        head.prompt if head.handoff is None else head.prompt_len):
                    return
                req = self._q.popleft()
                self._m_depth.set(len(self._q))
            midbatch = self.live_slots > 0
            try:
                if isinstance(req.handoff, PageSlab):
                    slab = req.handoff
                    tok = engine.admit_prefilled_pages(free, slab.pages, slab.length,
                                                       slab.first_token,
                                                       page_size=slab.page_size,
                                                       tenant=req.tenant)
                elif req.handoff is not None:
                    planes, length, first = req.handoff
                    tok = engine.admit_prefilled(free, planes, length, first, prompt=req.prompt)
                else:
                    tok = engine.admit(free, req.prompt, req.temperature, tenant=req.tenant)
            except Exception as e:  # noqa: BLE001 — the loop must survive
                engine.release_slot(free)  # pages a failed prefill may hold
                self._count(errors=1)
                req.done(error=e)
                continue
            with self._lock:
                if self._closed and not self._drain:
                    # stop(drain=False) landed between the queue pop and the
                    # slot install: the request was promised a failure
                    self.stats["errors"] += 1
                    self._m["errors"].inc()
                    engine.release_slot(free)
                    req.done(error=ServingClosedError(
                        "generation scheduler shut down before the request reached a "
                        "decode slot"))
                    continue
            req.t_first_token = self._clock()
            self._observe("ttft", (req.t_first_token - req.t_submit) * 1e3, req.tenant)
            if midbatch:
                self._count(midbatch_admissions=1)
            self._deliver(req, tok)
            reason = self._finished_reason(req)
            if reason is not None:
                engine.release_slot(free)
                self._complete(req, reason)
                continue
            self._slots[free] = req
            self._m_busy.set(self.live_slots)
            self._last[free] = tok
            self._temps[free] = (engine.default_temperature if req.temperature is None
                                 else float(req.temperature))

    def _loop(self):
        engine = self.engine
        while True:
            self._admit_ready()
            busy = [s for s, r in enumerate(self._slots) if r is not None]
            if not busy:
                with self._lock:
                    if self._closed and not self._q:
                        break
                    if not self._q:
                        self._not_empty.wait(0.05)
                continue
            t0 = self._clock()
            try:
                if engine.speculative:
                    # one draft/verify round: slot s emits ts[s, :counts[s]]
                    ts, counts = engine.spec_step(self._last, self._temps, busy=busy)
                else:
                    nxt = engine.step(self._last, self._temps)
                    ts, counts = nxt[:, None], np.ones(len(nxt), np.int32)
            except Exception as e:  # noqa: BLE001 — fail THESE, keep serving
                for s in busy:
                    req, self._slots[s] = self._slots[s], None
                    engine.release_slot(s)
                    self._count(errors=1)
                    req.done(error=e)
                continue
            dt_ms = (self._clock() - t0) * 1e3
            if self._watch.armed:
                self._watch.note(slots=len(busy))
            emitted = 0
            for s in busy:
                req = self._slots[s]
                if req is None or req.finished:  # stop(drain=False) race
                    self._slots[s] = None
                    engine.release_slot(s)
                    continue
                reason = None
                for tok in ts[s, :counts[s]]:
                    self._deliver(req, tok)
                    self._last[s] = tok
                    emitted += 1
                    reason = self._finished_reason(req)
                    if reason is not None:
                        break
                if reason is not None:
                    self._slots[s] = None
                    engine.release_slot(s)
                    self._complete(req, reason)
            # what a stream waits between tokens: the step's time, or a
            # round's spread over the tokens each busy stream emitted
            self._observe("token", dt_ms * len(busy) / emitted
                          if engine.speculative and emitted else dt_ms)
            self._m_busy.set(self.live_slots)
        self._m_busy.set(self.live_slots)

    # -- lifecycle ---------------------------------------------------------------

    def close(self, drain=True):
        """Refuse new requests. ``drain=True`` lets the decode loop finish
        everything queued and active; ``drain=False`` fails queued requests
        now (active ones are failed by :meth:`stop`)."""
        with self._lock:
            if self._closed and not self._q:
                return
            self._closed = True
            self._drain = drain
            dropped = []
            if not drain:
                dropped = list(self._q)
                self._q.clear()
                self._m_depth.set(0)
            self._not_empty.notify_all()
        for req in dropped:
            self._count(errors=1)
            req.done(error=ServingClosedError("generation scheduler shut down before admission"))

    def stop(self, drain=True, timeout=30.0):
        """Close and join the decode loop. With ``drain=False`` active
        sequences are failed instead of run to completion."""
        self.close(drain=drain)
        if not drain:
            self._fail_pending("generation scheduler shut down mid-sequence")
        t = self._thread
        if t is not None:
            t.join(timeout)
        if t is None or not t.is_alive():
            # no live loop to drain them: waiters get an error, not a hang
            self._thread = None
            self._fail_pending("generation scheduler stopped with no decode loop to drain the "
                               "request")

    def _fail_pending(self, why):
        with self._lock:
            dropped = list(self._q)
            self._q.clear()
        self._m_depth.set(0)
        for s, req in enumerate(self._slots):
            if req is not None:
                self._slots[s] = None
                self.engine.release_slot(s)
                if not req.finished:
                    dropped.append(req)
        self._m_busy.set(0)
        for req in dropped:
            if not req.finished:
                self._count(errors=1)
                req.done(error=ServingClosedError(why))

    @property
    def alive(self) -> int:
        t = self._thread
        return int(t is not None and t.is_alive())
