"""Continuous batching: slot-turnover scheduling over a GenerationEngine (``paddle_tpu/serving/continuous.py:51-631``).

The decode graph always runs all ``engine.slots`` rows; a sequence that hits
EOS or its token budget vacates its slot mid-batch, and the next queued
request is admitted into it at the next step (a prefill replay that
installs the slot in place: nothing is captured anew). Admission follows the
serving queue's contracts: a bounded queue (:class:`QueueFullError`, HTTP
429), deadlines that expire queued requests without dispatch,
:class:`ServingClosedError` after close, and drain. Growth of the engine's
captures after warmup is noted through ``engine.watch``. Pass ``on_token``
to :meth:`ContinuousBatcher.submit` to have every token delivered as it is
decoded (``/generate``'s streaming mode).

The counters of :attr:`ContinuousBatcher.stats` and the latency samples of
:meth:`ContinuousBatcher.quantiles` feed ``/statz``; the JAX package's
monitor registry, tracing spans and flight recorder are not ported (ROADMAP
Queue A item 10), nor the handoff admissions (``submit_prefilled*``, which
raise).
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from ..errors import ExecutionTimeoutError, InvalidArgumentError, UnimplementedError
from ..flags import flag
from .batcher import DeadlineExceededError, QueueFullError, ServingClosedError

__all__ = ["ContinuousBatcher", "GenerationRequest"]

_HANDOFF = "the disaggregated prefill/decode handoff (ROADMAP.md Queue A item 3, entry 4)"

# latency samples kept per series for /statz quantiles
_SAMPLES = 4096


class GenerationRequest:
    """One submitted generation: the token prompt, its budget and sampling
    override, the tokens produced so far and a completion event."""

    __slots__ = ("prompt", "prompt_len", "max_new_tokens", "temperature", "deadline", "t_submit",
                 "t_first_token", "tokens", "finish_reason", "on_token", "error", "tenant",
                 "_done")

    def __init__(self, prompt, max_new_tokens, temperature, deadline, t_submit, on_token=None,
                 tenant=None):
        self.prompt = prompt
        self.prompt_len = len(prompt)
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

    def _count(self, **inc):
        with self._lock:
            for k, v in inc.items():
                self.stats[k] += v

    def _observe(self, name, ms):
        with self._lock:
            self._latency[name].append(ms)

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
        with self._lock:
            if self._closed:
                raise ServingClosedError("generation scheduler is shut down; no new requests")
            if len(self._q) >= self.queue_capacity:
                self.stats["rejected"] += 1
                raise QueueFullError(f"generation queue full ({self.queue_capacity} requests "
                                     "queued); backpressure — retry with backoff")
            self._q.append(req)
            self.stats["requests"] += 1
            self._not_empty.notify()
        return req

    def submit_prefilled(self, *args, **kwargs):
        raise UnimplementedError(f"submit_prefilled: {_HANDOFF} is not ported yet")

    def submit_prefilled_pages(self, *args, **kwargs):
        raise UnimplementedError(f"submit_prefilled_pages: {_HANDOFF} is not ported yet")

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
        self._observe("e2e", (self._clock() - req.t_submit) * 1e3)
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
                if free is None or not engine.has_capacity(self._q[0].prompt):
                    return
                req = self._q.popleft()
            midbatch = self.live_slots > 0
            try:
                tok = engine.admit(free, req.prompt, req.temperature, tenant=req.tenant)
            except Exception as e:  # noqa: BLE001 — the loop must survive
                self._count(errors=1)
                req.done(error=e)
                continue
            with self._lock:
                if self._closed and not self._drain:
                    # stop(drain=False) landed between the queue pop and the
                    # slot install: the request was promised a failure
                    self.stats["errors"] += 1
                    req.done(error=ServingClosedError(
                        "generation scheduler shut down before the request reached a "
                        "decode slot"))
                    continue
            req.t_first_token = self._clock()
            self._observe("ttft", (req.t_first_token - req.t_submit) * 1e3)
            if midbatch:
                self._count(midbatch_admissions=1)
            self._deliver(req, tok)
            reason = self._finished_reason(req)
            if reason is not None:
                engine.release_slot(free)
                self._complete(req, reason)
                continue
            self._slots[free] = req
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
                nxt = engine.step(self._last, self._temps)
            except Exception as e:  # noqa: BLE001 — fail THESE, keep serving
                for s in busy:
                    req, self._slots[s] = self._slots[s], None
                    engine.release_slot(s)
                    self._count(errors=1)
                    req.done(error=e)
                continue
            self._observe("token", (self._clock() - t0) * 1e3)
            if self._watch.armed:
                self._watch.note(slots=len(busy))
            for s in busy:
                req = self._slots[s]
                if req is None or req.finished:  # stop(drain=False) race
                    self._slots[s] = None
                    engine.release_slot(s)
                    continue
                self._deliver(req, nxt[s])
                self._last[s] = nxt[s]
                reason = self._finished_reason(req)
                if reason is not None:
                    self._slots[s] = None
                    engine.release_slot(s)
                    self._complete(req, reason)

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
        for s, req in enumerate(self._slots):
            if req is not None:
                self._slots[s] = None
                self.engine.release_slot(s)
                if not req.finished:
                    dropped.append(req)
        for req in dropped:
            if not req.finished:
                self._count(errors=1)
                req.done(error=ServingClosedError(why))

    @property
    def alive(self) -> int:
        t = self._thread
        return int(t is not None and t.is_alive())
