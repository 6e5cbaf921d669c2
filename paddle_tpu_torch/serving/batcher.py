"""Dynamic batching for online inference (``paddle_tpu/serving/batcher.py``).

- ``submit()`` validates a request and appends it to a BOUNDED queue; a
  full queue raises :class:`QueueFullError` (HTTP 429) instead of growing.
- Replica workers call ``next_batch()``: it blocks for the first live
  request, gathers more until the largest bucket fills or the assembly
  window (``FLAGS_serving_batch_timeout_ms``) closes, completes requests
  whose deadline passed with :class:`DeadlineExceededError` without
  dispatching them, concatenates the rest along the batch axis and pads
  with zero rows up to the smallest covering bucket of
  ``FLAGS_serving_batch_buckets``.
- ``complete()`` slices the padded outputs back per request; padding rows
  are computed and dropped.

On the card the bucket ladder bounds the batch shapes the kernels see.
The counters in :attr:`DynamicBatcher.stats` feed ``/statz``; the JAX
package's registry metrics (``serving/queue_ms``, ``assemble_ms`` and
``e2e_ms``, labeled by kind, bucket and tenant, and the ``serving/*_total``
counters) feed ``/loadz``, ``/histz`` and ``/metrics``.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from ..errors import (
    ExecutionTimeoutError,
    InvalidArgumentError,
    ResourceExhaustedError,
    UnavailableError,
)
from ..flags import flag
from ..monitor import counter, gauge, histogram
from ..monitor import flight_recorder as _flight
from ..monitor import tracing as _tracing

__all__ = ["DynamicBatcher", "QueueFullError", "DeadlineExceededError",
           "ServingClosedError", "parse_buckets"]


class QueueFullError(ResourceExhaustedError):
    """The bounded admission queue is full: back off and retry (429)."""


class DeadlineExceededError(ExecutionTimeoutError):
    """The request's deadline passed while it waited; never dispatched."""


class ServingClosedError(UnavailableError):
    """The batcher is shut down (or draining) and accepts no new work."""


def parse_buckets(spec) -> tuple:
    """A bucket ladder ("1,2,4,8" or an int sequence) as a strictly
    ascending tuple of positive batch sizes."""
    if isinstance(spec, str):
        try:
            vals = tuple(int(p) for p in spec.split(",") if p.strip())
        except ValueError:
            raise InvalidArgumentError(
                f"serving_batch_buckets {spec!r} is not a comma-separated int list") from None
    else:
        vals = tuple(int(v) for v in spec)
    if not vals or any(v <= 0 for v in vals) or list(vals) != sorted(set(vals)):
        raise InvalidArgumentError(
            f"serving batch buckets must be strictly ascending positive ints, got {vals!r}")
    return vals


class _Request:
    """One submitted prediction and the event its submitter waits on."""

    __slots__ = ("inputs", "rows", "deadline", "t_submit", "tenant", "result", "error",
                 "trace", "_done")

    def __init__(self, inputs, rows, deadline, t_submit, tenant="default"):
        self.inputs = inputs
        self.rows = rows
        self.deadline = deadline  # absolute monotonic seconds, or None
        self.t_submit = t_submit
        self.tenant = tenant  # a label of the stage histograms
        self.result = None
        self.error = None
        # the submitter's trace context (the handler's request span): the
        # queue-wait, assemble and dispatch spans worker threads record
        # hang under it
        self.trace = _tracing.current_context()
        self._done = threading.Event()

    def expired(self, now) -> bool:
        return self.deadline is not None and now > self.deadline

    def done(self, result=None, error=None):
        self.result = result
        self.error = error
        self._done.set()

    def wait(self, timeout=None):
        """The per-fetch outputs (this request's rows), or the stored error raised."""
        if not self._done.wait(timeout):
            raise ExecutionTimeoutError(f"serving request not completed within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class _Batch:
    """An assembled, padded batch ready for one replica dispatch."""

    __slots__ = ("requests", "bucket", "rows", "feed", "t_ready")

    def __init__(self, requests, bucket, rows, feed, t_ready):
        self.requests = requests
        self.bucket = bucket  # padded batch-axis size (a ladder entry)
        self.rows = rows      # real rows (sum over requests)
        self.feed = feed      # name -> padded (bucket, *feature) array
        self.t_ready = t_ready  # monotonic seconds when assembled


class DynamicBatcher:
    """Bounded-queue dynamic batcher over a fixed set of feed names.

    ``input_specs`` (``{feed: (feature_shape, dtype)}``, set by the replica
    pool from the predictor) makes ``submit()`` reject a request whose
    feature shape does not fit, so a bad request never fails the batch it
    would have joined.
    """

    def __init__(self, feed_names, buckets=None, queue_capacity=None, batch_timeout_ms=None):
        self.feed_names = list(feed_names)
        self.input_specs = None
        self.buckets = parse_buckets(buckets if buckets is not None
                                     else flag("serving_batch_buckets"))
        self.queue_capacity = int(queue_capacity if queue_capacity is not None
                                  else flag("serving_queue_capacity"))
        if self.queue_capacity <= 0:
            raise InvalidArgumentError(
                f"serving queue capacity must be positive, got {self.queue_capacity}")
        self._batch_timeout_ms = batch_timeout_ms
        self._q = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._paused = False
        #: counters read by /statz (written under the lock)
        self.stats = {"requests": 0, "rejected": 0, "expired": 0, "responses": 0,
                      "errors": 0, "batches": 0, "rows": 0, "slots": 0, "last_fill": 0.0}
        # the process registry's series (JAX names): /loadz, /histz, /metrics
        self._m_depth = gauge("serving/queue_depth")
        self._m_fill = gauge("serving/batch_fill")
        self._m_requests = counter("serving/requests_total")
        self._m_rejected = counter("serving/rejected_total")
        self._m_expired = counter("serving/deadline_expired_total")
        self._m_responses = counter("serving/responses_total")
        self._m_errors = counter("serving/errors_total")
        self._m_batches = counter("serving/batches_total")
        self._m_rows = counter("serving/batched_rows_total")
        self._m_slots = counter("serving/batch_slots_total")
        self._m_pad = counter("serving/padded_rows_total")
        self._h_queue = histogram("serving/queue_ms")
        self._h_assemble = histogram("serving/assemble_ms")
        self._h_e2e = histogram("serving/e2e_ms")

    def _count(self, **inc):
        with self._lock:
            for k, v in inc.items():
                self.stats[k] += v
        if "errors" in inc:
            self._m_errors.inc(inc["errors"])
        if "responses" in inc:
            self._m_responses.inc(inc["responses"])

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    @property
    def closed(self) -> bool:
        return self._closed

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._q)

    def _batch_window_s(self) -> float:
        ms = self._batch_timeout_ms
        if ms is None:
            ms = flag("serving_batch_timeout_ms")
        return max(0.0, float(ms)) / 1e3

    def _validate(self, inputs) -> int:
        if set(inputs) != set(self.feed_names):
            raise InvalidArgumentError(
                f"serving request inputs {sorted(inputs)} != model feeds "
                f"{sorted(self.feed_names)}")
        rows = None
        for n in self.feed_names:
            a = inputs[n]
            if a.ndim < 1:
                raise InvalidArgumentError(
                    f"serving input {n!r} needs a leading batch axis, got a scalar")
            spec = self.input_specs.get(n) if self.input_specs else None
            if spec is not None and tuple(a.shape[1:]) != tuple(spec[0]):
                raise InvalidArgumentError(
                    f"serving input {n!r} has feature shape {tuple(a.shape[1:])}, "
                    f"model expects {tuple(spec[0])}")
            if rows is None:
                rows = int(a.shape[0])
            elif int(a.shape[0]) != rows:
                raise InvalidArgumentError(
                    f"serving input {n!r} has {a.shape[0]} rows, other inputs have {rows}")
        if rows == 0:
            raise InvalidArgumentError("serving request has zero rows")
        if rows > self.max_batch:
            raise InvalidArgumentError(
                f"serving request has {rows} rows > largest batch bucket {self.max_batch}; "
                "split the request or raise FLAGS_serving_batch_buckets")
        return rows

    # -- client side ---------------------------------------------------------

    def submit(self, inputs, deadline_ms=None, tenant=None) -> _Request:
        """Enqueue one request (feed name -> array with a leading batch
        axis) and return its handle; ``wait()`` on it. Raises
        :class:`QueueFullError` on a full queue and
        :class:`ServingClosedError` after ``close()``. ``tenant`` labels the
        request's series of the stage histograms ("default" when unset)."""
        inputs = {n: np.asarray(v) for n, v in inputs.items()}
        rows = self._validate(inputs)
        if deadline_ms is None:
            d = float(flag("serving_default_deadline_ms"))
            deadline_ms = d if d > 0 else None
        now = time.monotonic()
        deadline = now + float(deadline_ms) / 1e3 if deadline_ms is not None else None
        req = _Request(inputs, rows, deadline, now,
                       tenant="default" if tenant is None else str(tenant))
        with self._lock:
            if self._closed:
                raise ServingClosedError("serving batcher is shut down; no new requests")
            if len(self._q) >= self.queue_capacity:
                self.stats["rejected"] += 1
                self._m_rejected.inc()
                raise QueueFullError(
                    f"serving queue full ({self.queue_capacity} requests queued); "
                    "backpressure — retry with backoff")
            self._q.append(req)
            self._m_depth.set(len(self._q))
            self.stats["requests"] += 1
            self._not_empty.notify()
        self._m_requests.inc()
        return req

    # -- worker side ---------------------------------------------------------

    def _pop_expired_locked(self, now):
        """Complete queue-front requests whose deadline passed. Lock held."""
        while self._q and self._q[0].expired(now):
            req = self._q.popleft()
            self.stats["expired"] += 1
            self._m_expired.inc()
            self._m_depth.set(len(self._q))
            _flight.record_event("serving_deadline_expired", rows=req.rows,
                                 queued_ms=round((now - req.t_submit) * 1e3, 3))
            # a deadline miss is a trace the tail sampler always keeps
            _tracing.record_interval("serving::queue_wait", req.trace, req.t_submit, now,
                                     error="deadline exceeded in queue", rows=req.rows)
            _tracing.flag_trace(req.trace, "deadline")
            req.done(error=DeadlineExceededError(
                f"request deadline passed after {(now - req.t_submit) * 1e3:.1f}ms in queue; "
                "never dispatched"))

    def next_batch(self, timeout=None):
        """Assemble the next batch: wait up to ``timeout`` seconds (``None``:
        until a request arrives or the batcher closes) for a first live
        request, then hold the batch open for the assembly window. Returns
        a :class:`_Batch`, or ``None`` on timeout or when closed and drained."""
        with self._not_empty:
            first = None
            wait_until = time.monotonic() + timeout if timeout is not None else None
            while first is None:
                now = time.monotonic()
                if not self._paused:
                    self._pop_expired_locked(now)
                    if self._q:
                        first = self._q.popleft()
                        self._m_depth.set(len(self._q))
                        break
                    if self._closed:
                        return None  # closed and fully drained
                elif self._closed and not self._q:
                    return None
                if wait_until is not None:
                    remaining = wait_until - now
                    if remaining <= 0:
                        return None
                    self._not_empty.wait(remaining)
                else:
                    self._not_empty.wait()

            t_first = time.monotonic()
            picked = [first]
            rows = first.rows
            window_end = time.monotonic() + self._batch_window_s()
            while rows < self.max_batch:
                now = time.monotonic()
                self._pop_expired_locked(now)
                if self._q:
                    nxt = self._q[0]
                    if rows + nxt.rows > self.max_batch:
                        break  # the next request would not fit: dispatch now
                    self._q.popleft()
                    self._m_depth.set(len(self._q))
                    picked.append(nxt)
                    rows += nxt.rows
                    continue
                if self._closed:
                    break  # draining: flush without waiting the window
                remaining = window_end - now
                if remaining <= 0:
                    break
                self._not_empty.wait(remaining)

        # concatenation and padding outside the lock; a failure here fails
        # these requests and keeps the worker alive
        try:
            return self._assemble(picked, rows, t_first)
        except Exception as e:  # noqa: BLE001 — workers must survive
            for req in picked:
                req.done(error=e)
            self._count(errors=len(picked))
            return None

    def _assemble(self, picked, rows, t_first):
        now = time.monotonic()
        bucket = next(b for b in self.buckets if b >= rows)
        for req in picked:
            # the labeled child propagates into the bare family, so /histz
            # keeps exact totals
            self._h_queue.labels(kind="predict", bucket=str(bucket), tenant=req.tenant).observe(
                (now - req.t_submit) * 1e3)
            _tracing.record_interval("serving::queue_wait", req.trace, req.t_submit, now,
                                     rows=req.rows)
        asp = _tracing.begin_span("serving::assemble")
        feed = {}
        for n in self.feed_names:
            arr = (picked[0].inputs[n] if len(picked) == 1
                   else np.concatenate([r.inputs[n] for r in picked]))
            if bucket > rows:
                pad = np.zeros((bucket - rows,) + arr.shape[1:], arr.dtype)
                arr = np.concatenate([arr, pad])
            feed[n] = arr
        with self._lock:
            self.stats["batches"] += 1
            self.stats["rows"] += rows
            self.stats["slots"] += bucket
            self.stats["last_fill"] = rows / bucket
        t_ready = time.monotonic()
        # one assembly serves every member: the span lands in each trace
        asp.set_attributes(bucket=bucket, rows=rows, requests=len(picked),
                           fill=round(rows / bucket, 4), padded_rows=bucket - rows)
        _tracing.record_fanin(asp, [r.trace for r in picked])
        self._h_assemble.observe((t_ready - t_first) * 1e3)
        self._m_batches.inc()
        self._m_rows.inc(rows)
        self._m_slots.inc(bucket)
        self._m_pad.inc(bucket - rows)
        self._m_fill.set(rows / bucket)
        return _Batch(picked, bucket, rows, feed, t_ready)

    def complete(self, batch, outputs):
        """Slice the padded per-fetch ``outputs`` back per request and
        complete each one; padding rows are dropped here."""
        now = time.monotonic()
        outs = [np.asarray(o) for o in outputs]
        offset = 0
        for req in batch.requests:
            req.done(result=[o[offset:offset + req.rows] for o in outs])
            offset += req.rows
            self._h_e2e.labels(kind="predict", bucket=str(batch.bucket),
                               tenant=req.tenant).observe((now - req.t_submit) * 1e3)
        self._count(responses=len(batch.requests))

    def fail(self, batch, error):
        """Complete every request of a failed dispatch with ``error``."""
        for req in batch.requests:
            _tracing.flag_trace(req.trace, "error")
            req.done(error=error)
        self._count(errors=len(batch.requests))

    # -- lifecycle -----------------------------------------------------------

    def pause(self):
        """Stop handing out batches (requests keep queueing, so the bounded
        queue pushes back); holds even for workers already waiting in
        ``next_batch``."""
        with self._lock:
            self._paused = True

    def resume(self):
        with self._lock:
            self._paused = False
            self._not_empty.notify_all()

    def close(self, drain=True):
        """Stop accepting requests. ``drain=True`` leaves queued work for the
        workers to flush; ``drain=False`` fails it with
        :class:`ServingClosedError`."""
        with self._lock:
            if self._closed and not self._q:
                return
            self._closed = True
            self._paused = False  # a paused batcher must still drain
            dropped = [] if drain else list(self._q)
            if not drain:
                self._q.clear()
                self._m_depth.set(0)
            self._not_empty.notify_all()
        for req in dropped:
            req.done(error=ServingClosedError("serving batcher shut down before dispatch"))
        self._count(errors=len(dropped))
