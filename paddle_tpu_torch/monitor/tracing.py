"""Distributed request tracing: one identity through the whole stack
(``paddle_tpu/monitor/tracing.py``, the port's own copy: pure Python, the
same spans, wire format, sampling and payloads).

The serving and training telemetry built so far is *aggregate* —
``/statz`` quantiles, ``/loadz`` queue depth, merged histograms — and
aggregates cannot answer "why was THIS request slow?". A p99 outlier is
queue wait, or bucket padding, or an unexpected graph capture, or a router
retry; telling them apart needs a per-request span tree that survives
the router -> backend process hop. This module provides exactly that,
kept deliberately small and always-on-cheap:

- **Trace context** — a contextvar-held current span carrying
  ``(trace_id, span_id)``. Spans nest under it; code that runs outside
  any trace (offline tests, warmup) pays one contextvar read and
  records nothing.
- **Spans** — structured ``{name, trace_id, span_id, parent_id, t,
  dur_ms, attrs, links, error}`` dicts. Hot-path annotation
  (:func:`annotate`) mutates the *current* span so deep layers (the
  executor's plan/jit cache disposition, the cost model's FLOPs) tag
  the request without threading a handle through every signature.
- **W3C-style propagation** — ``traceparent: 00-<trace>-<span>-01``
  headers (:func:`format_traceparent` / :func:`parse_traceparent`).
  The router injects per-attempt headers; ``_BaseHandler`` extracts
  them, so the backend's span tree hangs under the router's attempt
  span: one trace_id, correct parentage, two processes.
- **Tail-sampled trace store** — traces are always *recorded*; only at
  completion does the store decide what to *retain*: every trace that
  erred, missed a deadline, or was retried is kept, plus the slowest-K
  per window (``FLAGS_trace_sample_slowest_k`` /
  ``FLAGS_trace_sample_window_s``); the fast-path bulk is dropped.
  Retention is bounded by ``FLAGS_trace_store_capacity``. This is
  tail-based sampling: the decision happens when the outcome is known,
  so the interesting traces are never the ones sampled away.

Served on ``/tracez`` (debug server and every serving frontend): the
retained list, one trace's span tree by ``?id=``, and a per-trace
chrome-trace view via ``?format=chrome``. ``monitor.export``'s merged
chrome trace embeds the retained traces alongside the host spans.
"""
from __future__ import annotations

import contextvars
import os
import random
import threading
import time
from collections import OrderedDict

from ..flags import flag

__all__ = [
    "TRACEPARENT_HEADER", "SpanContext", "Span", "TraceStore",
    "format_traceparent", "parse_traceparent", "new_trace_id",
    "new_span_id", "enabled", "current_span", "current_context",
    "annotate", "note_status", "start_trace", "start_span", "begin_span",
    "use_span", "record_interval", "record_fanin", "flag_trace",
    "flag_current_trace", "store", "reset_store", "tracez_payload",
    "chrome_events", "parse_query",
]

#: The propagation header (W3C trace-context wire name).
TRACEPARENT_HEADER = "traceparent"

# spans per trace are bounded: a runaway loop inside one request must
# not let a single trace eat the store (generation traces record per
# REQUEST, not per token, so real traces sit far below this)
_MAX_SPANS_PER_TRACE = 512

# stage names the /statz slowest table decomposes a trace into
_STAGE_NAMES = frozenset((
    "queue_wait", "assemble", "dispatch", "slot_admission", "decode",
    "attempt", "run",
))


def enabled() -> bool:
    try:
        return bool(flag("trace_enabled"))
    except Exception:  # flags not bootstrapped yet
        return True


# id generation is on the per-span hot path (bench.py tracing_overhead):
# a per-thread PRNG seeded once from os.urandom replaces a urandom
# syscall per id with ~0.5µs of Mersenne twister — span ids need
# uniqueness, not crypto strength
_ids = threading.local()


def _rng() -> random.Random:
    rng = getattr(_ids, "rng", None)
    if rng is None:
        rng = _ids.rng = random.Random(
            int.from_bytes(os.urandom(16), "big") ^ (os.getpid() << 64))
    return rng


def new_trace_id() -> str:
    """32-hex trace id (all-zero is invalid on the wire, hence ``| 1``)."""
    return f"{_rng().getrandbits(128) | 1:032x}"


def new_span_id() -> str:
    """16-hex span id."""
    return f"{_rng().getrandbits(64) | 1:016x}"


class SpanContext:
    """Immutable (trace_id, span_id) pair — the thing that crosses
    process boundaries and the thing a request handle stores."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id, span_id):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id[:8]}…, {self.span_id})"


def format_traceparent(ctx: SpanContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


_HEX_DIGITS = frozenset("0123456789abcdefABCDEF")


def _is_hex(s: str) -> bool:
    # strict charset check: int(s, 16) would also accept '0x' prefixes,
    # leading '+', and interior underscores — all W3C-malformed
    return all(c in _HEX_DIGITS for c in s)


def parse_traceparent(header) -> SpanContext | None:
    """Parse a ``traceparent`` header; ``None`` on anything malformed
    (a garbage header from an arbitrary client must never 500 the
    request — it just starts a fresh trace)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if (len(version) != 2 or not _is_hex(version)
            or version.lower() == "ff"):
        return None
    if len(_flags) != 2 or not _is_hex(_flags):
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id) \
            or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not _is_hex(span_id) \
            or span_id == "0" * 16:
        return None
    return SpanContext(trace_id.lower(), span_id.lower())


class Span:
    """One timed, attributed operation. ``trace_id`` may be ``None``
    for a *detached* span (:func:`begin_span`): it is timed and
    annotatable but only enters the store through
    :func:`record_fanin`, which rebinds it into member traces."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "links", "error", "root", "t_epoch", "_t0",
                 "duration_ms")

    def __init__(self, name, trace_id=None, parent_id=None, root=False,
                 attrs=None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self.links = None
        self.error = None
        self.root = bool(root)
        self.t_epoch = time.time()
        self._t0 = time.monotonic()
        self.duration_ms = None

    def __bool__(self):
        return True

    @property
    def context(self) -> SpanContext | None:
        if self.trace_id is None:
            return None
        return SpanContext(self.trace_id, self.span_id)

    def set_attribute(self, key, value):
        if value is not None:
            self.attrs[key] = value
        return self

    def set_attributes(self, **attrs):
        for k, v in attrs.items():
            if v is not None:
                self.attrs[k] = v
        return self

    def set_error(self, message):
        self.error = str(message)[:300]
        return self

    def end(self):
        if self.duration_ms is None:
            self.duration_ms = (time.monotonic() - self._t0) * 1e3
        return self

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t": self.t_epoch,
            "dur_ms": round(self.duration_ms or 0.0, 3),
            "attrs": dict(self.attrs),
        }
        if self.links:
            d["links"] = list(self.links)
        if self.error is not None:
            d["error"] = self.error
        if self.root:
            d["root"] = True
        return d


class _NullSpan:
    """The disabled/ambient-less span: every method is a no-op, truth
    value is False so callers can gate optional work on ``if span:``."""

    __slots__ = ()

    def __bool__(self):
        return False

    @property
    def context(self):
        return None

    trace_id = None
    span_id = None
    attrs = {}

    def set_attribute(self, key, value):
        return self

    def set_attributes(self, **attrs):
        return self

    def set_error(self, message):
        return self

    def end(self):
        return self


NULL_SPAN = _NullSpan()

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "ptpu_trace_span", default=None)


def current_span():
    """The active span of this execution context (or None)."""
    return _CURRENT.get()


def current_context() -> SpanContext | None:
    """The active span's (trace_id, span_id) — None when no *bound*
    span is current (detached dispatch spans have no trace yet)."""
    sp = _CURRENT.get()
    if sp is None or sp.trace_id is None:
        return None
    return sp.context


def annotate(**attrs):
    """Set attributes on the current span, wherever the caller sits in
    the stack; no-op without one. This is how the executor tags the
    serving dispatch span with its cache disposition and FLOPs without
    the batcher threading a span handle down to it."""
    sp = _CURRENT.get()
    if sp is not None:
        sp.set_attributes(**attrs)


def note_status(status):
    """Record an HTTP status on the current span; >= 500 marks the span
    (and therefore the trace) errored — the tail sampler keeps it."""
    sp = _CURRENT.get()
    if sp is None or sp.trace_id is None:
        return
    sp.set_attribute("status", int(status))
    if int(status) >= 500:
        sp.set_error(f"http {int(status)}")


class _SpanScope:
    """Context manager binding a span as current; records it into the
    store on exit (and, for local roots, finalizes the trace —
    triggering the tail-sampling retention decision)."""

    __slots__ = ("span", "_token", "_finish")

    def __init__(self, span, finish=False):
        self.span = span
        self._finish = finish
        self._token = None

    def __enter__(self):
        if self.span is not NULL_SPAN:
            self._token = _CURRENT.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        if self.span is NULL_SPAN:
            return False
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        sp = self.span.end()
        if exc is not None and sp.error is None:
            sp.set_error(f"{exc_type.__name__}: {exc}")
        st = store()
        st.add_span(sp)
        if self._finish:
            st.finish(sp)
        return False


def start_trace(name, parent=None, **attrs) -> _SpanScope:
    """Open a trace-root span (a LOCAL root: ``parent`` may be a remote
    :class:`SpanContext` from an extracted ``traceparent``, in which
    case this process's tree hangs under the remote span but the trace
    id is preserved). Exiting the scope finalizes the trace and runs
    the retention decision."""
    if not enabled():
        return _SpanScope(NULL_SPAN)
    if isinstance(parent, Span):
        parent = parent.context
    trace_id = parent.trace_id if parent is not None else new_trace_id()
    span = Span(name, trace_id,
                parent.span_id if parent is not None else None,
                root=True, attrs=attrs)
    return _SpanScope(span, finish=True)


def _resolve_parent(parent) -> SpanContext | None:
    if parent is None:
        sp = _CURRENT.get()
        if sp is None or sp.trace_id is None:
            return None
        return sp.context
    if isinstance(parent, Span):
        return parent.context
    return parent if parent.trace_id else None


def start_span(name, parent=None, **attrs) -> _SpanScope:
    """Open a child span under ``parent`` (default: the current span).
    With no trace to attach to this is a no-op scope — ambient
    instrumentation stays free outside requests."""
    if not enabled():
        return _SpanScope(NULL_SPAN)
    ctx = _resolve_parent(parent)
    if ctx is None:
        return _SpanScope(NULL_SPAN)
    span = Span(name, ctx.trace_id, ctx.span_id, attrs=attrs)
    return _SpanScope(span)


def begin_span(name, **attrs):
    """A detached (trace-unbound) span: timed and annotatable now,
    bound into member traces later via :func:`record_fanin` — the shape
    of a batch dispatch, which serves N traces at once."""
    if not enabled():
        return NULL_SPAN
    return Span(name, attrs=attrs)


class use_span:
    """Make ``span`` current for a block WITHOUT recording it on exit
    (pair with :func:`begin_span` + :func:`record_fanin`)."""

    __slots__ = ("_span", "_token")

    def __init__(self, span):
        self._span = span
        self._token = None

    def __enter__(self):
        if self._span is not NULL_SPAN:
            self._token = _CURRENT.set(self._span)
        return self._span

    def __exit__(self, *exc):
        if self._token is not None:
            _CURRENT.reset(self._token)
        return False


def record_fanin(span, members, **extra_attrs) -> int:
    """Record one (ended) span into EVERY member trace: the batch-
    dispatch fan-in. Each copy shares the span's id, is parented under
    that member's own context, and carries ``links`` naming every
    member exactly once — so any one trace shows both its own path and
    the co-batch it rode in."""
    if span is NULL_SPAN or not enabled():
        return 0
    members = [m for m in members if m is not None and m.trace_id]
    seen, uniq = set(), []
    for m in members:
        key = (m.trace_id, m.span_id)
        if key not in seen:
            seen.add(key)
            uniq.append(m)
    if not uniq:
        return 0
    span.end()
    if extra_attrs:
        span.set_attributes(**extra_attrs)
    links = [{"trace_id": m.trace_id, "span_id": m.span_id}
             for m in uniq]
    base = span.to_dict()
    base["links"] = links
    st = store()
    for m in uniq:
        d = dict(base)
        d["trace_id"] = m.trace_id
        d["parent_id"] = m.span_id
        st.add_span_dict(d)
    return len(uniq)


def record_interval(name, parent, t0, t1=None, error=None, **attrs):
    """Record a completed span retroactively from monotonic timestamps
    — queue-wait is only knowable when the request is picked, long
    after it began. ``parent`` is the request's stored context."""
    if not enabled():
        return None
    ctx = _resolve_parent(parent)
    if ctx is None:
        return None
    now = time.monotonic()
    if t1 is None:
        t1 = now
    dur_ms = max(0.0, (t1 - t0)) * 1e3
    d = {
        "name": name,
        "trace_id": ctx.trace_id,
        "span_id": new_span_id(),
        "parent_id": ctx.span_id,
        # reconstruct the epoch start from "how long ago t0 was"
        "t": time.time() - max(0.0, now - t0),
        "dur_ms": round(dur_ms, 3),
        "attrs": {k: v for k, v in attrs.items() if v is not None},
    }
    if error is not None:
        d["error"] = str(error)[:300]
    store().add_span_dict(d)
    return d


def flag_trace(ctx_or_id, reason: str):
    """Mark a trace for unconditional retention (``"deadline"``,
    ``"retry"``, ``"timeout"``, ...). Works before OR after the trace
    finishes."""
    if not enabled() or ctx_or_id is None:
        return
    tid = getattr(ctx_or_id, "trace_id", ctx_or_id)
    if tid:
        store().flag_trace(tid, reason)


def flag_current_trace(reason: str):
    ctx = current_context()
    if ctx is not None:
        flag_trace(ctx, reason)


# ---------------------------------------------------------------------------
# the tail-sampled trace store
# ---------------------------------------------------------------------------


class TraceStore:
    """Bounded in-process trace retention with tail-based sampling.

    Spans accumulate per trace while it is *active*; when the local
    root ends, :meth:`finish` decides retention from the OUTCOME:

    - flagged traces (deadline / retry / timeout / explicit) — kept;
    - any span errored — kept;
    - slowest-K of the current window — kept (a faster window entrant
      evicts the slowest-only trace it outcompeted, so the window holds
      exactly the top K);
    - everything else — dropped.

    Retained traces are a bounded FIFO (``FLAGS_trace_store_capacity``).
    Active (unfinished) traces are bounded too: a trace whose root is
    lost (crashed thread) ages out instead of leaking.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._active: OrderedDict = OrderedDict()
        self._retained: OrderedDict = OrderedDict()
        self._win_t0 = time.monotonic()
        self._win_slow: list = []  # [dur_ms, trace_id] entries
        self.finished_total = 0
        self.retained_total = 0
        self.dropped_total = 0

    # -- knobs (read per call: set_flags takes effect immediately) ----------

    @property
    def capacity(self) -> int:
        try:
            return max(1, int(flag("trace_store_capacity")))
        except Exception:
            return 256

    @property
    def slowest_k(self) -> int:
        try:
            return max(0, int(flag("trace_sample_slowest_k")))
        except Exception:
            return 5

    @property
    def window_s(self) -> float:
        try:
            return max(0.001, float(flag("trace_sample_window_s")))
        except Exception:
            return 30.0

    # -- writing -------------------------------------------------------------

    def add_span(self, span: Span):
        if span.trace_id:
            self.add_span_dict(span.to_dict())

    def add_span_dict(self, d: dict):
        tid = d.get("trace_id")
        if not tid:
            return
        with self._lock:
            kept = self._retained.get(tid)
            if kept is not None:
                # a span landing AFTER the retention decision (a fan-in
                # or retroactive interval racing the root's finish)
                # belongs in the retained payload, not a fresh active
                # entry that would leak until GC
                if len(kept["spans"]) < _MAX_SPANS_PER_TRACE:
                    kept["spans"].append(d)
                return
            ent = self._active.get(tid)
            if ent is None:
                ent = self._active[tid] = {
                    "spans": [], "flags": set(), "t": time.monotonic()}
                # active GC: lost roots must not leak the dict. Evict
                # already-decided lingerers (put-back inner subtrees
                # waiting for a possible co-hosted outer root) before
                # any LIVE trace still accumulating spans
                limit = max(4 * self.capacity, 64)
                if len(self._active) > limit:
                    for t in [t for t, e in self._active.items()
                              if e.get("decided")]:
                        if len(self._active) <= limit:
                            break
                        del self._active[t]
                while len(self._active) > limit:
                    self._active.popitem(last=False)
            else:
                # a trace receiving spans is not a lost root — keep it
                # off the GC's oldest-first end
                self._active.move_to_end(tid)
            if len(ent["spans"]) < _MAX_SPANS_PER_TRACE:
                ent["spans"].append(d)

    def flag_trace(self, tid: str, reason: str):
        with self._lock:
            kept = self._retained.get(tid)
            if kept is not None:
                if reason not in kept["kept"]:
                    kept["kept"] = sorted(set(kept["kept"]) | {reason})
                return
            ent = self._active.get(tid)
            if ent is None:
                ent = self._active[tid] = {
                    "spans": [], "flags": set(), "t": time.monotonic()}
            ent["flags"].add(reason)

    def finish(self, root_span) -> dict | None:
        """Finalize a trace (its local root just ended) and run the
        retention decision. Returns the retained payload or None."""
        d = (root_span.to_dict() if isinstance(root_span, Span)
             else dict(root_span))
        tid = d.get("trace_id")
        if not tid:
            return None
        duration_ms = float(d.get("dur_ms") or 0.0)
        with self._lock:
            kept = self._retained.get(tid)
            if kept is not None:
                # a SECOND local root for an already-retained trace:
                # router + backend co-hosted in one process share this
                # store, so one distributed trace finishes once per
                # local root — merge (span_id-deduped) instead of
                # overwriting, or the first root's subtree would vanish
                ent = self._active.pop(tid, None)
                seen = {s.get("span_id") for s in kept["spans"]}
                for s in (ent["spans"] if ent else []) + [d]:
                    if (s.get("span_id") not in seen
                            and len(kept["spans"]) < _MAX_SPANS_PER_TRACE):
                        seen.add(s.get("span_id"))
                        kept["spans"].append(s)
                reasons = set(ent["flags"]) if ent else set()
                if any(s.get("error") is not None
                       for s in (ent["spans"] if ent else []) + [d]):
                    # an errored outer root must promote the trace to
                    # always-kept — a kept list still == ['slow'] leaves
                    # it evictable by the slowest-K competition
                    reasons.add("error")
                if reasons:
                    kept["kept"] = sorted(set(kept["kept"]) | reasons)
                if d.get("parent_id") is None:
                    # the parentless root is the OUTERMOST (the router
                    # hop): its name/duration describe the whole trace
                    kept["root"] = d.get("name")
                    kept["duration_ms"] = round(duration_ms, 3)
                    kept["t_start"] = d.get("t")
                # the trace was already counted when it was retained —
                # a second local root is the same request, not a new one
                return kept
            ent = self._active.pop(tid, None)
            # a put-back inner root already counted this request when
            # its own retention decision ran — the outer root's finish
            # is the same request, not a new one
            already = bool(ent and ent.get("decided"))
            spans = ent["spans"] if ent else [d]
            reasons = set(ent["flags"]) if ent else set()
            if any(s.get("error") is not None for s in spans):
                reasons.add("error")
            now = time.monotonic()
            if now - self._win_t0 > self.window_s:
                self._win_t0 = now
                self._win_slow = []
            k = self.slowest_k
            if k > 0:
                if len(self._win_slow) < k:
                    self._win_slow.append([duration_ms, tid])
                    reasons.add("slow")
                else:
                    mi = min(range(len(self._win_slow)),
                             key=lambda i: self._win_slow[i][0])
                    if duration_ms > self._win_slow[mi][0]:
                        _, old_tid = self._win_slow[mi]
                        self._win_slow[mi] = [duration_ms, tid]
                        reasons.add("slow")
                        old = self._retained.get(old_tid)
                        if old is not None and old["kept"] == ["slow"]:
                            # outcompeted, and slowness was its ONLY
                            # claim — the window holds exactly top-K
                            del self._retained[old_tid]
            if not already:
                self.finished_total += 1
            if not reasons:
                if not already:
                    self.dropped_total += 1
                if ent is not None and d.get("parent_id") is not None:
                    # an INNER local root (it hangs under a remote/outer
                    # span): a co-hosted outer root may finish this
                    # trace later, and its retention decision must see
                    # this subtree — put the spans back instead of
                    # discarding (the active-table GC bounds the
                    # cross-process case where no outer root ever comes)
                    ent["decided"] = True
                    self._active[tid] = ent
                return None
            payload = {
                "trace_id": tid,
                "root": d.get("name"),
                "t_start": d.get("t"),
                "duration_ms": round(duration_ms, 3),
                "kept": sorted(reasons),
                "spans": spans,
            }
            self._retained[tid] = payload
            self.retained_total += 1
            if already:
                # the inner root's decision counted this request as
                # dropped; the outer root just kept it after all
                self.dropped_total -= 1
            while len(self._retained) > self.capacity:
                old_tid, _ = self._retained.popitem(last=False)
                self._win_slow = [w for w in self._win_slow
                                  if w[1] != old_tid]
            return payload

    # -- reading -------------------------------------------------------------

    def get(self, tid: str) -> dict | None:
        with self._lock:
            p = self._retained.get(tid)
            if p is None:
                return None
            out = dict(p)
            out["spans"] = list(p["spans"])
            return out

    def summaries(self) -> list:
        """Newest-first retained-trace summaries (the /tracez list)."""
        with self._lock:
            rows = [
                {"trace_id": p["trace_id"], "root": p["root"],
                 "duration_ms": p["duration_ms"], "kept": p["kept"],
                 "spans": len(p["spans"]), "t_start": p["t_start"]}
                for p in self._retained.values()
            ]
        rows.reverse()
        return rows

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def stats(self) -> dict:
        with self._lock:
            return {
                "finished": self.finished_total,
                "retained": self.retained_total,
                "dropped": self.dropped_total,
                "held": len(self._retained),
                "active": len(self._active),
            }

    def slowest(self, n=5, root_prefix=None) -> list:
        """Top-``n`` retained traces by root duration (optionally only
        roots starting with ``root_prefix``) with a per-stage time
        breakdown — the /statz ``slowest`` table."""
        with self._lock:
            cands = [p for p in self._retained.values()
                     if root_prefix is None
                     or (p["root"] or "").startswith(root_prefix)]
            cands = sorted(cands, key=lambda p: -p["duration_ms"])[:n]
            rows = []
            for p in cands:
                stages: dict = {}
                bucket = None
                for s in p["spans"]:
                    short = s["name"].rsplit("::", 1)[-1]
                    if short in _STAGE_NAMES:
                        stages[short] = round(
                            stages.get(short, 0.0) + s["dur_ms"], 3)
                    if bucket is None:
                        bucket = s.get("attrs", {}).get("bucket")
                rows.append({
                    "trace_id": p["trace_id"],
                    "duration_ms": p["duration_ms"],
                    "root": p["root"],
                    "kept": p["kept"],
                    "stages": stages,
                    "bucket": bucket,
                })
        return rows

    def reset(self):
        with self._lock:
            self._active.clear()
            self._retained.clear()
            self._win_slow = []
            self._win_t0 = time.monotonic()
            self.finished_total = 0
            self.retained_total = 0
            self.dropped_total = 0


_STORE = TraceStore()


def store() -> TraceStore:
    return _STORE


def reset_store():
    _STORE.reset()


# ---------------------------------------------------------------------------
# /tracez payloads + chrome view
# ---------------------------------------------------------------------------


def parse_query(raw_path: str) -> dict:
    """``/tracez?id=...&format=chrome`` -> {"id": ..., "format": ...}."""
    from urllib.parse import parse_qsl, urlsplit

    return dict(parse_qsl(urlsplit(raw_path).query))


def chrome_events(payload: dict) -> list:
    """One retained trace as chrome-trace events (``ph=X``, epoch-us
    timestamps, span ids/attrs in ``args``)."""
    pid = os.getpid()
    tid = int(payload["trace_id"][:6], 16)
    events = [{
        "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
        "args": {"name": f"trace {payload['trace_id'][:8]}"},
    }]
    for s in payload["spans"]:
        args = {"trace_id": s["trace_id"], "span_id": s["span_id"],
                "parent_id": s.get("parent_id")}
        args.update(s.get("attrs", {}))
        if s.get("links"):
            args["links"] = s["links"]
        if s.get("error") is not None:
            args["error"] = s["error"]
        events.append({
            "name": s["name"], "ph": "X",
            "ts": float(s["t"]) * 1e6,
            "dur": float(s["dur_ms"]) * 1e3,
            "pid": pid, "tid": tid, "args": args,
        })
    return events


def slowest_table(n=5, root_prefix=None) -> list:
    return store().slowest(n, root_prefix=root_prefix)


def tracez_payload(query: dict) -> tuple:
    """The ``/tracez`` response: ``(status, payload)``. No query lists
    the retained traces; ``?id=`` fetches one span tree (404 when the
    sampler dropped it); ``?id=&format=chrome`` renders it as a
    standalone chrome trace."""
    tid = query.get("id")
    st = store()
    if not tid:
        return 200, {
            "retained": st.summaries(),
            "stats": st.stats(),
            "store": {
                "capacity": st.capacity,
                "slowest_k": st.slowest_k,
                "window_s": st.window_s,
            },
        }
    payload = st.get(tid)
    if payload is None:
        return 404, {
            "error": f"trace {tid!r} not retained (dropped by the tail "
                     "sampler, evicted, or never seen)",
            "retained_ids": [r["trace_id"] for r in st.summaries()[:32]],
        }
    if query.get("format") == "chrome":
        return 200, {"traceEvents": chrome_events(payload)}
    return 200, payload
