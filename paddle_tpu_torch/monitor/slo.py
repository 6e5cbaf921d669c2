"""Error-budget SLOs: declarative objectives + multi-window burn rate
(``paddle_tpu/monitor/slo.py``, the port's own copy).

The serving metrics say what the fleet IS doing; nothing in the
stack says what it SHOULD be doing. This module adds the objective
layer: an :class:`SLO` declares a target over one metric selector
("99% of predict requests under 250ms over 1h"), and the
:class:`SLOEngine` samples the live registry, turning the good/total
deltas into Google-SRE-style multi-window burn rates — how many times
faster than sustainable the error budget is being spent.

Two windows, both over the alert threshold, page: the slow window
(``window_s``, canonically 1h) proves the burn is sustained, the fast
window (``window_s/12``, canonically 5m) proves it is still happening —
one window alone either flaps on blips or keeps alerting long after
recovery. The default threshold 14.4 is the SRE-workbook convention: a
14.4x burn exhausts a 30-day budget in ~2 days.

Selectors are label-aware (``serving/e2e_ms{kind=predict}``): labels
subset-match the family's labeled children (registry ``labels()``
series), so one objective can cover one tenant, one kind, or the bare
aggregate. Latency objectives count good events from the cumulative
buckets (interpolating inside the threshold's bucket — exact at bucket
bounds); error objectives ratio two counters.

Fleet wiring: every serving entrypoint calls :func:`install_from_flags`
(``FLAGS_slo_objectives``), ``/sloz`` serves :func:`sloz_payload` on
both server kinds + router + debug server, alert transitions record a
``slo_burn`` flight event, and :func:`current_burn` gives the fleet's
worst confirmed burn (the signal the JAX package's autoscaler reads).
"""
from __future__ import annotations

import re
import threading
import time
from collections import deque

from ..errors import InvalidArgumentError
from . import registry as _reg

__all__ = [
    "SLO", "SLOEngine",
    "parse_selector", "parse_objective",
    "engine", "reset_engine",
    "install_slo", "install_from_flags",
    "sloz_payload", "current_burn",
]


_SELECTOR_RE = re.compile(r"^\s*([^{}\s]+)\s*(?:\{(.*)\})?\s*$")


def parse_selector(selector):
    """``metric`` or ``metric{k=v,k2="v2"}`` -> (metric, labels dict).

    Labels subset-match a family's labeled series: an empty dict selects
    the bare parent (the aggregate over labels for counters/histograms).
    """
    m = _SELECTOR_RE.match(str(selector))
    if not m:
        raise InvalidArgumentError(
            f"bad SLO selector {selector!r}: expected "
            "metric or metric{k=v,...}")
    name, body = m.group(1), m.group(2)
    labels = {}
    for part in (body or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise InvalidArgumentError(
                f"bad label match {part!r} in selector {selector!r} "
                "(expected k=v)")
        k, v = part.split("=", 1)
        labels[k.strip()] = v.strip().strip('"')
    return name, labels


class SLO:
    """One declarative objective over a metric selector.

    Exactly one of ``threshold_ms`` (latency mode: good = observations
    at or under the threshold, total = histogram count) or
    ``error_ratio`` (error mode: ``selector`` names the BAD-events
    counter, ``error_ratio`` is the selector of the total counter; good
    = total - bad) must be given. ``target`` is the good fraction the
    objective promises (budget = 1 - target); ``window_s`` is the slow
    burn window, with the fast window at ``max(60, window_s / 12)`` —
    the canonical 1h/5m pairing at the default 3600.
    """

    def __init__(self, name, selector, threshold_ms=None, error_ratio=None,
                 target=0.999, window_s=3600.0, alert_burn=None):
        if (threshold_ms is None) == (error_ratio is None):
            raise InvalidArgumentError(
                f"SLO {name!r}: exactly one of threshold_ms / "
                "error_ratio required")
        target = float(target)
        if not 0.0 < target < 1.0:
            raise InvalidArgumentError(
                f"SLO {name!r}: target must be in (0, 1), got {target}")
        self.name = str(name)
        self.selector = str(selector)
        self.metric, self.labels = parse_selector(selector)
        self.threshold_ms = (None if threshold_ms is None
                             else float(threshold_ms))
        self.total_selector = (None if error_ratio is None
                               else str(error_ratio))
        if self.total_selector is not None:
            self.total_metric, self.total_labels = parse_selector(
                self.total_selector)
        self.target = target
        self.window_s = float(window_s)
        if self.window_s <= 0:
            raise InvalidArgumentError(
                f"SLO {name!r}: window_s must be > 0")
        self.fast_window_s = max(60.0, self.window_s / 12.0)
        # per-objective override of FLAGS_slo_burn_alert (None = flag)
        self.alert_burn = (None if alert_burn is None
                           else float(alert_burn))

    @property
    def mode(self) -> str:
        return "latency" if self.threshold_ms is not None else "error"

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def describe(self) -> dict:
        out = {"name": self.name, "selector": self.selector,
               "mode": self.mode, "target": self.target,
               "window_s": self.window_s,
               "fast_window_s": self.fast_window_s}
        if self.mode == "latency":
            out["threshold_ms"] = self.threshold_ms
        else:
            out["total_selector"] = self.total_selector
        return out


def parse_objective(entry) -> SLO:
    """One FLAGS_slo_objectives entry -> :class:`SLO`.

    Grammar: ``name|selector|field=value|...`` with fields
    ``threshold_ms``, ``error_ratio``, ``target``, ``window_s``,
    ``alert_burn`` — e.g.
    ``predict-p99|serving/e2e_ms{kind=predict}|threshold_ms=250|target=0.99``.
    """
    parts = [p.strip() for p in str(entry).split("|")]
    if len(parts) < 3:
        raise InvalidArgumentError(
            f"bad SLO objective {entry!r}: expected "
            "name|selector|field=value[|...]")
    kwargs = {}
    for field in parts[2:]:
        if "=" not in field:
            raise InvalidArgumentError(
                f"bad SLO field {field!r} in {entry!r} (expected k=v)")
        k, v = (s.strip() for s in field.split("=", 1))
        if k in ("threshold_ms", "target", "window_s", "alert_burn"):
            kwargs[k] = float(v)
        elif k == "error_ratio":
            kwargs[k] = v
        else:
            raise InvalidArgumentError(
                f"unknown SLO field {k!r} in {entry!r} (have: "
                "threshold_ms, error_ratio, target, window_s, "
                "alert_burn)")
    return SLO(parts[0], parts[1], **kwargs)


# -- good/total measurement ---------------------------------------------------

def _matching_snaps(snap, labels):
    """Sub-snapshots of ``snap`` whose labels contain every selector
    pair (subset match); the parent itself when the selector is bare."""
    if not labels:
        return [snap]
    out = []
    for sub in (snap.get("series") or {}).values():
        sl = sub.get("labels") or {}
        if all(sl.get(k) == v for k, v in labels.items()):
            out.append(sub)
    return out


def _good_total_latency(snaps, threshold_ms):
    """(good, total) events across histogram snapshots: good = count of
    observations <= threshold_ms from the cumulative buckets, linearly
    interpolated inside the bucket the threshold falls in (exact when
    the threshold sits on a bucket bound — pick thresholds there for
    golden-stable SLOs). +Inf-bucket observations are never good."""
    good = total = 0.0
    for s in snaps:
        total += s["count"]
        lo = 0.0
        for bound, c in zip(s["bounds"], s["buckets"]):
            if threshold_ms >= bound:
                good += c
                lo = bound
                continue
            if threshold_ms > lo and c:
                good += c * (threshold_ms - lo) / (bound - lo)
            break
    return good, total


def _counter_value(metric, labels):
    m = _reg.all_metrics().get(metric)
    if m is None:
        return 0.0
    snap = m.snapshot()
    if "value" not in snap:
        return 0.0
    if not labels:
        return float(snap["value"])
    return float(sum(s.get("value", 0.0)
                     for s in _matching_snaps(snap, labels)))


def _measure(slo: SLO):
    """Current cumulative (good, total) for one objective; (0, 0) when
    the metric does not exist yet (a backend that has not served)."""
    if slo.mode == "latency":
        m = _reg.all_metrics().get(slo.metric)
        if m is None or m.kind != "histogram":
            return 0.0, 0.0
        return _good_total_latency(
            _matching_snaps(m.snapshot(), slo.labels), slo.threshold_ms)
    bad = _counter_value(slo.metric, slo.labels)
    total = _counter_value(slo.total_metric, slo.total_labels)
    return max(0.0, total - bad), total


def _alert_threshold(slo: SLO) -> float:
    if slo.alert_burn is not None:
        return slo.alert_burn
    try:
        from ..flags import flag

        return float(flag("slo_burn_alert"))
    except Exception:
        return 14.4


# -- the engine ---------------------------------------------------------------

class _Tracked:
    __slots__ = ("slo", "samples", "alerting")

    def __init__(self, slo):
        self.slo = slo
        # (t, good, total) cumulative samples, oldest first; pruned to
        # one slow window (plus the reference sample at its edge)
        self.samples = deque()
        self.alerting = False


class SLOEngine:
    """Samples good/total for installed objectives and computes
    multi-window burn rates over the sample history.

    ``clock`` is injectable (tests drive deterministic windows by
    passing explicit ``now`` values to :meth:`sample` /
    :meth:`sloz_payload`); production uses time.monotonic via the
    background sampler thread (:meth:`start`).
    """

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._tracked: dict[str, _Tracked] = {}
        self._stop = threading.Event()
        self._thread = None
        self._interval_s = None

    # -- objective management --

    def add(self, slo: SLO) -> SLO:
        """Install (or replace — same-name installs are idempotent so
        entrypoints can re-run install_from_flags) one objective."""
        with self._lock:
            self._tracked[slo.name] = _Tracked(slo)
        return slo

    def remove(self, name):
        with self._lock:
            self._tracked.pop(name, None)

    def objectives(self) -> list:
        with self._lock:
            return [tr.slo for tr in self._tracked.values()]

    # -- sampling + burn math --

    def sample(self, now=None):
        """Take one good/total sample per objective, prune history past
        the slow window, and fire alert-transition events. The sampler
        thread calls this on FLAGS_slo_sample_interval_s; tests call it
        directly with explicit ``now``."""
        now = float(self._clock() if now is None else now)
        with self._lock:
            tracked = list(self._tracked.values())
        for tr in tracked:
            good, total = _measure(tr.slo)
            with self._lock:
                tr.samples.append((now, good, total))
                # keep one sample at/before the slow-window start so
                # the slow delta always has its reference point
                horizon = now - tr.slo.window_s
                while (len(tr.samples) > 2
                       and tr.samples[1][0] <= horizon):
                    tr.samples.popleft()
            self._check_alert(tr, now)

    def _burn(self, tr: _Tracked, window_s: float, now: float):
        """Burn rate over the trailing window: the bad fraction of the
        good/total delta between the newest sample and the reference
        sample at/before the window start, divided by the error budget.
        None until two samples exist; computed over whatever history
        exists when the engine is younger than the window."""
        with self._lock:
            samples = list(tr.samples)
        if len(samples) < 2:
            return None
        cur = samples[-1]
        start = now - window_s
        ref = samples[0]
        for s in samples:
            if s[0] <= start:
                ref = s
            else:
                break
        d_total = cur[2] - ref[2]
        if d_total <= 0:
            return 0.0
        d_bad = max(0.0, d_total - (cur[1] - ref[1]))
        return (d_bad / d_total) / tr.slo.budget

    def _check_alert(self, tr: _Tracked, now: float):
        slo = tr.slo
        fast = self._burn(tr, slo.fast_window_s, now)
        slow = self._burn(tr, slo.window_s, now)
        alert = _alert_threshold(slo)
        alerting = (fast is not None and slow is not None
                    and fast >= alert and slow >= alert)
        if alerting and not tr.alerting:
            # entering alert is the budget-page moment: one flight
            # event per transition, not per sample
            try:
                from . import flight_recorder as _flight

                _flight.record_event(
                    "slo_burn", slo=slo.name, selector=slo.selector,
                    fast_burn=round(fast, 3), slow_burn=round(slow, 3),
                    alert_burn=alert, target=slo.target)
            except Exception:
                pass
            _reg.counter("slo/alerts_total").inc()
        tr.alerting = alerting

    def max_confirmed_burn(self) -> float:
        """Max over objectives of min(fast, slow) burn — the double-
        window-confirmed rate the autoscaler treats as pressure (0.0
        with no objectives or insufficient samples)."""
        out = 0.0
        with self._lock:
            tracked = list(self._tracked.values())
        for tr in tracked:
            with self._lock:
                if not tr.samples:
                    continue
                now = tr.samples[-1][0]
            fast = self._burn(tr, tr.slo.fast_window_s, now)
            slow = self._burn(tr, tr.slo.window_s, now)
            if fast is not None and slow is not None:
                out = max(out, min(fast, slow))
        return out

    def sloz_payload(self, now=None) -> dict:
        """The /sloz document: per objective, the live good/total, both
        window burns, and the alert verdict."""
        with self._lock:
            tracked = list(self._tracked.values())
        rows = []
        for tr in tracked:
            slo = tr.slo
            with self._lock:
                n_samples = len(tr.samples)
                last_t = tr.samples[-1][0] if tr.samples else None
            at = float(now) if now is not None else last_t
            good, total = _measure(slo)
            fast = slow = None
            if at is not None:
                fast = self._burn(tr, slo.fast_window_s, at)
                slow = self._burn(tr, slo.window_s, at)
            row = slo.describe()
            row.update({
                "budget": round(slo.budget, 9),
                "good": round(good, 3),
                "total": round(total, 3),
                "bad_fraction": (round(1.0 - good / total, 9)
                                 if total else None),
                "burn": {"fast": (None if fast is None
                                  else round(fast, 4)),
                         "slow": (None if slow is None
                                  else round(slow, 4))},
                "alert_burn": _alert_threshold(slo),
                "alerting": tr.alerting,
                "samples": n_samples,
            })
            rows.append(row)
        return {"slos": rows,
                "sampler": {"alive": self.sampler_alive,
                            "interval_s": self._interval_s}}

    # -- background sampler --

    @property
    def sampler_alive(self) -> bool:
        return bool(self._thread is not None and self._thread.is_alive())

    def start(self, interval_s=None):
        """Start the daemon sampler (idempotent); interval defaults to
        FLAGS_slo_sample_interval_s."""
        if interval_s is None:
            try:
                from ..flags import flag

                interval_s = float(flag("slo_sample_interval_s"))
            except Exception:
                interval_s = 10.0
        self._interval_s = max(0.05, float(interval_s))
        if self.sampler_alive:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self._interval_s):
                try:
                    self.sample()
                except Exception:
                    pass  # a bad objective must not kill the sampler

        self._thread = threading.Thread(
            target=_loop, name="slo-sampler", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None


# -- module-level engine ------------------------------------------------------

_engine_lock = threading.Lock()
_engine: list = [None]


def engine() -> SLOEngine:
    """The process-wide engine (created on first use)."""
    with _engine_lock:
        if _engine[0] is None:
            _engine[0] = SLOEngine()
        return _engine[0]


def reset_engine():
    """Stop the sampler and drop all objectives (tests)."""
    with _engine_lock:
        eng, _engine[0] = _engine[0], None
    if eng is not None:
        eng.stop()


def install_slo(slo: SLO) -> SLO:
    return engine().add(slo)


def install_from_flags(start_sampler=True) -> list:
    """Install objectives from ``FLAGS_slo_objectives`` (';'-separated
    :func:`parse_objective` entries) and start the sampler. The hook
    every fleet entrypoint (serving backend main, router main) calls,
    so a subprocess launched with the flag in its env serves a live
    /sloz with zero code. Returns the installed SLOs ([] when the flag
    is empty)."""
    try:
        from ..flags import flag

        spec = str(flag("slo_objectives")).strip()
    except Exception:
        spec = ""
    if not spec:
        return []
    installed = [install_slo(parse_objective(e))
                 for e in spec.split(";") if e.strip()]
    if installed and start_sampler:
        engine().start()
    return installed


def sloz_payload() -> dict:
    """The /sloz document for this process ({"slos": []} when no
    objectives are installed — endpoints serve it unconditionally)."""
    with _engine_lock:
        eng = _engine[0]
    if eng is None:
        return {"slos": [],
                "sampler": {"alive": False, "interval_s": None}}
    return eng.sloz_payload()


def current_burn() -> float:
    """Double-window-confirmed burn for FleetSignals (0.0 when no
    engine/objectives/samples exist — never raises)."""
    with _engine_lock:
        eng = _engine[0]
    if eng is None:
        return 0.0
    try:
        return eng.max_confirmed_burn()
    except Exception:
        return 0.0
