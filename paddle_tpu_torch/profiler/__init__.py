"""Profiler (``paddle_tpu/profiler/__init__.py``): named counters, host
event ranges and the device trace behind one switch.

- **Counters** — always-on monotonic integers (``bump_counter``): the
  executor's plan-cache hits and misses, the IR analysis' cache and
  per-pass rewrite counts.
- **Host spans** — :class:`RecordEvent` ranges recorded while the
  profiler is on, as chrome-trace ``X`` events on the
  ``time.perf_counter`` clock. A span around asynchronous work (a graph
  replay, a kernel launch) times the host's enqueue, not the device.
- **Device trace** — :func:`start_profiler` with a ``state`` other than
  ``"CPU"`` also starts ``torch.profiler`` (the CPU and, where there is a
  card, the CUDA activities); :func:`stop_profiler` writes its chrome
  trace as ``<trace_dir>/plugins/profile/<run>/<host>.trace.json.gz``,
  the layout the JAX package's device trace has, so
  ``monitor.export_merged_chrome_trace`` and ``tools/trace_summary.py``
  read either.
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import tempfile
import threading
import time

__all__ = [
    "RecordEvent",
    "record_event",
    "start_profiler",
    "stop_profiler",
    "profiler",
    "reset_profiler",
    "export_chrome_tracing",
    "bump_counter",
    "counters",
    "reset_counters",
    "device_trace_dir",
    "host_events",
]

_events = []
_events_lock = threading.Lock()
_enabled = [False]
_device_trace_dir = [None]
# the live torch.profiler session between start_profiler and stop_profiler
_device_session = [None]
# survives stop_profiler so monitor.export_merged_chrome_trace can find
# the device-side files the run just wrote
_last_device_trace_dir = [None]


def device_trace_dir():
    """Directory of the most recent device trace (None if the run never
    started one, e.g. ``state='CPU'`` profiling)."""
    return _last_device_trace_dir[0]


_counters_lock = threading.Lock()
_counters: dict = {}


def bump_counter(name: str, n: int = 1) -> None:
    """Increment a named monotonic counter."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """Snapshot of all counters."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


def _now_us():
    return time.perf_counter_ns() / 1e3


class RecordEvent:
    """A named host range, as a context manager or a ``begin()``/``end()``
    pair. Whether it records is decided at ``begin()``: a span in flight
    when :func:`stop_profiler` lands is still recorded, and the disabled
    path reads no clock."""

    def __init__(self, name):
        self.name = name
        self._begin = None
        self._began_enabled = False

    def begin(self):
        self._began_enabled = _enabled[0]
        if self._began_enabled:
            self._begin = _now_us()
        return self

    def end(self):
        if not self._began_enabled or self._begin is None:
            return
        ev = {
            "name": self.name,
            "ph": "X",
            "ts": self._begin,
            "dur": _now_us() - self._begin,
            "pid": os.getpid(),
            "tid": threading.get_ident() % 100000,
        }
        with _events_lock:
            _events.append(ev)
        self._begin = None

    def __enter__(self):
        return self.begin()

    def __exit__(self, *exc):
        self.end()
        return False


@contextlib.contextmanager
def record_event(name):
    with RecordEvent(name):
        yield


def _note_double_start(**fields):
    bump_counter("profiler::double_start")
    from ..monitor import flight_recorder as _flight

    _flight.record_event("profiler_double_start", **fields)


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_profiler(state="All", tracer_option="Default", trace_dir=None):
    """Turn the host spans on and, unless ``state`` is ``"CPU"``, start a
    ``torch.profiler`` session whose trace :func:`stop_profiler` writes
    under ``trace_dir`` (default: ``paddle_tpu_trace`` in the temp
    directory). A second start while a session is live changes nothing
    and is counted (``profiler::double_start``, a
    ``profiler_double_start`` flight event)."""
    import torch

    _enabled[0] = True
    if state == "CPU":
        return
    if _device_session[0] is not None:
        _note_double_start(trace_dir=_device_trace_dir[0])
        return
    d = trace_dir or os.path.join(tempfile.gettempdir(), "paddle_tpu_trace")
    os.makedirs(d, exist_ok=True)
    session = torch.profiler.profile(activities=_activities())
    try:
        session.__enter__()
    except RuntimeError as e:  # another profiler session owns the process
        _note_double_start(trace_dir=d, owner="external", error=str(e)[:200])
        return
    _device_session[0] = session
    _device_trace_dir[0] = d
    _last_device_trace_dir[0] = d


def _write_device_trace(session, d):
    """The session's chrome trace as ``<d>/plugins/profile/<run>/<host>.trace.json.gz``."""
    run = time.strftime("%Y_%m_%d_%H_%M_%S") + f"_{os.getpid()}"
    out = os.path.join(d, "plugins", "profile", run)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{socket.gethostname()}.trace.json.gz")
    session.export_chrome_trace(path)
    return path


def stop_profiler(sorted_key=None, profile_path=None, file=None):
    """Turn the host spans off, stop the device session and write its
    trace; write the host spans to ``profile_path`` when given, and print
    the per-event table when ``sorted_key`` is given."""
    _enabled[0] = False
    session, _device_session[0] = _device_session[0], None
    if session is not None:
        session.__exit__(None, None, None)
        _write_device_trace(session, _device_trace_dir[0])
        _device_trace_dir[0] = None
    if profile_path:
        export_chrome_tracing(profile_path)
    if sorted_key is not None:
        print_summary(sorted_key=sorted_key, file=file)


def summary_records():
    """Aggregate collected events: name -> dict(calls,total,min,max,ave) in ms."""
    with _events_lock:
        evs = list(_events)
    agg = {}
    for ev in evs:
        rec = agg.setdefault(
            ev["name"], {"calls": 0, "total": 0.0, "min": float("inf"), "max": 0.0}
        )
        dur_ms = ev["dur"] / 1e3
        rec["calls"] += 1
        rec["total"] += dur_ms
        rec["min"] = min(rec["min"], dur_ms)
        rec["max"] = max(rec["max"], dur_ms)
    for rec in agg.values():
        rec["ave"] = rec["total"] / rec["calls"]
    return agg


_SORT_KEYS = {
    "default": None,
    "calls": "calls",
    "total": "total",
    "max": "max",
    "min": "min",
    "ave": "ave",
}


def print_summary(sorted_key="total", file=None):
    """The per-event table: calls, total, min, max, average and share,
    sorted by ``sorted_key`` ("min" ascending, the others descending),
    then the counters."""
    if sorted_key not in _SORT_KEYS:
        raise ValueError(
            f"sorted_key must be one of {sorted(_SORT_KEYS)}, got {sorted_key!r}"
        )
    agg = summary_records()
    if not agg:
        print("No profiler events recorded.", file=file)
        _print_counters(file)
        return
    grand_total = sum(r["total"] for r in agg.values()) or 1.0
    key = _SORT_KEYS[sorted_key]
    ascending = key == "min"
    items = sorted(
        agg.items(), key=(lambda kv: kv[1][key]) if key else (lambda kv: kv[0]),
        reverse=key is not None and not ascending,
    )
    name_w = max(10, min(50, max(len(n) for n in agg)))
    header = (
        f"{'Event':<{name_w}}  {'Calls':>8}  {'Total(ms)':>12}  "
        f"{'Min(ms)':>10}  {'Max(ms)':>10}  {'Ave(ms)':>10}  {'Ratio':>7}"
    )
    bar = "-" * len(header)
    print("\n------------------------->     Profiling Report     "
          "<-------------------------\n", file=file)
    order = "ascending" if ascending else "descending"
    print(f"Sorted by {sorted_key} in {order} order"
          if key else "Sorted by event name", file=file)
    print(bar, file=file)
    print(header, file=file)
    print(bar, file=file)
    for name, r in items:
        print(
            f"{name[:name_w]:<{name_w}}  {r['calls']:>8}  {r['total']:>12.4f}  "
            f"{r['min']:>10.4f}  {r['max']:>10.4f}  {r['ave']:>10.4f}  "
            f"{r['total'] / grand_total:>7.4f}",
            file=file,
        )
    print(bar, file=file)
    _print_counters(file, name_w, footer_bar=bar)


def _print_counters(file=None, name_w=40, footer_bar=None):
    snap = counters()
    if not snap:
        return
    print("Counters:", file=file)
    for name in sorted(snap):
        print(f"  {name:<{name_w}}  {snap[name]:>10}", file=file)
    if footer_bar:
        print(footer_bar, file=file)


def host_events():
    """Snapshot of the collected host spans (chrome-trace dict events)."""
    with _events_lock:
        return list(_events)


def reset_profiler():
    with _events_lock:
        _events.clear()


def export_chrome_tracing(path):
    """Write collected host events as a chrome://tracing JSON file."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with _events_lock:
        trace = {"traceEvents": list(_events)}
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None):
    """fluid.profiler.profiler context manager."""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)
