"""Telemetry exporters (``paddle_tpu/monitor/export.py``): the Prometheus
text dump and the merged chrome trace.

- :func:`prometheus_text` / :func:`export_prometheus` — the text
  exposition format over every registered metric. The JAX exporter also
  writes the profiler's dispatch counters; the port's stay on the
  profiler (``profiler.counters()``), so a scrape of the registry is the
  registry.
- :func:`export_merged_chrome_trace` — ONE chrome-trace JSON holding the
  host-side ``RecordEvent`` spans, the device trace ``torch.profiler``
  wrote under ``profiler.device_trace_dir()`` (``*.trace.json.gz``, the
  JAX package's run layout), the retained request and step traces, the
  goodput phase track and the per-op replay tracks, so host dispatch
  gaps line up against kernel occupancy in one view;
  ``tools/trace_summary.py`` reads it.
"""
from __future__ import annotations

import glob
import gzip
import json
import math
import os
import re
import time

from .. import profiler
from . import registry as _reg

__all__ = ["prometheus_text", "PROMETHEUS_CONTENT_TYPE", "export_prometheus",
           "export_merged_chrome_trace"]

# the exposition format's media type: every HTTP route serving
# prometheus_text() sends exactly this
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"

# '/' and ':' (reserved for recording rules) become '_'
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    """A registry name as a Prometheus metric name."""
    n = _NAME_RE.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def _escape_help(s: str) -> str:
    """``# HELP`` text escaped: an unescaped newline would split it into a
    sample line that breaks the scrape."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v) -> str:
    # the format's literals for infinities and NaN
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v != int(v):
            return repr(v)
    return str(int(v))


def _histogram_lines(lines, pname, snap, sel=""):
    """One histogram series (buckets, sum, count); ``sel`` is a labeled
    child's escaped selector body, empty for the bare family."""
    pre = f"{sel}," if sel else ""
    acc = 0
    for le, c in zip(snap["bounds"] + ["+Inf"], snap["buckets"]):
        acc += c
        le_s = le if isinstance(le, str) else repr(float(le))
        lines.append(f'{pname}_bucket{{{pre}le="{le_s}"}} {acc}')
    suffix = f"{{{sel}}}" if sel else ""
    lines.append(f"{pname}_sum{suffix} {_fmt(snap['sum'])}")
    lines.append(f"{pname}_count{suffix} {snap['count']}")


def prometheus_text() -> str:
    """The registry in the Prometheus text format: a ``# TYPE`` line a
    family (``# HELP`` when it has help text), every labeled child series
    and the bare parent, which for counters and histograms is the exact
    aggregate over the labels.

    Sanitizing is lossy ('/' and ':' both become '_'), so two registry
    names can claim one series: that raises, naming both."""
    lines = []
    seen: dict[str, str] = {}
    for name, m in _reg.all_metrics().items():
        pname = _prom_name(name)
        prior = seen.get(pname)
        if prior is not None:
            raise ValueError(f"prometheus name collision: registry metric {name!r} and {prior} "
                             f"both emit the series {pname!r}; rename one metric")
        seen[pname] = f"registry metric {name!r}"
        snap = m.snapshot()  # one lock: buckets, sum and count of one instant
        if m.help:
            lines.append(f"# HELP {pname} {_escape_help(m.help)}")
        if snap["kind"] == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            _histogram_lines(lines, pname, snap)
            for sel, sub in (snap.get("series") or {}).items():
                _histogram_lines(lines, pname, sub, sel)
        else:
            lines.append(f"# TYPE {pname} {snap['kind']}")
            lines.append(f"{pname} {_fmt(snap['value'])}")
            for sel, sub in (snap.get("series") or {}).items():
                lines.append(f"{pname}{{{sel}}} {_fmt(sub['value'])}")
    return "\n".join(lines) + "\n"


def export_prometheus(path=None) -> str:
    """Write (optional) and return the Prometheus text dump."""
    text = prometheus_text()
    if path:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return text


def _device_trace_events(trace_dir):
    """traceEvents of every ``<dir>/**/*.trace.json.gz`` run under
    ``trace_dir`` (the layout :func:`profiler.stop_profiler` writes);
    unreadable files are skipped."""
    events = []
    if not trace_dir:
        return events
    pattern = os.path.join(trace_dir, "**", "*.trace.json.gz")
    for fn in sorted(glob.glob(pattern, recursive=True)):
        try:
            with gzip.open(fn, "rt") as f:
                trace = json.load(f)
        except (OSError, ValueError):
            continue
        events.extend(trace.get("traceEvents", []))
    return events


def _align_clock_bases(host, device):
    """Shift device events onto the host span clock: both recordings start
    at about the same instant (:func:`profiler.start_profiler` starts the
    device session), so earliest is anchored to earliest. Events without a
    ``ts`` (metadata) pass through."""
    host_ts = [e["ts"] for e in host if "ts" in e]
    dev_ts = [e["ts"] for e in device if "ts" in e]
    if not host_ts or not dev_ts:
        return device
    offset = min(host_ts) - min(dev_ts)
    for e in device:
        if "ts" in e:
            e["ts"] = e["ts"] + offset
    return device


def _retained_trace_events(host):
    """The retained request and step traces (monitor.tracing) as chrome
    events, one synthetic thread per trace. Trace spans stamp epoch time,
    host spans ``perf_counter``: one paired reading of both clocks gives
    the exact offset (a retained trace does not start with the
    recording)."""
    from . import tracing as _tracing

    st = _tracing.store()
    events = []
    for row in st.summaries():
        payload = st.get(row["trace_id"])
        if payload is not None:
            events.extend(_tracing.chrome_events(payload))
    if not host:
        return events  # no host track: epoch timestamps stand alone
    offset_us = time.perf_counter_ns() / 1e3 - time.time() * 1e6
    for e in events:
        if "ts" in e:
            e["ts"] = e["ts"] + offset_us
    return events


def export_merged_chrome_trace(path, device_trace_dir=None) -> str:
    """Write the host spans, the device trace, the retained traces, the
    goodput phase track and the per-op replay tracks as one
    chrome://tracing JSON. ``device_trace_dir`` defaults to the most recent
    device trace's (:func:`profiler.device_trace_dir`)."""
    from . import goodput as _goodput
    from . import opprof as _opprof

    if device_trace_dir is None:
        device_trace_dir = profiler.device_trace_dir()
    host = profiler.host_events()
    events = [{"name": "process_name", "ph": "M", "pid": os.getpid(),
               "args": {"name": "paddle_tpu_torch host"}}]
    events.extend(host)
    events.extend(_align_clock_bases(host, _device_trace_events(device_trace_dir)))
    events.extend(_retained_trace_events(host))
    events.extend(_goodput.chrome_events())
    events.extend(_opprof.chrome_events())
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path
