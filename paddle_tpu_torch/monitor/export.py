"""Prometheus text exposition of the registry (``paddle_tpu/monitor/export.py:38-148``).

The JAX exporter also writes the profiler's dispatch counters; the port
has no profiler counters, so it walks the registry alone. The chrome-trace
half of the JAX module waits for tracing (ROADMAP.md Queue A item 10).
"""
from __future__ import annotations

import math
import re

from . import registry as _reg

__all__ = ["prometheus_text", "PROMETHEUS_CONTENT_TYPE"]

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
