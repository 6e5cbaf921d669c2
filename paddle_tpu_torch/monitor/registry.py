"""Metrics registry: counters, gauges, bucketed histograms (``paddle_tpu/monitor/registry.py``).

Stats are keyed by string name in one process-wide registry guarded by one
lock, as the JAX package's are, with the same names, default bucket
bounds, label semantics and snapshot dict layout: a router merges the
``/histz`` bucket counts of several backends, so a snapshot of either
package merges with one of the other.

Labeled children (``metric.labels(kind=..., tenant=...)``) are bounded per
family by ``FLAGS_metrics_max_series``; past it every new label set lands in
one shared series whose values are all ``"other"``, and the first overflow
records a ``metric_series_overflow`` flight event.

Beside the metrics: the memory gauges of each card from
``torch.cuda.memory_stats`` (:func:`collect_hbm_gauges`, under the JAX
package's PJRT key names), and the compile-event listener
(:func:`install_jax_listeners`, the JAX name kept): where the JAX package
hears XLA compiles through ``jax.monitoring``, the port's compile event is
a graph capture (``runtime/compiled.py``), counted as ``graph/compile``
with its duration in ``graph/compile/duration_ms``.
"""
from __future__ import annotations

import bisect
import threading

__all__ = [
    "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram",
    "registry_snapshot", "reset_registry", "all_metrics",
    "histogram_quantile", "merge_histogram_snapshots",
    "format_labels", "DEFAULT_BUCKETS", "OVERFLOW_LABEL_VALUE",
    "STAT_INT", "STAT_FLOAT", "stat_add", "stat_reset",
    "collect_hbm_gauges", "hbm_watermark_bytes", "install_jax_listeners",
    "note_compile_event",
]

_lock = threading.Lock()
_metrics: dict[str, "_Metric"] = {}

# default latency buckets (ms): sub-ms to minutes, roughly 4x apart
DEFAULT_BUCKETS = (0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0,
                   1000.0, 5000.0, 30000.0)

# the label value every dimension collapses to once a family holds
# FLAGS_metrics_max_series label sets
OVERFLOW_LABEL_VALUE = "other"


def _escape_label_value(v) -> str:
    """A label value escaped as the Prometheus exposition format wants:
    backslash, double quote and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_labels(labels) -> str:
    """The selector body of one label set, keys sorted, values escaped:
    ``k="v",k2="v2"``. It keys the ``series`` dict of a snapshot and is what
    :func:`~paddle_tpu_torch.monitor.export.prometheus_text` writes inside
    ``{}``. Takes a dict or (key, value) pairs."""
    items = sorted(labels.items() if isinstance(labels, dict) else labels)
    return ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items)


def _max_series() -> int:
    # read at labels() time, so set_flags applies to live families
    from ..flags import flag

    return int(flag("metrics_max_series"))


class _Metric:
    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        # labeled children keyed by the sorted ((key, value), ...) tuple; a
        # counter's or histogram's child update propagates into the parent,
        # so the bare family stays the exact aggregate over its labels
        self._children: dict = {}
        self._label_keys = None  # fixed by the first labels() call
        self._labels = ()        # ((k, v), ...), set on children only
        self._overflowed = False
        self._parent = None

    def _new_child(self):
        return type(self)(self.name, help=self.help)

    def labels(self, **dims):
        """The child metric of one label set, made on first use. The
        family's label keys are fixed by the first call; other keys raise.
        Past ``FLAGS_metrics_max_series`` distinct sets, every new set maps
        to the shared ``"other"`` series."""
        if self._parent is not None:
            raise ValueError(f"metric {self.name!r}: labels() called on a labeled child; "
                             "call it on the family root")
        if not dims:
            raise ValueError(f"metric {self.name!r}: labels() needs at least one label")
        keys = tuple(sorted(dims))
        key = tuple((k, str(dims[k])) for k in keys)
        first_overflow = False
        with self._lock:
            if self._label_keys is None:
                self._label_keys = keys
            elif keys != self._label_keys:
                raise ValueError(
                    f"metric {self.name!r} labeled with keys {list(self._label_keys)}, got "
                    f"{list(keys)}; a family's label keys are fixed by its first use")
            child = self._children.get(key)
            if child is None and len(self._children) >= _max_series():
                key = tuple((k, OVERFLOW_LABEL_VALUE) for k in keys)
                child = self._children.get(key)
                first_overflow = not self._overflowed
                self._overflowed = True
            if child is None:
                child = self._new_child()
                child._parent = self
                child._labels = key
                self._children[key] = child
        if first_overflow:
            from . import flight_recorder as _flight

            _flight.record_event("metric_series_overflow", metric=self.name,
                                 max_series=_max_series())
        return child

    def series(self) -> dict:
        """Live labeled children by selector body (``k="v",...``)."""
        with self._lock:
            children = list(self._children.values())
        return {format_labels(c._labels): c for c in children}

    def _series_snapshots(self) -> dict:
        with self._lock:
            children = list(self._children.values())
        out = {}
        for c in children:
            s = c.snapshot()
            s["labels"] = dict(c._labels)
            out[format_labels(c._labels)] = s
        return out

    def _reset_children(self):
        with self._lock:
            children = list(self._children.values())
        for c in children:
            c._reset()


class Counter(_Metric):
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name, help=""):
        super().__init__(name, help)
        self._value = 0

    def inc(self, n=1):
        with self._lock:
            self._value += n
        if self._parent is not None:
            self._parent.inc(n)

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot(self):
        snap = {"kind": self.kind, "value": self.value}
        series = self._series_snapshots()
        if series:
            snap["series"] = series
        return snap

    def _reset(self):
        with self._lock:
            self._value = 0
        self._reset_children()


class Gauge(_Metric):
    """A set-to-current-value stat. Labeled children do not propagate into
    the parent: a sum of last-set values means nothing."""

    kind = "gauge"

    def __init__(self, name, help=""):
        super().__init__(name, help)
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = v

    def add(self, v):
        with self._lock:
            self._value += v

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot(self):
        snap = {"kind": self.kind, "value": self.value}
        series = self._series_snapshots()
        if series:
            snap["series"] = series
        return snap

    def _reset(self):
        with self._lock:
            self._value = 0.0
        self._reset_children()


class Histogram(_Metric):
    """Bucketed histogram (Prometheus semantics: bucket i counts
    observations <= bounds[i]; the +Inf bucket is implicit)."""

    kind = "histogram"

    def __init__(self, name, buckets=None, help=""):
        super().__init__(name, help)
        bounds = tuple(sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # the last is the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def _new_child(self):
        # children share the family's bounds, or label-aware merges mis-bin
        return Histogram(self.name, buckets=self.bounds, help=self.help)

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
        if self._parent is not None:
            self._parent.observe(v)

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def bucket_counts(self):
        """Per-bucket (not cumulative) counts, the +Inf bucket last."""
        with self._lock:
            return list(self._counts)

    def snapshot(self):
        with self._lock:
            snap = {"kind": self.kind, "sum": self._sum, "count": self._count,
                    "bounds": list(self.bounds), "buckets": list(self._counts)}
        series = self._series_snapshots()
        if series:
            snap["series"] = series
        return snap

    def _reset(self):
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0
        self._reset_children()


def _get(name, cls, **kwargs):
    with _lock:
        m = _metrics.get(name)
        if m is None:
            m = cls(name, **kwargs)
            _metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as {m.kind}, requested "
                            f"{cls.kind}")
        return m


def counter(name, help="") -> Counter:
    """The named counter, registered on first use."""
    return _get(name, Counter, help=help)


def gauge(name, help="") -> Gauge:
    return _get(name, Gauge, help=help)


def histogram(name, buckets=None, help="") -> Histogram:
    h = _get(name, Histogram, buckets=buckets, help=help)
    # other explicit bounds than the registered ones would mis-bin both
    # callers' observations
    if buckets is not None and tuple(sorted(buckets)) != h.bounds:
        raise ValueError(f"histogram {name!r} already registered with bounds {h.bounds}, "
                         f"requested {tuple(sorted(buckets))}")
    return h


def STAT_INT(name) -> Gauge:
    """A named integer stat (``DEFINE_INT_STATUS``): a gauge added to."""
    return gauge(f"stat/int/{name}")


def STAT_FLOAT(name) -> Gauge:
    return gauge(f"stat/float/{name}")


def stat_add(name, v=1):
    """``STAT_ADD(name, v)``: add to an integer stat by name."""
    STAT_INT(name).add(v)


def stat_reset(name):
    """``STAT_RESET(name)``."""
    STAT_INT(name).set(0)


def histogram_quantile(h: Histogram, q: float):
    """A quantile from the bucket counts (Prometheus' ``histogram_quantile``:
    linear inside the bucket; the +Inf bucket clamps to the largest finite
    bound). ``None`` on an empty histogram: 0.0 would read as a real 0 ms."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    snap = h.snapshot()
    total = snap["count"]
    if total == 0:
        return None
    target = q * total
    acc, lo = 0, 0.0
    for bound, c in zip(snap["bounds"], snap["buckets"]):
        if c and acc + c >= target:
            return lo + (bound - lo) * (target - acc) / c
        acc += c
        lo = bound
    return float(snap["bounds"][-1])


def merge_histogram_snapshots(snapshots, name="merged") -> Histogram:
    """Histogram ``snapshot()`` dicts of several sources (backends'
    ``/histz``) merged into one unregistered :class:`Histogram` whose
    counts are the elementwise sums: exactly the histogram of every
    observation pooled. All must share the bounds; a mismatch raises.
    Labeled ``series`` merge the same way per selector (over the sources
    that have them) and hang off the result's :meth:`~_Metric.series`."""
    snapshots = [s for s in snapshots if s]
    if not snapshots:
        raise ValueError("merge_histogram_snapshots needs >= 1 snapshot")
    bounds = tuple(snapshots[0]["bounds"])
    h = Histogram(name, buckets=bounds)
    counts = [0] * (len(bounds) + 1)
    total, sum_ = 0, 0.0
    for s in snapshots:
        if tuple(s["bounds"]) != bounds:
            raise ValueError(f"histogram bounds mismatch: {tuple(s['bounds'])} vs {bounds}; "
                             "backends must share one bucket ladder")
        if len(s["buckets"]) != len(counts):
            raise ValueError(f"histogram has {len(s['buckets'])} buckets, expected "
                             f"{len(counts)} (bounds + the +Inf bucket)")
        for i, c in enumerate(s["buckets"]):
            counts[i] += int(c)
        total += int(s["count"])
        sum_ += float(s["sum"])
    h._counts = counts
    h._count = total
    h._sum = sum_
    per_series: dict = {}
    for s in snapshots:
        for sub in (s.get("series") or {}).values():
            labels = tuple(sorted((sub.get("labels") or {}).items()))
            per_series.setdefault(labels, []).append(sub)
    for labels, subs in per_series.items():
        child = merge_histogram_snapshots(subs, name=name)
        child._labels = labels  # for series(); nothing observes into a merge
        h._children[labels] = child
    return h


def all_metrics() -> dict:
    """Live metric objects by name, in registration order."""
    with _lock:
        return dict(_metrics)


def registry_snapshot() -> dict:
    """Plain-data (JSON-safe) snapshot of every metric."""
    return {name: m.snapshot() for name, m in all_metrics().items()}


def reset_registry(unregister=False):
    """Zero every metric; ``unregister=True`` also drops the definitions."""
    with _lock:
        if unregister:
            _metrics.clear()
            return
        metrics = list(_metrics.values())
    for m in metrics:
        m._reset()


# -- memory gauges -------------------------------------------------------------

_HBM_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
             "largest_free_block_bytes")


class _Card:
    """A CUDA device whose ``memory_stats()`` reads the caching allocator
    under the PJRT key names the JAX package's gauges use."""

    def __init__(self, index):
        self.index = index

    def memory_stats(self) -> dict:
        import torch

        st = torch.cuda.memory_stats(self.index)
        return {"bytes_in_use": st.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0),
                "bytes_limit": torch.cuda.mem_get_info(self.index)[1]}


def _cards():
    import torch

    if not torch.cuda.is_available():
        return []
    return [_Card(i) for i in range(torch.cuda.device_count())]


def collect_hbm_gauges(devices=None) -> dict:
    """Set ``hbm/device<i>/<key>`` gauges from each device's
    ``memory_stats()`` and return the values set; a device publishing
    nothing (the CPU) contributes nothing, never a zero. ``devices``
    defaults to every card, read through the caching allocator
    (``torch.cuda.memory_stats``)."""
    if devices is None:
        devices = _cards()
    out = {}
    for i, d in enumerate(devices):
        try:
            stats = d.memory_stats()
        except Exception:  # a device without the stats API publishes nothing
            stats = None
        if not stats:
            continue
        for key in _HBM_KEYS:
            if key in stats:
                name = f"hbm/device{i}/{key}"
                gauge(name).set(int(stats[key]))
                out[name] = int(stats[key])
    return out


def hbm_watermark_bytes(devices=None) -> int:
    """Max ``peak_bytes_in_use`` across the devices (0 if unpublished)."""
    vals = collect_hbm_gauges(devices)
    peaks = [v for k, v in vals.items() if k.endswith("peak_bytes_in_use")]
    return max(peaks) if peaks else 0


# -- compile events ------------------------------------------------------------

_listeners_installed = [False]


def install_jax_listeners() -> bool:
    """Route the port's compile events (a graph capture, reported through
    :func:`note_compile_event`) into the registry: each bumps
    ``graph/compile`` and observes ``graph/compile/duration_ms``, and
    lands in the flight recorder. Idempotent; returns True."""
    _listeners_installed[0] = True
    return True


def note_compile_event(label, duration_s):
    """One compile event (``runtime/compiled.py`` ``GraphStore.capture``),
    counted once the listeners are installed."""
    if not _listeners_installed[0]:
        return
    counter("graph/compile").inc()
    histogram("graph/compile/duration_ms").observe(duration_s * 1e3)
    from . import flight_recorder as _flight

    _flight.record_event("graph_compile_event", label=label,
                         duration_ms=round(duration_s * 1e3, 3))
