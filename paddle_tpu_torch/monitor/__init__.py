"""Run telemetry of the port (``paddle_tpu/monitor``): the metrics registry's
core and its Prometheus text.

- :mod:`monitor.registry` — counters, gauges and bucketed histograms with
  labeled children, quantiles and exact cross-process histogram merges,
  in the JAX package's snapshot layout.
- :mod:`monitor.export` — ``prometheus_text`` over the registry.

Tracing, the flight recorder, SLOs, goodput, the cost model and the
profilers wait for ROADMAP.md Queue A item 10.
"""
from __future__ import annotations

from .export import PROMETHEUS_CONTENT_TYPE, prometheus_text  # noqa: F401
from .registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    all_metrics,
    counter,
    format_labels,
    gauge,
    histogram,
    histogram_quantile,
    merge_histogram_snapshots,
    registry_snapshot,
    reset_registry,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
    "histogram_quantile", "merge_histogram_snapshots", "all_metrics",
    "registry_snapshot", "reset_registry", "format_labels", "DEFAULT_BUCKETS",
    "prometheus_text", "PROMETHEUS_CONTENT_TYPE",
]
