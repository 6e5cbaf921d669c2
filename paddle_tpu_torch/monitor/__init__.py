"""Run telemetry of the port (``paddle_tpu/monitor``), with the JAX
package's names, payloads and event layout:

- :mod:`monitor.registry` — counters, gauges and bucketed histograms with
  labeled children, quantiles and exact cross-process histogram merges;
  the cards' memory gauges; the compile-event listener (a graph capture).
- :mod:`monitor.export` — ``prometheus_text`` over the registry and the
  merged chrome trace (host spans, the ``torch.profiler`` device trace,
  retained traces, goodput phases, opprof replays).
- :mod:`monitor.cost_model` — the counted FLOPs and bytes of each
  compiled step (``CostRecord``), the device peak table with H100 rows,
  MFU, HBM-bandwidth share and roofline class; ``/costz``.
- :mod:`monitor.training_monitor` — ``TrainingMonitor``'s periodic line.
- :mod:`monitor.goodput` — the lifetime goodput ledger; ``/goodputz``.
- :mod:`monitor.tracing` — per-request spans, ``traceparent``
  propagation, the tail-sampled trace store; ``/tracez``.
- :mod:`monitor.flight_recorder` — the ring of structured events, dumps,
  the hang watchdog, crash and ``SIGUSR1`` hooks.
- :mod:`monitor.slo` — objectives and burn rates; ``/sloz``.
- :mod:`monitor.opprof` — per-op stamps, trace attribution and the
  replay profiler; ``/profilez``.
- :mod:`monitor.debug_server` — the loopback debug endpoint.

The cross-rank cluster view (``monitor/cluster.py``) needs the port's
multi-process runtime and is not ported.
"""
from __future__ import annotations

from .registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    STAT_FLOAT,
    STAT_INT,
    Counter,
    Gauge,
    Histogram,
    all_metrics,
    collect_hbm_gauges,
    counter,
    format_labels,
    gauge,
    hbm_watermark_bytes,
    histogram,
    histogram_quantile,
    install_jax_listeners,
    merge_histogram_snapshots,
    registry_snapshot,
    reset_registry,
    stat_add,
    stat_reset,
)
from .export import (  # noqa: F401
    PROMETHEUS_CONTENT_TYPE,
    export_merged_chrome_trace,
    export_prometheus,
    prometheus_text,
)
from . import cost_model  # noqa: F401
from .cost_model import (  # noqa: F401
    CostRecord,
    device_peaks,
    hbm_bw_util,
    mfu,
    roofline_class,
)
from .training_monitor import (  # noqa: F401
    TrainingMonitor,
    active_monitor,
    record_input_wait_ms,
)
from . import goodput  # noqa: F401
from .goodput import (  # noqa: F401
    GoodputLedger,
    active_ledger,
    goodputz_payload,
    install_goodput_slo,
    start_ledger,
    stop_ledger,
)
from . import tracing  # noqa: F401
from .tracing import (  # noqa: F401
    SpanContext,
    TraceStore,
    annotate,
    current_context,
    current_span,
    format_traceparent,
    parse_traceparent,
    start_span,
    start_trace,
)
from . import flight_recorder  # noqa: F401
# slo.install_from_flags stays module-qualified: the package-level name
# belongs to flight_recorder's
from . import slo  # noqa: F401
from .slo import (  # noqa: F401
    SLO,
    SLOEngine,
    current_burn,
    install_slo,
    sloz_payload,
)
from . import opprof  # noqa: F401
from .opprof import (  # noqa: F401
    TIME_ACCURACY_ENVELOPE,
    attribute_trace,
    op_scope_name,
    parse_op_scope,
    profile_program,
    profilez_payload,
)
from . import debug_server  # noqa: F401
from .flight_recorder import (  # noqa: F401
    FlightRecorder,
    HangWatchdog,
    dump_now,
    install_from_flags,
)
from .debug_server import (  # noqa: F401
    DebugServer,
    start_debug_server,
    stop_debug_server,
)

__all__ = [
    "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram",
    "STAT_INT", "STAT_FLOAT", "stat_add", "stat_reset",
    "registry_snapshot", "reset_registry", "all_metrics",
    "histogram_quantile", "merge_histogram_snapshots", "format_labels",
    "collect_hbm_gauges", "hbm_watermark_bytes", "install_jax_listeners",
    "export_prometheus", "prometheus_text", "export_merged_chrome_trace",
    "PROMETHEUS_CONTENT_TYPE",
    "TrainingMonitor", "record_input_wait_ms", "active_monitor",
    "goodput", "GoodputLedger", "start_ledger", "stop_ledger",
    "active_ledger", "goodputz_payload", "install_goodput_slo",
    "cost_model", "CostRecord", "device_peaks", "mfu", "hbm_bw_util",
    "roofline_class", "DEFAULT_BUCKETS",
    "tracing", "SpanContext", "TraceStore", "annotate",
    "current_context", "current_span", "format_traceparent",
    "parse_traceparent", "start_span", "start_trace",
    "opprof", "TIME_ACCURACY_ENVELOPE", "op_scope_name", "parse_op_scope",
    "attribute_trace", "profile_program", "profilez_payload",
    "flight_recorder", "debug_server",
    "slo", "SLO", "SLOEngine", "install_slo", "sloz_payload",
    "current_burn",
    "FlightRecorder", "HangWatchdog", "dump_now", "install_from_flags",
    "DebugServer", "start_debug_server", "stop_debug_server",
]
