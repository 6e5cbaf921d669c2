"""Live debug endpoint: a stdlib-http.server window into a running job
(``paddle_tpu/monitor/debug_server.py``). It serves, on
``127.0.0.1:<FLAGS_debug_port + rank>``:

- ``/healthz``       — JSON liveness: pid/rank/uptime, progress-clock age
  (the hang watchdog's input), watchdog state, recorder depth.
- ``/metrics``       — the Prometheus text dump (monitor.export), i.e. a
  scrape target for free.
- ``/flightrecorder``— the live flight-recorder snapshot (ring events,
  per-group collective tails, thread stacks, flags) as JSON.
- ``/threadz``       — every Python thread's stack, plain text.
- ``/flagz``         — the FLAGS registry (core.globals() view) as JSON.
- ``/costz``         — per-step counted cost sheets (FLOPs, bytes, memory
  footprint) + the device peak table (monitor.cost_model).
- ``/clusterz``      — 501 with a JSON reason: the cross-rank view needs
  the port's multi-process runtime, which does not exist yet.
- ``/tracez``        — the tail-sampled trace store (monitor.tracing):
  retained-trace list, one span tree by ``?id=``, chrome-trace view via
  ``?id=...&format=chrome``.
- ``/metricz``       — alias of ``/metrics`` matching the serving
  servers' scrape route (one target path fleet-wide).
- ``/sloz``          — error-budget burn per installed SLO
  (monitor.slo): fast/slow window burn rates, alert state.
- ``/goodputz``      — the lifetime training goodput ledger
  (monitor.goodput): exclusive phase seconds, goodput ratio,
  lost-work/resume accounting, conservation check.
- ``/profilez``      — per-op device-time profiles (monitor.opprof):
  replay-measured op table with MFU/roofline per op, trace-attribution
  coverage, time-accuracy closure; ``?program=``/``?topk=`` views.

Loopback-bound on purpose: the debug surface exposes run internals, so
reaching it from outside the host goes through whatever port-forwarding
the deployment already trusts.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..flags import flag
from . import flight_recorder as _flight

__all__ = ["DebugServer", "start_debug_server", "stop_debug_server",
           "debug_server", "healthz"]

_t0 = time.monotonic()

#: the /clusterz body until the port runs across processes
CLUSTERZ_UNAVAILABLE = {
    "available": False,
    "reason": "the cross-rank view (per-rank snapshots, straggler verdicts) needs the "
              "port's multi-process runtime, which is not ported yet",
}


def healthz() -> dict:
    """The /healthz payload (also importable for tests/tools)."""
    rec = _flight.get_recorder()
    wd = _flight.watchdog()
    return {
        "ok": True,
        "pid": os.getpid(),
        "rank": _flight._safe_rank(),
        "world": _flight._safe_world(),
        "uptime_s": round(time.monotonic() - _t0, 3),
        "last_progress_age_s": round(_flight.last_progress_age_s(), 3),
        "last_progress": _flight.last_progress_what(),
        "flight_recorder": {
            "enabled": rec.enabled,
            # same semantics as the dump's field of this name: total ever
            # recorded, NOT current ring occupancy
            "events_recorded": rec.total_recorded,
            "events_in_ring": len(rec.events()),
            "capacity": rec.capacity,
        },
        "watchdog": (
            {"alive": wd.alive, "timeout_s": wd.timeout_s,
             "trips": wd.trips, "last_dump": wd.last_dump}
            if wd is not None else None),
    }


def _threadz_text() -> str:
    blocks = []
    for name, frames in sorted(_flight.thread_stacks().items()):
        blocks.append(f"--- thread {name} ---\n" + "\n".join(frames))
    return "\n\n".join(blocks) + "\n"


def _index_text(routes) -> str:
    lines = ["paddle_tpu_torch debugz — live fault-diagnosis endpoint", ""]
    lines += [f"  {r}" for r in sorted(routes)]
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "ptpu-debugz/1"

    def log_message(self, *args):  # no per-request stderr chatter
        pass

    def _routes(self):
        from . import cost_model as _cost
        from . import goodput as _goodput
        from . import slo as _slo
        from .export import PROMETHEUS_CONTENT_TYPE, prometheus_text

        return {
            "/healthz": lambda: (
                json.dumps(healthz(), indent=1), "application/json"),
            "/metrics": lambda: (
                prometheus_text(), PROMETHEUS_CONTENT_TYPE),
            # scrape-target alias matching the serving servers' route
            "/metricz": lambda: (
                prometheus_text(), PROMETHEUS_CONTENT_TYPE),
            "/sloz": lambda: (
                json.dumps(_slo.sloz_payload(), indent=1, default=str),
                "application/json"),
            "/goodputz": lambda: (
                json.dumps(_goodput.goodputz_payload(), indent=1,
                           default=str), "application/json"),
            "/flightrecorder": lambda: (
                json.dumps(_flight.get_recorder().snapshot(reason="debugz"),
                           indent=1, default=str), "application/json"),
            "/threadz": lambda: (_threadz_text(), "text/plain"),
            "/flagz": lambda: (
                json.dumps(_flight._safe_flags(), indent=1, default=str),
                "application/json"),
            "/costz": lambda: (
                json.dumps(_cost.costz_payload(), indent=1, default=str),
                "application/json"),
        }

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path != "/" and path.endswith("/"):
            path = path.rstrip("/")
        routes = self._routes()
        try:
            if path in ("/", "/debugz", "/index"):
                body = _index_text(list(routes) + ["/tracez", "/profilez", "/clusterz"])
                ctype, status = "text/plain", 200
            elif path == "/clusterz":
                body = json.dumps(CLUSTERZ_UNAVAILABLE, indent=1)
                ctype, status = "application/json", 501
            elif path == "/profilez":
                # query-carrying route (?program=, ?topk=): the per-op
                # replay/attribution profiles (monitor.opprof) — 404 for
                # an unknown program name keeps its real status
                from . import opprof as _opprof
                from . import tracing as _tracing

                status, payload = _opprof.profilez_payload(
                    _tracing.parse_query(self.path))
                body = json.dumps(payload, indent=1, default=str)
                ctype = "application/json"
            elif path == "/tracez":
                # query-carrying route (?id=, ?format=chrome): handled
                # outside the zero-arg routes table so the 404 for a
                # sampled-away trace keeps its real status
                from . import tracing as _tracing

                status, payload = _tracing.tracez_payload(
                    _tracing.parse_query(self.path))
                body = json.dumps(payload, indent=1, default=str)
                ctype = "application/json"
            elif path in routes:
                body, ctype = routes[path]()
                status = 200
            else:
                body = f"404: unknown path {path!r}; try {sorted(routes)}\n"
                ctype, status = "text/plain", 404
        except Exception as e:  # a broken handler must not kill the server
            import traceback

            body = (f"500: {type(e).__name__}: {e}\n"
                    + traceback.format_exc())
            ctype, status = "text/plain", 500
        payload = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", f"{ctype}; charset=utf-8")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        try:
            self.wfile.write(payload)
        except (BrokenPipeError, ConnectionResetError):
            pass


class DebugServer:
    """Threaded HTTP debug server; ``port=0`` binds an ephemeral port
    (tests / debugz-smoke). Serving happens on a daemon thread, so the
    endpoint stays reachable while the main thread is hung — which is
    precisely when it matters."""

    def __init__(self, port=0, host="127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name=f"ptpu-debugz:{self.port}", daemon=True)
            self._thread.start()
            _flight.record_event("debug_server_start", port=self.port,
                                 host=self.host)
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None
        _flight.record_event("debug_server_stop", port=self.port)


_server = [None]


def debug_server() -> DebugServer | None:
    return _server[0]


def start_debug_server(port=None, host="127.0.0.1") -> DebugServer | None:
    """Start the global debug server (idempotent). ``port=None`` reads
    ``FLAGS_debug_port`` (0 there means disabled → None); an explicit
    ``port=0`` binds an ephemeral port."""
    srv = _server[0]
    if srv is not None:
        return srv
    if port is None:
        port = int(flag("debug_port"))
        if port <= 0:
            return None
    srv = DebugServer(port=port, host=host).start()
    _server[0] = srv
    return srv


def stop_debug_server():
    srv = _server[0]
    if srv is not None:
        srv.stop()
    _server[0] = None
