"""Load-aware router: one front door over N backend processes (``paddle_tpu/serving/router.py``).

One :class:`~paddle_tpu_torch.serving.InferenceServer` or
:class:`~paddle_tpu_torch.serving.GenerationServer` is one process on one
card; the router spreads ``/predict`` and ``/generate`` over a fleet of them
using the signals they publish:

- **Power-of-two-choices dispatch**: each request samples two in-rotation
  backends of its kind and takes the less loaded (router-side in-flight
  count plus the last probed ``/loadz`` queue depth). The sampling is the
  JAX router's (``random.Random(0xB0DE)``, the same candidate order), so
  over the same fleet both pick the same backends.
- **Probes**: a daemon prober reads every backend's ``/healthz`` and
  ``/loadz`` each ``FLAGS_serving_router_probe_interval_s`` and its
  ``/metricz?format=snapshot`` for ``/fleetz``. A backend that stops
  answering, drains or loses readiness is **evicted**; only a later probe
  that sees ``/healthz`` ready again re-admits it.
- **Retry on the next backend** only where the request provably never ran:
  a connection failure before a response line, or a 503 at admission.
  Every other answered status (429, 400, 504, 500) passes through; a
  backend that dies mid-response gives the client 502.
- **Disaggregated ``/generate``**: with a live ``prefill`` and a live
  ``decode`` tier, ``/generate`` becomes ``/prefill`` (under
  ``FLAGS_serving_handoff_timeout_s``) and then ``/generate_kv`` with the
  slab, each leg under the retry policy.
- **Introspection**: ``/statz`` (fleet p50/p99 merged exactly from the
  backends' ``/histz`` bucket counts, per-backend load and weight, the
  eviction, retry and readmission counters), ``/loadz``, ``/healthz``,
  ``/fleetz``, ``/histz``, ``/metrics`` and ``/metricz``.

Backends join through ``add_backend(url)`` and leave through
``remove_backend`` or eviction; the router owns no process. Run it as its
own process with ``python -m paddle_tpu_torch.serving.router --backend URL
[--backend URL ...]``: proxying is Python byte shuffling, which a busy
client or backend process would hold behind its GIL.

Telemetry, as the JAX router's: a ``serving::router`` trace root per
request (under the client's ``traceparent``, if any) and a
``serving::attempt`` span per dispatch attempt, whose context travels to
the backend in the ``traceparent`` header, so the backend's spans hang
under it in one trace; flight events for backends added, removed, evicted
and readmitted, each retry, a request no backend admitted, and the
router's start and stop. The router's own ``/tracez``, ``/sloz`` and
``/costz`` are those of its process.
"""
from __future__ import annotations

import json
import random
import socket
import threading
import time
from http.client import BadStatusLine, HTTPConnection, IncompleteRead, LineTooLong
from urllib.parse import urlsplit

from ..errors import InvalidArgumentError, UnavailableError
from ..flags import flag
from ..generation.handoff import HANDOFF_CONTENT_TYPE
from ..monitor import (
    all_metrics,
    counter,
    gauge,
    histogram,
    histogram_quantile,
    merge_histogram_snapshots,
)
from ..monitor import flight_recorder as _flight
from ..monitor import tracing as _tracing
from .server import _GET_ROUTES, LOADZ_SCHEMA_VERSION, _BaseHandler, _HTTPServer

__all__ = ["Router", "BackendState", "NoBackendError", "BackendUnavailableError",
           "BackendTimeoutError", "main"]

_POST_KINDS = {"/predict": "predict", "/generate": "generate"}

# a backend dying while its body is read: resets, a mid-body EOF, a stall,
# the rest of the socket failures
_BACKEND_READ_ERRORS = (ConnectionError, IncompleteRead, socket.timeout, OSError)


def _quantile_row(h) -> dict | None:
    """p50/p99/count of one merged histogram, or None when it is empty."""
    p50 = histogram_quantile(h, 0.5)
    if p50 is None:
        return None
    return {"p50_ms": round(p50, 3), "p99_ms": round(histogram_quantile(h, 0.99), 3),
            "count": h.count}


def _registry_quantiles(name):
    """The router's own p50/p99/count of a histogram of the process
    registry, or None when it is absent or empty."""
    h = all_metrics().get(name)
    if h is None or h.kind != "histogram":
        return None
    return _quantile_row(h)


class NoBackendError(UnavailableError):
    """No backend admitted the request within the retry budget (503)."""


class BackendUnavailableError(UnavailableError):
    """A backend could not be reached or died before answering: the request
    never ran, so the router may retry it elsewhere."""

    def __init__(self, reason, detail):
        super().__init__(f"backend unavailable ({reason}): {detail}")
        self.reason = reason


class BackendTimeoutError(UnavailableError):
    """The backend took the request but answered nothing within the budget.
    The work is dispatched (and may still run), so it is not retried: 504."""


class BackendState:
    """The router's view of one backend: rotation, the last probed
    ``/loadz`` signals, dispatch accounting. Mutated under the router's
    lock."""

    __slots__ = (
        "url", "kind", "in_rotation", "draining", "inflight",
        "queue_depth", "queue_capacity", "load", "mean_fill",
        "slot_occupancy", "compiles", "consecutive_failures",
        "admitted", "completed", "evictions", "last_probe_t",
        "last_error", "metrics", "metrics_t",
    )

    def __init__(self, url):
        self.url = url.rstrip("/")
        self.kind = None           # from /loadz
        self.in_rotation = False   # eligible for dispatch
        self.draining = False
        self.inflight = 0          # router-side outstanding requests
        self.queue_depth = 0
        self.queue_capacity = 0
        self.load = 0.0
        self.mean_fill = None
        self.slot_occupancy = None
        self.compiles = {}
        self.consecutive_failures = 0
        self.admitted = 0
        self.completed = 0
        self.evictions = 0
        self.last_probe_t = 0.0
        self.last_error = None
        # the last /metricz?format=snapshot scrape, /fleetz's feed
        self.metrics = {}
        self.metrics_t = 0.0

    def score(self) -> float:
        """The P2C key: router-side in-flight plus the probed queue depth."""
        return self.inflight + self.queue_depth

    def view(self) -> dict:
        return {
            "url": self.url, "kind": self.kind,
            "in_rotation": self.in_rotation, "draining": self.draining,
            "inflight": self.inflight, "queue_depth": self.queue_depth,
            "load": self.load, "mean_fill": self.mean_fill,
            "slot_occupancy": self.slot_occupancy,
            "compiles": self.compiles,
            "admitted": self.admitted, "completed": self.completed,
            "evictions": self.evictions,
            "last_error": self.last_error,
        }


class _RouterHandler(_BaseHandler):
    server_version = "ptt-router/1"

    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if self._get_common(path):
            return
        if path == "/fleetz":
            self._reply(200, self._srv.fleetz())
        elif path == "/":
            self._reply(200, {
                "service": "paddle_tpu_torch serving router",
                "routes": ["/predict (POST)", "/generate (POST)", "/fleetz", *_GET_ROUTES]})
        else:
            self._reply(404, {"error": f"unknown path {path!r}"})

    def do_POST(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        body = self._read_body()
        if body is None:
            return
        kind = _POST_KINDS.get(path)
        if kind is None:
            self._reply(404, {"error": f"unknown path {path!r}"})
            return
        with self._trace_request("serving::router"):
            _tracing.annotate(kind=kind)
            self._proxy(path, kind, body)

    def _proxy(self, path, kind, body):
        srv = self._srv
        if srv.draining:
            self._reply(503, {"error": "router draining"})
            return
        if kind == "generate" and srv.has_kind("prefill") and srv.has_kind("decode"):
            # a disaggregated fleet: both tiers live, or /generate keeps
            # going to unified backends
            self._proxy_disagg(body)
            return
        t0 = time.monotonic()
        try:
            backend, conn, resp = srv.dispatch(kind, path, body)
        except NoBackendError as e:
            self._reply(503, {"error": str(e)})
            return
        except BackendTimeoutError as e:
            self._reply(504, {"error": str(e)})
            return
        self._relay(srv, backend, conn, resp, t0)

    def _relay(self, srv, backend, conn, resp, t0):
        """Forward one dispatched backend response, streamed or buffered,
        with the died-mid-response handling and the finish bookkeeping."""
        status = resp.status
        try:
            if (resp.getheader("Transfer-Encoding") or "").lower() == "chunked":
                self._proxy_stream(resp, srv, backend)
            else:
                try:
                    data = resp.read()
                except _BACKEND_READ_ERRORS as e:
                    # dispatched (no retry), but the client gets an answer
                    status = 502
                    srv.note_backend_died(backend, "died_mid_response")
                    self._reply(502, {"error": "backend connection lost mid-response "
                                               f"({type(e).__name__})"})
                else:
                    self._reply_raw(status, data, resp.getheader("Content-Type"))
        finally:
            srv.finish(backend, t0, status, conn=conn, resp=resp)

    def _proxy_disagg(self, body):
        """Two-leg ``/generate``: the request to a prefill backend on the
        handoff budget, then its slab to a decode backend, whose answer
        (streamed or not) relays as a unified ``/generate``'s would. The
        prefill leg keeps the retry policy; a non-200 prefill answer passes
        through."""
        srv = self._srv
        t0 = time.monotonic()
        try:
            b1, conn1, resp1 = srv.dispatch("prefill", "/prefill", body,
                                            read_timeout=srv.handoff_timeout_s)
        except NoBackendError as e:
            self._reply(503, {"error": str(e)})
            return
        except BackendTimeoutError as e:
            self._reply(504, {"error": f"prefill handoff: {e}"})
            return
        status1 = resp1.status
        ctype1 = resp1.getheader("Content-Type")
        slab = None
        try:
            try:
                slab = resp1.read()
            except _BACKEND_READ_ERRORS as e:
                status1 = 502
                srv.note_backend_died(b1, "died_mid_response")
                self._reply(502, {"error": "prefill backend connection lost mid-slab "
                                           f"({type(e).__name__})"})
                return
        finally:
            srv.finish(b1, t0, status1, conn=conn1, resp=resp1)
        if status1 != 200:
            self._reply_raw(status1, slab, ctype1)
            return
        t1 = time.monotonic()
        try:
            b2, conn2, resp2 = srv.dispatch("decode", "/generate_kv", slab,
                                            content_type=HANDOFF_CONTENT_TYPE)
        except NoBackendError as e:
            self._reply(503, {"error": str(e)})
            return
        except BackendTimeoutError as e:
            self._reply(504, {"error": str(e)})
            return
        self._relay(srv, b2, conn2, resp2, t1)

    def _proxy_stream(self, resp, srv, backend):
        """Re-chunk a streamed backend answer to the client as it arrives
        (one ``read1`` a backend chunk: streaming survives the hop)."""
        self.send_response(resp.status)
        self.send_header("Content-Type",
                         resp.getheader("Content-Type") or "application/x-ndjson; charset=utf-8")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk_out(data):
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        try:
            while True:
                try:
                    chunk = resp.read1(65536)
                except _BACKEND_READ_ERRORS as e:
                    # the status line is gone: end the stream with an error
                    # line, not a dropped connection the client hangs on
                    srv.note_backend_died(backend, "died_mid_stream")
                    chunk_out(json.dumps({"error": "backend connection lost mid-stream "
                                                   f"({type(e).__name__})"}).encode() + b"\n")
                    break
                if not chunk:
                    break
                chunk_out(chunk)
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client went away; the backend read drains at close


class Router:
    """HTTP front door spreading traffic over registered backends.

    ``backends`` seeds the fleet (each probed and admitted when ready).
    ``port=0`` binds an ephemeral port. ``start()`` starts the listener and
    the prober; ``stop(drain=True)`` refuses new work, waits for the
    proxied requests in flight, and closes both.
    """

    def __init__(self, backends=(), port=0, host="127.0.0.1", probe_interval_s=None,
                 retries=None, connect_timeout_ms=None, request_timeout_s=None):
        self.probe_interval_s = float(probe_interval_s if probe_interval_s is not None
                                      else flag("serving_router_probe_interval_s"))
        self.retries = int(retries if retries is not None else flag("serving_router_retries"))
        if self.retries <= 0:
            raise InvalidArgumentError(f"router retry budget must be positive, got {self.retries}")
        self.connect_timeout_s = float(connect_timeout_ms if connect_timeout_ms is not None
                                       else flag("serving_router_connect_timeout_ms")) / 1e3
        self.request_timeout_s = float(request_timeout_s if request_timeout_s is not None
                                       else flag("serving_router_request_timeout_s"))
        # the prefill->slab leg's budget (the decode leg keeps the request's)
        self.handoff_timeout_s = float(flag("serving_handoff_timeout_s"))
        self._lock = threading.Lock()
        self._backends: dict[str, BackendState] = {}
        # keep-alive pools of idle router->backend connections per url: a
        # handshake and a handler thread per dispatch would cap the fleet
        self._pools: dict[str, list] = {}
        self._pool_max_idle = 32
        self._rng = random.Random(0xB0DE)
        self._m_requests = counter("serving/router_requests_total")
        self._m_retries = counter("serving/router_retries_total")
        self._m_evictions = counter("serving/router_evictions_total")
        self._m_readmissions = counter("serving/router_readmissions_total")
        self._m_no_backend = counter("serving/router_no_backend_total")
        self._m_healthy = gauge("serving/router_backends_healthy")
        self._h_e2e = histogram("serving/router_e2e_ms")
        self._httpd = _HTTPServer((host, int(port)), _RouterHandler)
        self._httpd.inference_server = self
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = None
        self._prober = None
        self._stop_probe = threading.Event()
        self._t0 = time.monotonic()
        self.draining = False
        self._stopped = False
        for url in backends:
            self.add_backend(url)
        from . import _register_live

        _register_live(self)

    # -- fleet membership ------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def ready(self) -> bool:
        return not self.draining and self.healthy_count > 0

    @property
    def healthy_count(self) -> int:
        with self._lock:
            return sum(b.in_rotation for b in self._backends.values())

    def has_kind(self, kind) -> bool:
        """Any in-rotation backend confirmed as ``kind``? (The switch of
        the disaggregated ``/generate``.)"""
        with self._lock:
            return any(b.in_rotation and b.kind == kind for b in self._backends.values())

    def backend_states(self) -> list:
        with self._lock:
            return list(self._backends.values())

    def add_backend(self, url, probe=True) -> BackendState:
        """Register a backend; with ``probe`` it is checked now and admitted
        if ready, else at the prober's next pass."""
        b = BackendState(url)
        with self._lock:
            existing = self._backends.get(b.url)
            if existing is not None:
                return existing
            self._backends[b.url] = b
        _flight.record_event("router_backend_added", url=b.url)
        if probe:
            self._probe_backend(b)
        return b

    def remove_backend(self, url) -> BackendState | None:
        """Drop a backend from the fleet (the caller drains and stops its
        process)."""
        with self._lock:
            b = self._backends.pop(url.rstrip("/"), None)
        self._pool_drop(url)
        if b is not None:
            _flight.record_event("router_backend_removed", url=b.url)
            self._update_healthy_gauge()
        return b

    def _update_healthy_gauge(self):
        self._m_healthy.set(self.healthy_count)

    def _evict(self, b: BackendState, reason: str):
        """Out of rotation at once; only a probe seeing ``/healthz`` ready
        brings it back."""
        with self._lock:
            was = b.in_rotation
            b.in_rotation = False
            b.evictions += was
            b.last_error = reason
        if was:
            self._pool_drop(b.url)
            self._m_evictions.inc()
            _flight.record_event("router_backend_evicted", url=b.url, reason=reason)
            self._update_healthy_gauge()

    def note_backend_died(self, b: BackendState, reason: str):
        """A dispatched request's connection died mid-response: the client
        has its 502, and the backend is evicted so the next requests go
        elsewhere."""
        self._evict(b, reason=reason)

    def _admit(self, b: BackendState):
        with self._lock:
            was = b.in_rotation
            b.in_rotation = True
            # /healthz readiness means not draining
            b.draining = False
            b.consecutive_failures = 0
            b.last_error = None
        if not was:
            if b.evictions:
                self._m_readmissions.inc()
                _flight.record_event("router_backend_readmitted", url=b.url)
            self._update_healthy_gauge()

    # -- backend HTTP ----------------------------------------------------------

    def _connect(self, b: BackendState, read_timeout=None) -> HTTPConnection:
        u = urlsplit(b.url)
        conn = HTTPConnection(u.hostname, u.port, timeout=self.connect_timeout_s)
        try:
            conn.connect()
        except OSError as e:
            conn.close()
            raise BackendUnavailableError("connect", str(e)) from None
        conn.sock.settimeout(read_timeout or self.request_timeout_s)
        return conn

    def _send(self, b: BackendState, method, path, body=None, read_timeout=None):
        """One request on a fresh connection: ``(conn, resp)``, the response
        unread. :class:`BackendUnavailableError` only when no response line
        arrived."""
        conn = self._connect(b, read_timeout=read_timeout)
        try:
            return conn, self._request_on(conn, method, path, body, read_timeout=read_timeout)
        except BackendTimeoutError:
            conn.close()
            raise
        except (ConnectionError, BadStatusLine, LineTooLong, OSError) as e:
            conn.close()
            raise BackendUnavailableError("no_response", f"{type(e).__name__}: {e}") from None

    def _pool_pop(self, b: BackendState):
        with self._lock:
            pool = self._pools.get(b.url)
            return pool.pop() if pool else None

    def _pool_push(self, b_url, conn):
        with self._lock:
            pool = self._pools.setdefault(b_url, [])
            if len(pool) < self._pool_max_idle:
                pool.append(conn)
                return
        conn.close()

    def _pool_drop(self, url):
        with self._lock:
            pool = self._pools.pop(url.rstrip("/"), [])
        for conn in pool:
            conn.close()

    def _dispatch_send(self, b: BackendState, path, body, content_type=None, read_timeout=None,
                       headers=None):
        """POST over a pooled keep-alive connection. A failure on a reused
        connection is tried once more on a fresh one (the backend may have
        closed the idle socket); only a fresh connection's failure raises
        the retriable :class:`BackendUnavailableError`."""
        conn = self._pool_pop(b)
        if conn is not None:
            try:
                return conn, self._request_on(conn, "POST", path, body,
                                              content_type=content_type,
                                              read_timeout=read_timeout, headers=headers)
            except BackendTimeoutError:
                conn.close()
                raise
            except (ConnectionError, BadStatusLine, LineTooLong, OSError):
                conn.close()  # a stale keep-alive: try a fresh one
        conn = self._connect(b)
        try:
            return conn, self._request_on(conn, "POST", path, body, content_type=content_type,
                                          read_timeout=read_timeout, headers=headers)
        except BackendTimeoutError:
            conn.close()
            raise
        except (ConnectionError, BadStatusLine, LineTooLong, OSError) as e:
            conn.close()
            raise BackendUnavailableError("no_response", f"{type(e).__name__}: {e}") from None

    def _request_on(self, conn, method, path, body, content_type=None, read_timeout=None,
                    headers=None):
        timeout = self.request_timeout_s if read_timeout is None else float(read_timeout)
        if conn.sock is not None:
            conn.sock.settimeout(timeout)  # a pooled connection keeps its last budget
        try:
            sent = {"Content-Type": content_type or "application/json"} if body else {}
            sent.update(headers or {})
            conn.request(method, path, body=body, headers=sent)
            return conn.getresponse()
        except socket.timeout:
            # sent, but nothing came back in time: dispatched work (504)
            raise BackendTimeoutError(f"backend gave no response within {timeout}s") from None

    def _get_json(self, b: BackendState, path):
        """A probe GET on a short budget of its own: ``(status, JSON or
        {})``."""
        conn, resp = self._send(b, "GET", path, read_timeout=min(5.0, self.request_timeout_s))
        try:
            data = resp.read()
        finally:
            conn.close()
        try:
            payload = json.loads(data) if data else {}
        except ValueError:
            payload = {}
        return resp.status, payload

    # -- dispatch --------------------------------------------------------------

    def _pick(self, kind, exclude) -> BackendState | None:
        """Power of two choices among in-rotation backends of ``kind``: two
        sampled, the lower score taken. Backends confirmed as ``kind`` win
        over unprobed ones (``kind is None``), which are eligible only when
        no confirmed one serves the kind."""
        with self._lock:
            pool = [b for b in self._backends.values()
                    if b.in_rotation and not b.draining and b.url not in exclude]
            cands = [b for b in pool if b.kind == kind]
            if not cands:
                cands = [b for b in pool if b.kind is None]
            if not cands:
                return None
            if len(cands) == 1:
                return cands[0]
            a, c = self._rng.sample(cands, 2)
            return min((a, c), key=lambda b: (b.score(), b.url))

    def dispatch(self, kind, path, body, content_type=None, read_timeout=None):
        """Pick and forward under the retry policy: ``(backend, conn,
        resp)``, the response unread so the handler can stream it; the
        handler must call :meth:`finish`. :class:`NoBackendError` after the
        retry budget."""
        tried: set = set()
        while len(tried) < self.retries:
            b = self._pick(kind, tried)
            if b is None:
                break
            tried.add(b.url)
            kind_known = b.kind is not None
            with self._lock:
                b.inflight += 1
                b.admitted += 1
            # an attempt span under the handler's router root, recorded
            # whatever the outcome; its context goes to the backend
            with _tracing.start_span("serving::attempt", backend=b.url,
                                     attempt=len(tried)) as asp:
                headers = ({_tracing.TRACEPARENT_HEADER: _tracing.format_traceparent(asp.context)}
                           if asp else None)
                try:
                    conn, resp = self._dispatch_send(b, path, body, content_type=content_type,
                                                     read_timeout=read_timeout, headers=headers)
                except BackendTimeoutError as e:
                    with self._lock:
                        b.inflight -= 1
                    asp.set_error(f"read timeout: {e}")
                    _tracing.flag_current_trace("timeout")
                    raise  # dispatched: 504, never retried
                except BackendUnavailableError as e:
                    with self._lock:
                        b.inflight -= 1
                    # never answered: evict it and retry on the next backend
                    asp.set_error(f"unavailable ({e.reason})")
                    _tracing.flag_current_trace("retry")
                    self._evict(b, reason=e.reason)
                    self._m_retries.inc()
                    _flight.record_event("router_retry", url=b.url, reason=e.reason, path=path)
                    continue
                if resp.status == 503:
                    # refused at admission (draining or not ready): not taken
                    try:
                        resp.read()
                    finally:
                        conn.close()
                    with self._lock:
                        b.inflight -= 1
                        b.draining = True
                    asp.set_attributes(status=503, refused=True)
                    _tracing.flag_current_trace("retry")
                    self._evict(b, reason="admission_503")
                    self._m_retries.inc()
                    _flight.record_event("router_retry", url=b.url, reason="admission_503",
                                         path=path)
                    continue
                if resp.status == 404 and not kind_known:
                    # an unprobed backend won the pick for a route it does not
                    # serve: learn its kind and pick again
                    try:
                        resp.read()
                    finally:
                        conn.close()
                    with self._lock:
                        b.inflight -= 1
                    asp.set_attributes(status=404, kind_mismatch=True)
                    _tracing.flag_current_trace("retry")
                    self._probe_backend(b)
                    self._m_retries.inc()
                    _flight.record_event("router_retry", url=b.url, reason="kind_mismatch",
                                         path=path)
                    continue
                asp.set_attributes(status=resp.status)
                return b, conn, resp
        self._m_no_backend.inc()
        _flight.record_event("router_no_backend", path=path, tried=sorted(tried))
        raise NoBackendError(f"no backend admitted the request (tried {len(tried)}, retry "
                             f"budget {self.retries})")

    def finish(self, b: BackendState, t0, status, conn=None, resp=None):
        with self._lock:
            b.inflight -= 1
            b.completed += 1
        self._m_requests.inc()
        self._h_e2e.observe((time.monotonic() - t0) * 1e3)
        if conn is None:
            return
        # only a fully read answer on a connection the backend keeps open
        # goes back to the pool: a half-read body would corrupt the next
        if resp is not None and resp.isclosed() and not resp.will_close and b.in_rotation:
            self._pool_push(b.url, conn)
        else:
            conn.close()

    # -- probing ---------------------------------------------------------------

    def _probe_backend(self, b: BackendState):
        """One probe: ``/healthz`` readiness gates rotation, ``/loadz``
        refreshes the dispatch signals and the kind, and
        ``/metricz?format=snapshot`` the ``/fleetz`` feed."""
        try:
            status, _ = self._get_json(b, "/healthz")
            if status != 200:
                raise BackendUnavailableError("not_ready", f"healthz {status}")
        except (BackendUnavailableError, BackendTimeoutError) as e:
            with self._lock:
                b.consecutive_failures += 1
            self._evict(b, reason=getattr(e, "reason", "probe_timeout"))
            b.last_probe_t = time.monotonic()
            return
        try:
            lz_status, lz = self._get_json(b, "/loadz")
            if lz_status == 200 and lz:
                with self._lock:
                    b.kind = lz.get("kind", b.kind)
                    b.queue_depth = int(lz.get("queue_depth", 0))
                    b.queue_capacity = int(lz.get("queue_capacity", 0))
                    b.load = float(lz.get("load", 0.0))
                    b.mean_fill = lz.get("mean_fill")
                    b.slot_occupancy = lz.get("slot_occupancy")
                    b.compiles = lz.get("compiles", {})
                    b.draining = bool(lz.get("draining", False))
                if b.draining:
                    self._evict(b, reason="draining")
                    return
            self._admit(b)
        except (BackendUnavailableError, BackendTimeoutError) as e:
            with self._lock:
                b.consecutive_failures += 1
            self._evict(b, reason=getattr(e, "reason", "probe_timeout"))
        finally:
            b.last_probe_t = time.monotonic()
        # a failed scrape keeps the previous snapshot: one period stale
        # merges fine, and rotation was decided above
        try:
            mz_status, mz = self._get_json(b, "/metricz?format=snapshot")
            if mz_status == 200 and isinstance(mz, dict):
                with self._lock:
                    b.metrics = mz.get("metrics") or {}
                    b.metrics_t = time.monotonic()
        except (BackendUnavailableError, BackendTimeoutError):
            pass

    def probe_once(self):
        for b in self.backend_states():
            self._probe_backend(b)

    def _probe_loop(self):
        while not self._stop_probe.wait(self.probe_interval_s):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — the prober must never die
                pass

    # -- lifecycle -------------------------------------------------------------

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            name=f"ptt-router:{self.port}", daemon=True)
            self._thread.start()
        if self._prober is None or not self._prober.is_alive():
            self._stop_probe.clear()
            self._prober = threading.Thread(target=self._probe_loop, name="ptt-router-prober",
                                            daemon=True)
            self._prober.start()
        _flight.record_event("router_start", port=self.port,
                             backends=[b.url for b in self.backend_states()])
        return self

    def stop(self, drain=True, timeout=10.0):
        """Refuse new work, wait out the proxied requests in flight when
        ``drain``, then close the prober and the listener. Backends are not
        stopped: the router owns no process."""
        if self._stopped:
            return
        self._stopped = True
        self.draining = True
        if drain:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    busy = sum(b.inflight for b in self._backends.values())
                if not busy:
                    break
                time.sleep(0.01)
        self._stop_probe.set()
        p = self._prober
        if p is not None:
            p.join(timeout=self.probe_interval_s + 1.0)
        self._prober = None
        t = self._thread
        if t is not None and t.is_alive():
            self._httpd.shutdown()  # returns only once serve_forever has run
        self._httpd.server_close()
        if t is not None:
            t.join(timeout=5)
        self._thread = None
        for url in list(self._pools):
            self._pool_drop(url)
        _flight.record_event("router_stop", port=self.port, drain=drain)

    # -- introspection ---------------------------------------------------------

    def merged_backend_quantiles(self, names=None) -> dict:
        """Fleet latency quantiles: every in-rotation backend's ``/histz``
        merged per histogram name (exact: summed buckets are the pooled
        histogram). ``{name: {p50_ms, p99_ms, count, backends}}``."""
        per_name: dict[str, list] = {}
        for b in self.backend_states():
            if not b.in_rotation:
                continue
            try:
                status, payload = self._get_json(b, "/histz")
            except (BackendUnavailableError, BackendTimeoutError):
                continue
            if status != 200:
                continue
            for name, snap in payload.get("histograms", {}).items():
                if names is not None and name not in names:
                    continue
                per_name.setdefault(name, []).append(snap)
        out = {}
        for name, snaps in per_name.items():
            row = _quantile_row(merge_histogram_snapshots(snaps, name=name))
            if row is None:
                continue
            row["backends"] = len(snaps)
            out[name] = row
        return out

    def fleetz(self) -> dict:
        """``GET /fleetz``: per backend kind, per ``serving/*`` histogram,
        the exact merge of every in-rotation backend's last scraped
        snapshot, with quantiles per labeled series. Empty series are left
        out. No backend I/O: the prober scraped them."""
        groups: dict = {}
        scraped = 0
        for b in self.backend_states():
            if not b.in_rotation or not b.metrics:
                continue
            scraped += 1
            kind = b.kind or "unknown"
            for name, snap in b.metrics.items():
                if (not isinstance(snap, dict) or snap.get("kind") != "histogram"
                        or not name.startswith("serving/")):
                    continue
                groups.setdefault(kind, {}).setdefault(name, []).append(snap)
        fleet: dict = {}
        for kind, per_name in groups.items():
            for name, snaps in per_name.items():
                try:
                    merged = merge_histogram_snapshots(snaps, name=name)
                except ValueError:
                    continue  # mixed bucket ladders: skipped, not a 500
                row = _quantile_row(merged)
                if row is None:
                    continue
                row["backends"] = len(snaps)
                series = {}
                for sel, child in sorted(merged.series().items()):
                    srow = _quantile_row(child)
                    if srow is not None:
                        series[sel] = srow
                if series:
                    row["series"] = series
                fleet.setdefault(kind, {})[name] = row
        return {"backends_scraped": scraped, "fleet": fleet}

    def healthz(self) -> dict:
        return {
            "ready": self.ready,
            "draining": self.draining,
            "backends_total": len(self._backends),
            "backends_healthy": self.healthy_count,
            "uptime_s": round(time.monotonic() - self._t0, 3),
        }

    def loadz(self) -> dict:
        """The backend load schema, so routers stack: queue depth is the
        fleet's probed depths plus the router's in-flight requests."""
        states = self.backend_states()
        depth = sum(b.queue_depth + b.inflight for b in states if b.in_rotation)
        cap = sum(b.queue_capacity for b in states if b.in_rotation)
        return {
            "schema": LOADZ_SCHEMA_VERSION,
            "kind": "router",
            "ready": self.ready,
            "draining": self.draining,
            "queue_depth": depth,
            "queue_capacity": cap,
            "load": round(depth / cap, 4) if cap else 0.0,
            "mean_fill": None,
            "slot_occupancy": None,
            "compiles": {"expected": 0, "unexpected": 0, "jit_misses": 0},
        }

    def statz(self) -> dict:
        states = self.backend_states()
        scores = {b.url: 1.0 / (1.0 + b.score()) for b in states if b.in_rotation}
        total_w = sum(scores.values()) or 1.0
        backends = []
        for b in states:
            v = b.view()
            v["weight"] = round(scores.get(b.url, 0.0) / total_w, 4)
            backends.append(v)
        return {
            **self.healthz(),
            "backends": backends,
            # the process registry's counters, as the JAX router's
            "fleet": {
                "requests": self._m_requests.value,
                "retries": self._m_retries.value,
                "evictions": self._m_evictions.value,
                "readmissions": self._m_readmissions.value,
                "no_backend_503": self._m_no_backend.value,
            },
            "latency": {
                "router_e2e": _registry_quantiles("serving/router_e2e_ms"),
                "backends_merged": self.merged_backend_quantiles(),
            },
        }


# ---------------------------------------------------------------------------
# process entry point
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    """``python -m paddle_tpu_torch.serving.router``: the router as its own
    process over a static backend list (the port announced through
    ``--port-file``; SIGTERM drains)."""
    import argparse
    import os
    import signal

    p = argparse.ArgumentParser(prog="paddle_tpu_torch.serving.router",
                                description="serving-fleet router process")
    p.add_argument("--backend", action="append", default=[],
                   help="backend base URL (repeatable)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--port-file", default="")
    p.add_argument("--probe-interval-s", type=float, default=None)
    p.add_argument("--retries", type=int, default=None)
    args = p.parse_args(argv)

    from ..monitor import slo as _slo

    _slo.install_from_flags()
    router = Router(backends=args.backend, host=args.host, port=args.port,
                    probe_interval_s=args.probe_interval_s, retries=args.retries).start()
    if args.port_file:
        from .backend import _announce_port

        _announce_port(args.port_file, router.port)
    print(f"serving router ready on {router.url} ({len(args.backend)} backends, "
          f"pid={os.getpid()})", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda s, f: stop.set())
    signal.signal(signal.SIGINT, lambda s, f: stop.set())
    stop.wait()
    router.stop(drain=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
