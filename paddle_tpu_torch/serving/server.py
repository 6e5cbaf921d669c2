"""HTTP frontends for online serving (``paddle_tpu/serving/server.py``).

Stdlib ``ThreadingHTTPServer``s. :class:`InferenceServer` exposes:

- ``POST /predict`` — JSON ``{"inputs": {feed: nested list}, "deadline_ms":
  optional, "tenant": optional}`` through the dynamic batcher; answers
  ``{"outputs": {fetch: nested list}, "rows": n}``. **429** queue full,
  **504** deadline passed in the queue, **400** malformed request, **503**
  draining or not ready.
- ``GET /healthz`` — readiness: 200 once every bucket has run (warmup) and
  the server is not draining; 503 otherwise.
- ``GET /statz`` — queue depth, batch fill, request counters, the kernel
  launch counts and ``compiles``: the buckets and the unexpected graph
  captures after warmup.

Both servers also serve the fleet's machine-oriented routes, which the
router (:mod:`~paddle_tpu_torch.serving.router`) probes and merges:

- ``GET /loadz`` — the load signal of :data:`LOADZ_SCHEMA_VERSION`, the
  JAX package's keys exactly.
- ``GET /histz`` — snapshots of every ``serving/*`` histogram of the
  process registry (bounds, per-bucket counts, sum, count), which merge
  exactly across backends of either package.
- ``GET /metrics`` — the registry as Prometheus text; ``GET /metricz`` the
  same, or ``{"metrics": registry_snapshot()}`` with ``?format=snapshot``
  (what the router's prober scrapes for ``/fleetz``).

:class:`GenerationServer` (``:740-1358``) serves a causal LM through a
:class:`~paddle_tpu_torch.serving.continuous.ContinuousBatcher` over a
:class:`~paddle_tpu_torch.generation.GenerationEngine`:

- ``POST /generate`` — JSON ``{"prompt": [ids], "max_new_tokens",
  "temperature", "deadline_ms", "stream", "tenant"}`` (all but the prompt
  optional); answers ``{"tokens", "finish_reason", "prompt_tokens"}``, or
  with ``"stream": true`` chunked ndjson, one ``{"token": id}`` line a
  decoded token and a final ``{"done": true, ...}``; the statuses of
  ``/predict``.
- ``GET /healthz`` (with the KV layout), ``GET /`` and ``GET /statz``
  (requests, tokens/s, slot occupancy, latency quantiles, the KV cache's
  bytes, ``speculative``: the acceptance accounting, ``paging``: the page
  pool and the prefix index under the paged layout, and ``compiles``: the
  graphs and the unexpected captures after warmup).

Its ``kind`` is the backend's role in a disaggregated fleet: ``generate``
serves ``/generate``; ``prefill`` serves ``POST /prefill`` (the ``/generate``
body, answered with the ``PTKV`` slab, or ``PTKP`` pages when the body says
``"page_format": true``, the request's parameters riding in the header);
``decode`` serves ``POST /generate_kv`` (the slab's bytes, either format,
answered as ``/generate`` answers, streamed when the request asked). A path
of another kind answers 404 naming the kind. Every kind serves ``POST
/prefix_known`` (``{"hashes": [...]}`` -> the ones its prefix index holds).

A prefill tier admits 4 exports at once, as the JAX tier does: the
engine's lock serializes the device forward and the copy to the host, and
the admitted exports pack their slabs and answer concurrently.

Both kinds also serve the monitor's endpoints: ``GET /tracez`` (the
tail-sampled request traces; an incoming ``traceparent`` header parents a
request's span tree under the caller's), ``/profilez`` (opprof), ``/sloz``
(objectives and burn), ``/costz`` (the counted cost of each captured step,
the card's peaks) and ``/goodputz``.

``stop(drain=True)`` refuses new work (503), flushes what is queued, answers
the waiting handlers, then closes.
"""
from __future__ import annotations

import json
import queue as _queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..errors import InvalidArgumentError
from ..flags import flag
from ..generation import handoff as _handoff
from ..monitor import (
    PROMETHEUS_CONTENT_TYPE,
    all_metrics,
    counter,
    prometheus_text,
    registry_snapshot,
)
from ..monitor import cost_model as _cost
from ..monitor import goodput as _goodput
from ..monitor import opprof as _opprof
from ..monitor import slo as _slo
from ..monitor import tracing as _tracing
from ..ops.cuda import launch_counts
from .batcher import DeadlineExceededError, DynamicBatcher, QueueFullError, ServingClosedError
from .continuous import ContinuousBatcher
from .replica import ReplicaPool

__all__ = ["InferenceServer", "GenerationServer", "LOADZ_SCHEMA_VERSION"]

#: The load-signal schema of ``GET /loadz`` (``paddle_tpu/serving/server.py``),
#: which the router probes instead of ``/statz``. Fields are only ever
#: added, and an addition bumps the version. Every backend kind serves
#: exactly these keys:
#:
#: - ``schema``      int   — schema version (currently 1)
#: - ``kind``        str   — "predict" | "generate" | "prefill" | "decode"
#:                            (the routes the router may send here)
#: - ``ready``       bool  — warmed AND not draining (admission works)
#: - ``draining``    bool  — shutdown in progress; admissions get 503
#: - ``queue_depth`` int   — requests waiting for a batch, a slot or an
#:                            export
#: - ``queue_capacity`` int
#: - ``load``        float — queue_depth / queue_capacity
#: - ``mean_fill``   float|None — predict: batch-slot utilization
#: - ``slot_occupancy`` float|None — generation kinds: busy share of the
#:                            decode slots, or of a prefill tier's exports
#: - ``compiles``    {"expected": int, "unexpected": int,
#:                    "jit_misses": int} — per-process graph accounting
LOADZ_SCHEMA_VERSION = 1

#: exports a prefill tier admits at once (``paddle_tpu/serving/server.py``)
PREFILL_CONCURRENCY = 4


def _histz_payload() -> dict:
    """``GET /histz``: the snapshot of every ``serving/*`` histogram of this
    process, the feed of the router's exact cross-backend quantiles."""
    return {"histograms": {name: m.snapshot() for name, m in all_metrics().items()
                           if m.kind == "histogram" and name.startswith("serving/")}}


#: the GET routes both server kinds serve
_GET_ROUTES = ["/healthz", "/statz", "/loadz", "/histz", "/metrics", "/metricz", "/tracez",
               "/profilez", "/sloz", "/costz", "/goodputz"]


class _HTTPServer(ThreadingHTTPServer):
    # the stdlib backlog of 5 refuses connections under a burst; refusals
    # belong to the bounded admission queue (429)
    request_queue_size = 128
    daemon_threads = True


class _BaseHandler(BaseHTTPRequestHandler):
    """JSON replies, a drained body, and the admission statuses both
    frontends share."""

    server_version = "ptt-serving/1"
    protocol_version = "HTTP/1.1"  # every reply has a Content-Length (or is chunked)
    # a reply is written as headers, then body: with Nagle's algorithm on, the
    # body waits for the peer's delayed ACK of the headers (tens of ms a
    # reply on a kept-alive connection, as the router's to its backends are)
    disable_nagle_algorithm = True

    def log_message(self, *args):  # no per-request stderr lines
        pass

    @property
    def _srv(self):
        return self.server.inference_server

    def _reply(self, status, payload, ctype="application/json"):
        # the status lands on the current request span (>= 500 marks the
        # trace errored, so the tail sampler keeps it)
        _tracing.note_status(status)
        body = payload if isinstance(payload, str) else json.dumps(payload, default=str)
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", f"{ctype}; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _reply_raw(self, status, data, ctype):
        _tracing.note_status(status)
        self.send_response(status)
        self.send_header("Content-Type", ctype or "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _read_body(self):
        """The POST body, read (drained) before any reply: unread bytes on a
        keep-alive connection would parse as the next request. None after
        answering 400 to a malformed Content-Length."""
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            self.close_connection = True
            self._reply(400, {"error": "malformed Content-Length"})
            return None
        return self.rfile.read(length) if length > 0 else b"{}"

    def _trace_request(self, name):
        """This request's local trace root; an incoming ``traceparent``
        (the router's attempt span) parents it under the caller's."""
        parent = _tracing.parse_traceparent(self.headers.get(_tracing.TRACEPARENT_HEADER))
        return _tracing.start_trace(name, parent=parent, client=self.client_address[0])

    def _check_ready(self, srv) -> bool:
        if not srv.ready:
            self._reply(503, {"error": "draining" if srv.draining else "not ready"})
            return False
        return True

    def _get_common(self, path) -> bool:
        """Serve the GET routes every server and the router share; True
        when ``path`` was one of them."""
        srv = self._srv
        if path == "/healthz":
            self._reply(200 if srv.ready else 503, srv.healthz())
        elif path == "/statz":
            self._reply(200, srv.statz())
        elif path == "/loadz":
            self._reply(200, srv.loadz())
        elif path == "/histz":
            self._reply(200, _histz_payload())
        elif path == "/tracez":
            self._reply(*_tracing.tracez_payload(_tracing.parse_query(self.path)))
        elif path == "/profilez":
            self._reply(*_opprof.profilez_payload(_tracing.parse_query(self.path)))
        elif path == "/sloz":
            self._reply(200, _slo.sloz_payload())
        elif path == "/costz":
            self._reply(200, _cost.costz_payload())
        elif path == "/goodputz":
            self._reply(200, _goodput.goodputz_payload())
        elif path == "/metrics":
            self._reply(200, prometheus_text(), PROMETHEUS_CONTENT_TYPE)
        elif path == "/metricz":
            # Prometheus text by default; the snapshot is the router's feed
            query = parse_qs(urlsplit(self.path).query)
            if query.get("format", [""])[-1] == "snapshot":
                self._reply(200, {"metrics": registry_snapshot()})
            else:
                self._reply_raw(200, prometheus_text().encode("utf-8"), PROMETHEUS_CONTENT_TYPE)
        else:
            return False
        return True

    def _try_submit(self, fn):
        """Run an admission call, mapping the backpressure contract onto
        statuses: full queue 429, draining/closed 503, malformed 400. The
        submitted request, or None after replying with the error."""
        try:
            return fn()
        except QueueFullError as e:
            self._reply(429, {"error": str(e)})
        except ServingClosedError as e:
            self._reply(503, {"error": str(e)})
        except InvalidArgumentError as e:
            self._reply(400, {"error": str(e)})
        return None


class _ServingHandler(_BaseHandler):
    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if self._get_common(path):
            return
        if path == "/":
            self._reply(200, {"service": "paddle_tpu_torch serving",
                              "routes": ["/predict (POST)", *_GET_ROUTES]})
        else:
            self._reply(404, {"error": f"unknown path {path!r}"})

    def do_POST(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        raw = self._read_body()
        if raw is None:
            return
        if path != "/predict":
            self._reply(404, {"error": f"unknown path {path!r}"})
            return
        with self._trace_request("serving::predict"):
            self._predict(raw)

    def _predict(self, raw):
        srv = self._srv
        if not self._check_ready(srv):
            return
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise InvalidArgumentError(
                    'request body must be a JSON object with an "inputs" key')
            inputs = self._parse_inputs(body)
            deadline_ms = body.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = float(deadline_ms)
            tenant = body.get("tenant")
        except (ValueError, TypeError, InvalidArgumentError) as e:
            self._reply(400, {"error": str(e)})
            return
        req = self._try_submit(lambda: srv.batcher.submit(inputs, deadline_ms=deadline_ms,
                                                          tenant=tenant))
        if req is None:
            return
        try:
            outs = req.wait(srv.request_timeout_s)
        except DeadlineExceededError as e:
            self._reply(504, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — a failed batch must still answer
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, {"outputs": {n: o.tolist() for n, o in zip(srv.fetch_names, outs)},
                          "rows": int(req.rows)})

    def _parse_inputs(self, body) -> dict:
        srv = self._srv
        raw = body.get("inputs")
        if raw is None:
            raise InvalidArgumentError('request body needs an "inputs" key')
        if not isinstance(raw, dict):  # a bare list feeds a single-input model
            if len(srv.feed_names) != 1:
                raise InvalidArgumentError(
                    f'"inputs" must be a dict naming the feeds {srv.feed_names}')
            raw = {srv.feed_names[0]: raw}
        parsed = {}
        for name, val in raw.items():
            spec = srv.input_specs.get(name)
            dtype = spec[1] if spec else None
            try:
                parsed[name] = np.asarray(val, dtype=dtype)
            except (ValueError, TypeError) as e:
                raise InvalidArgumentError(
                    f"input {name!r} is not a well-formed {dtype} array: {e}") from None
        return parsed


class InferenceServer:
    """HTTP frontend -> :class:`DynamicBatcher` -> :class:`ReplicaPool` over
    one Predictor.

    ``port=0`` binds an ephemeral port. ``start()`` warms every bucket by
    default, so ``/healthz`` turns 200 only when the server is ready; pass
    ``warmup=False`` and call :meth:`warmup` later to watch the gate.
    """

    def __init__(self, predictor, port=0, host="127.0.0.1", replicas=None, buckets=None,
                 queue_capacity=None, batch_timeout_ms=None, request_timeout_s=600.0):
        self.feed_names = list(predictor.get_input_names())
        self.fetch_names = list(predictor.get_output_names())
        self.batcher = DynamicBatcher(self.feed_names, buckets=buckets,
                                      queue_capacity=queue_capacity,
                                      batch_timeout_ms=batch_timeout_ms)
        self.pool = ReplicaPool(predictor, self.batcher, replicas=replicas)
        self.input_specs = self.pool._specs
        self.request_timeout_s = request_timeout_s
        self._httpd = _HTTPServer((host, int(port)), _ServingHandler)
        self._httpd.inference_server = self
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = None
        self._t0 = time.monotonic()
        self.draining = False
        self._stopped = False
        from . import _register_live

        _register_live(self)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def ready(self) -> bool:
        return self.pool.warmed and not self.draining

    def start(self, warmup=True):
        """Start the replica workers and the listener; warm every bucket
        unless ``warmup=False``."""
        self.pool.start()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            name=f"ptt-serving:{self.port}", daemon=True)
            self._thread.start()
        if warmup:
            self.warmup()
        return self

    def warmup(self):
        self.pool.warmup()
        return self

    def stop(self, drain=True, timeout=60.0):
        """Refuse new work (503), flush queued work when ``drain``, close."""
        if self._stopped:
            return
        self._stopped = True
        self.draining = True
        self.pool.stop(drain=drain, timeout=timeout)
        t = self._thread
        if t is not None and t.is_alive():
            self._httpd.shutdown()  # returns only once serve_forever has run
        self._httpd.server_close()
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    def healthz(self) -> dict:
        return {
            "ready": self.ready,
            "warmed": self.pool.warmed,
            "draining": self.draining,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "buckets": list(self.batcher.buckets),
            "replicas": self.pool.replicas,
            "queue_depth": self.batcher.queue_depth(),
            "queue_capacity": self.batcher.queue_capacity,
        }

    def loadz(self) -> dict:
        """The router's load signal (:data:`LOADZ_SCHEMA_VERSION`), from
        counter reads alone. ``compiles``: ``expected`` the buckets,
        ``unexpected`` the graph captures after warmup
        (``serving/unexpected_compiles``), ``jit_misses`` every capture of
        the predictor's store, the port's analog of the JAX package's jit
        misses (the CPU captures none)."""
        rows = counter("serving/batched_rows_total").value
        slots = counter("serving/batch_slots_total").value
        depth = self.batcher.queue_depth()
        return {
            "schema": LOADZ_SCHEMA_VERSION,
            "kind": "predict",
            "ready": self.ready,
            "draining": self.draining,
            "queue_depth": depth,
            "queue_capacity": self.batcher.queue_capacity,
            "load": round(depth / self.batcher.queue_capacity, 4),
            "mean_fill": round(rows / slots, 4) if slots else None,
            "slot_occupancy": None,
            "compiles": {"expected": len(self.batcher.buckets),
                         "unexpected": counter("serving/unexpected_compiles").value,
                         "jit_misses": self.pool.captures()},
        }

    def statz(self) -> dict:
        s = dict(self.batcher.stats)
        return {
            **self.healthz(),
            "requests": {"submitted": s["requests"], "completed": s["responses"],
                         "rejected_429": s["rejected"], "deadline_expired": s["expired"],
                         "errors": s["errors"]},
            "batches": {"dispatched": s["batches"], "rows": s["rows"],
                        "padded_rows": s["slots"] - s["rows"],
                        "mean_fill": round(s["rows"] / s["slots"], 4) if s["slots"] else 0.0,
                        "last_fill": round(s["last_fill"], 4)},
            "compiles": {"buckets": len(self.batcher.buckets),
                         "unexpected": self.pool.unexpected_compiles()},
            "kernel_launches": launch_counts(),
        }


#: the one POST path each backend kind serves (a slab meant for a decode tier
#: sent to a generate tier, or the reverse, answers 404 naming the kind)
_KIND_ROUTES = {"generate": "/generate", "prefill": "/prefill", "decode": "/generate_kv"}


class _GenerationHandler(_BaseHandler):
    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        srv = self._srv
        if self._get_common(path):
            return
        if path == "/":
            self._reply(200, {"service": "paddle_tpu_torch generation", "kind": srv.kind,
                              "routes": [f"{_KIND_ROUTES[srv.kind]} (POST)",
                                         "/prefix_known (POST)", *_GET_ROUTES]})
        else:
            self._reply(404, {"error": f"unknown path {path!r}"})

    def do_POST(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        raw = self._read_body()
        if raw is None:
            return
        if path == "/prefix_known":
            self._prefix_known(raw)
        elif path != _KIND_ROUTES[self._srv.kind]:
            self._reply(404, {"error": f"unknown path {path!r} (this backend's kind is "
                                       f"{self._srv.kind!r})"})
        elif path == "/generate":
            with self._trace_request("serving::generate"):
                self._generate(raw)
        elif path == "/prefill":
            with self._trace_request("serving::prefill"):
                self._prefill(raw)
        else:
            with self._trace_request("serving::generate_kv"):
                self._generate_kv(raw)

    def _prefix_known(self, raw):
        """``{"hashes": [...]}`` -> ``{"known": [...], "layout"}``: the chain
        hashes this backend's prefix index holds (none on the ring), so a
        prefill tier ships those pages header-only."""
        try:
            body = json.loads(raw or b"{}")
            hashes = [str(h) for h in (body.get("hashes") or [])]
        except (ValueError, TypeError, AttributeError) as e:
            self._reply(400, {"error": f"malformed body: {e}"})
            return
        eng = self._srv.engine
        self._reply(200, {"known": sorted(eng.known_page_hashes(hashes)),
                          "layout": eng.kv_cache_layout})

    @staticmethod
    def _parse_gen_body(raw) -> dict:
        """The ``/generate`` (and ``/prefill``) JSON body's parameters;
        raises on malformed input (400)."""
        body = json.loads(raw or b"{}")
        if not isinstance(body, dict):
            raise InvalidArgumentError('request body must be a JSON object with a "prompt" key')
        prompt = body.get("prompt")
        if (not isinstance(prompt, (list, tuple)) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            raise InvalidArgumentError('"prompt" must be a non-empty list of token ids (ints)')
        max_new = body.get("max_new_tokens")
        temperature = body.get("temperature")
        deadline_ms = body.get("deadline_ms")
        return {
            "prompt": list(prompt),
            "max_new_tokens": int(max_new) if max_new is not None else None,
            "temperature": float(temperature) if temperature is not None else None,
            "deadline_ms": float(deadline_ms) if deadline_ms is not None else None,
            "stream": bool(body.get("stream", False)),
            "tenant": str(body["tenant"]) if body.get("tenant") is not None else None,
            "page_format": bool(body.get("page_format", False)),
            "known_hashes": [str(h) for h in (body.get("known_hashes") or [])],
        }

    def _wait_and_reply(self, srv, req):
        """Block on a submitted request and answer ``{"tokens",
        "finish_reason", "prompt_tokens"}`` (504 past its deadline, 500 on
        a failed step)."""
        try:
            tokens = req.wait(srv.request_timeout_s)
        except DeadlineExceededError as e:
            self._reply(504, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — a failed step must still answer
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, {"tokens": tokens, "finish_reason": req.finish_reason,
                          "prompt_tokens": req.prompt_len})

    def _generate(self, raw):
        srv = self._srv
        if not self._check_ready(srv):
            return
        try:
            p = self._parse_gen_body(raw)
        except (ValueError, TypeError, InvalidArgumentError) as e:
            self._reply(400, {"error": str(e)})
            return

        def submit(**kw):
            return srv.scheduler.submit(p["prompt"], max_new_tokens=p["max_new_tokens"],
                                        temperature=p["temperature"],
                                        deadline_ms=p["deadline_ms"], tenant=p["tenant"], **kw)

        if p["stream"]:
            self._generate_stream(srv, submit)
            return
        req = self._try_submit(submit)
        if req is not None:
            self._wait_and_reply(srv, req)

    def _prefill(self, raw):
        """The prefill tier's leg: the bucketed forward, answered with the
        slab (``PTKV``; ``PTKP`` pages with ``"page_format": true``, the
        pages in ``"known_hashes"`` header-only). The request's generation
        parameters, the prompt among them, and this tier's cache geometry
        ride in the header, so the bytes can go on to a decode tier
        unparsed."""
        srv = self._srv
        if not self._check_ready(srv):
            return
        try:
            p = self._parse_gen_body(raw)
            if p["page_format"] and not srv.engine.paged:
                raise InvalidArgumentError("page_format needs kv_cache_layout=paged on the "
                                           "prefill tier")
            srv.engine.validate(p["prompt"], p["max_new_tokens"]
                                if p["max_new_tokens"] is not None
                                else srv.engine.default_max_new_tokens)
        except (ValueError, TypeError, InvalidArgumentError) as e:
            self._reply(400, {"error": str(e)})
            return
        meta = {"params": {k: p[k] for k in ("prompt", "max_new_tokens", "temperature",
                                             "deadline_ms", "stream", "tenant")},
                "cache": srv.cache_geometry()}
        try:
            if p["page_format"]:
                pages, length, first = srv.run_prefill_pages(p["prompt"], p["temperature"],
                                                             known_hashes=p["known_hashes"])
                blob = _handoff.pack_kv_pages(pages, length, first, srv.engine.page_size,
                                              meta=meta)
                ctype = _handoff.HANDOFF_PAGED_CONTENT_TYPE
            else:
                planes, length, first = srv.run_prefill(p["prompt"], p["temperature"])
                blob = _handoff.pack_kv_slab(planes, length, first, meta=meta)
                ctype = _handoff.HANDOFF_CONTENT_TYPE
        except ServingClosedError as e:
            self._reply(503, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — a failed forward must still answer
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply_raw(200, blob, ctype)

    def _generate_kv(self, raw):
        """The decode tier's leg: a handed-off slab (``PTKV`` or ``PTKP``,
        told apart by magic) checked against this tier's cache geometry
        and queued for a decode slot; the slab's riding parameters rebuild
        the original request, streaming included. A malformed or foreign
        slab answers 400 before anything lands in a slot."""
        srv = self._srv
        if not self._check_ready(srv):
            return
        eng = srv.engine
        paged_wire = raw[:4] == b"PTKP"
        try:
            if paged_wire:
                if not eng.paged:
                    raise _handoff.HandoffError("page-granular slab needs kv_cache_layout=paged "
                                                "on this decode tier (ring tiers speak PTKV)")
                slab = _handoff.unpack_kv_pages(raw)
                length, meta = slab.length, slab.meta
                if slab.page_size != eng.page_size:
                    raise _handoff.HandoffError(f"KV page slab page_size {slab.page_size} does "
                                                f"not match this tier's {eng.page_size}")
            else:
                planes, length, first, meta = _handoff.unpack_kv_slab(raw)
            mine = srv.cache_geometry()
            theirs = meta.get("cache") or {}
            bad = {k: (theirs.get(k), mine[k]) for k in mine if theirs.get(k) != mine[k]}
            if bad:
                raise _handoff.HandoffError(f"KV slab geometry does not match this decode "
                                            f"tier: {bad} (sender vs receiver)")
            if eng.speculative:
                # the draft's prefill at admission needs a covering bucket
                # here: refuse now, not out of the decode loop
                eng.bucket_for(length)
        except InvalidArgumentError as e:  # HandoffError among them
            self._reply(400, {"error": str(e)})
            return
        p = dict(meta.get("params") or {})
        kw = {"max_new_tokens": p.get("max_new_tokens"), "temperature": p.get("temperature"),
              "deadline_ms": p.get("deadline_ms"), "prompt": p.get("prompt"),
              "tenant": p.get("tenant")}
        if paged_wire:
            def submit(**extra):
                return srv.scheduler.submit_prefilled_pages(slab, **kw, **extra)
        else:
            def submit(**extra):
                return srv.scheduler.submit_prefilled(planes, length, first, **kw, **extra)
        if bool(p.get("stream", False)):
            self._generate_stream(srv, submit)
            return
        req = self._try_submit(submit)
        if req is not None:
            self._wait_and_reply(srv, req)

    def _generate_stream(self, srv, submit):
        """Chunked ndjson: one ``{"token": id}`` line per decoded token as
        the scheduler's ``on_token`` delivers it, then ``{"done": true,
        "tokens", "finish_reason", "prompt_tokens"}`` (or ``{"error"}``)."""
        q = _queue.Queue()
        req = self._try_submit(lambda: submit(on_token=q.put))
        if req is None:
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson; charset=utf-8")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj):
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        t_end = time.monotonic() + srv.request_timeout_s
        try:
            while True:
                try:
                    chunk({"token": q.get(timeout=0.1)})
                    continue
                except _queue.Empty:
                    pass
                if req.finished or time.monotonic() > t_end:
                    break
            while not q.empty():  # tokens that landed between the poll and the finish
                chunk({"token": q.get_nowait()})
            if req.error is not None:
                chunk({"error": f"{type(req.error).__name__}: {req.error}"})
            elif not req.finished:
                chunk({"error": "stream timeout"})
            else:
                chunk({"done": True, "tokens": req.tokens, "finish_reason": req.finish_reason,
                       "prompt_tokens": req.prompt_len})
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client went away; decoding goes on
        finally:
            req.on_token = None  # a still-decoding request stops feeding the queue


class GenerationServer:
    """HTTP frontend -> :class:`ContinuousBatcher` -> :class:`GenerationEngine`
    over a causal LM.

    ``model_or_engine`` is a ready engine or a causal LM (a
    ``GPTForCausalLM``), for which an engine is built from the
    ``generation_*`` flags and the keyword overrides (on ``device``, the
    card unless named; ``kv_cache_dtype``, ``kv_cache_layout``,
    ``kv_page_size`` and ``kv_pool_pages`` pick the int8 and paged caches;
    ``draft_model`` and ``draft_k`` speculative decoding). ``start()`` warms
    by default, so ``/healthz`` readiness means every graph of the kind is
    captured.

    ``kind`` is the backend's role: ``generate`` serves ``/generate``;
    ``prefill`` serves ``/prefill``, runs no decode loop and holds no decode
    cache after warmup; ``decode`` serves ``/generate_kv``. Each warms
    exactly ``engine.expected_compiles(kind)`` graphs. A prefill tier admits
    :data:`PREFILL_CONCURRENCY` exports at once; the engine's lock runs
    their forwards and copies to the host one at a time (they write one
    persistent buffer), and the admitted ones pack and answer concurrently.
    ``/statz`` ``prefill`` and ``/loadz`` count the waiting and the
    admitted."""

    def __init__(self, model_or_engine, port=0, host="127.0.0.1", slots=None, cache_len=None,
                 prefill_buckets=None, queue_capacity=None, max_new_tokens=None,
                 temperature=None, top_k=None, kv_cache_dtype=None, kv_cache_layout=None,
                 kv_page_size=None, kv_pool_pages=None, draft_model=None, draft_k=None,
                 kind=None, request_timeout_s=120.0, device=None):
        self.kind = str(kind if kind is not None else flag("backend_kind"))
        if self.kind not in _KIND_ROUTES:
            raise InvalidArgumentError(f"backend kind must be one of {sorted(_KIND_ROUTES)}, "
                                       f"got {self.kind!r}")
        if hasattr(model_or_engine, "step") and hasattr(model_or_engine, "admit"):
            given = {"slots": slots, "cache_len": cache_len, "prefill_buckets": prefill_buckets,
                     "max_new_tokens": max_new_tokens, "temperature": temperature,
                     "top_k": top_k, "kv_cache_dtype": kv_cache_dtype,
                     "kv_cache_layout": kv_cache_layout, "kv_page_size": kv_page_size,
                     "kv_pool_pages": kv_pool_pages, "draft_model": draft_model,
                     "draft_k": draft_k, "device": device}
            bad = sorted(k for k, v in given.items() if v is not None)
            if bad:
                raise InvalidArgumentError(
                    f"GenerationServer got a ready engine AND engine-construction kwargs {bad}; "
                    "configure them on the engine, or pass the model instead")
            self.engine = model_or_engine
        else:
            from ..generation.engine import GenerationEngine

            self.engine = GenerationEngine(
                model_or_engine, slots=slots, cache_len=cache_len,
                prefill_buckets=prefill_buckets, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, kv_cache_dtype=kv_cache_dtype,
                kv_cache_layout=kv_cache_layout, kv_page_size=kv_page_size,
                kv_pool_pages=kv_pool_pages, draft_model=draft_model, draft_k=draft_k,
                device=device)
        self.scheduler = ContinuousBatcher(self.engine, queue_capacity=queue_capacity,
                                           kind=self.kind)
        # a prefill tier's exports, PREFILL_CONCURRENCY at once: the waiting
        # and admitted counts are its /loadz and /statz pressure
        self._prefill_sem = threading.BoundedSemaphore(PREFILL_CONCURRENCY)
        self._prefill_count_lock = threading.Lock()
        self._prefill_waiting = self._prefill_active = 0
        self.request_timeout_s = request_timeout_s
        self._httpd = _HTTPServer((host, int(port)), _GenerationHandler)
        self._httpd.inference_server = self
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = None
        self._t0 = time.monotonic()
        self.draining = False
        self._stopped = False
        from . import _register_live

        _register_live(self)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def ready(self) -> bool:
        return self.engine.warmed and not self.draining

    def start(self, warmup=True):
        """Start the decode loop (not on a prefill tier, which never
        decodes) and the listener; warm unless ``warmup=False``."""
        if self.kind != "prefill":
            self.scheduler.start()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            name=f"ptt-generation:{self.port}", daemon=True)
            self._thread.start()
        if warmup:
            self.warmup()
        return self

    def warmup(self):
        self.engine.warmup(kind=self.kind)
        return self

    def _exporting(self, fn):
        """``fn()`` (an export) once fewer than :data:`PREFILL_CONCURRENCY`
        run, counted as waiting, then as running. A capture after warmup
        is noted (a prefill tier has no decode loop to note it)."""
        if self.draining:
            raise ServingClosedError("prefill backend draining")
        with self._prefill_count_lock:
            self._prefill_waiting += 1
        running = False
        try:
            with self._prefill_sem:
                with self._prefill_count_lock:
                    self._prefill_waiting -= 1
                    self._prefill_active += 1
                    running = True
                out = fn()
                if self.engine.watch.armed:
                    self.engine.watch.note(tier=self.kind)
                return out
        finally:
            with self._prefill_count_lock:
                if running:
                    self._prefill_active -= 1
                else:
                    self._prefill_waiting -= 1

    def run_prefill(self, prompt, temperature=None):
        """The prefill tier's forward: ``(planes, length, first_token)``."""
        return self._exporting(lambda: self.engine.prefill_export(prompt, temperature))

    def run_prefill_pages(self, prompt, temperature=None, known_hashes=()):
        """:meth:`run_prefill` answered as chain-hashed pages, those in
        ``known_hashes`` header-only."""
        return self._exporting(lambda: self.engine.prefill_export_pages(
            prompt, temperature, known_hashes=known_hashes))

    def cache_geometry(self) -> dict:
        """The slab contract both tiers of a handoff must agree on, checked
        before anything is installed."""
        e = self.engine
        return {"layers": e._num_layers, "heads": e._num_heads, "head_dim": e._head_dim,
                "cache_len": e.cache_len, "kv_dtype": e.kv_cache_dtype}

    def stop(self, drain=True, timeout=30.0):
        """Refuse new work (503), finish (``drain``) or fail what is queued
        and active, close."""
        if self._stopped:
            return
        self._stopped = True
        self.draining = True
        self.scheduler.stop(drain=drain, timeout=timeout)
        t = self._thread
        if t is not None and t.is_alive():
            self._httpd.shutdown()  # returns only once serve_forever has run
        self._httpd.server_close()
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    def healthz(self) -> dict:
        e = self.engine
        return {
            "ready": self.ready,
            "kind": self.kind,
            "warmed": e.warmed,
            "draining": self.draining,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "slots": e.slots,
            "slots_busy": self.scheduler.live_slots,
            "cache_len": e.cache_len,
            "kv_cache_layout": e.kv_cache_layout,
            "prefill_buckets": list(e.prefill_buckets),
            "queue_depth": self.scheduler.queue_depth(),
            "queue_capacity": self.scheduler.queue_capacity,
        }

    def loadz(self) -> dict:
        """The router's load signal (:data:`LOADZ_SCHEMA_VERSION`). On a
        prefill tier ``queue_depth`` is the exports waiting and
        ``slot_occupancy`` the running ones over the concurrency; on the
        other kinds the slot queue and the busy slots. ``compiles``:
        ``expected`` is ``engine.expected_compiles(kind)``, ``unexpected``
        the captures after warmup (``serving/gen_unexpected_compiles``),
        ``jit_misses`` every graph the engine captured, the port's analog of
        the JAX package's jit misses (the CPU captures none)."""
        if self.kind == "prefill":
            with self._prefill_count_lock:
                depth, active = self._prefill_waiting, self._prefill_active
            occupancy = round(active / PREFILL_CONCURRENCY, 4)
        else:
            depth = self.scheduler.queue_depth()
            occupancy = round(self.scheduler.occupancy(), 4)
        cap = self.scheduler.queue_capacity
        return {
            "schema": LOADZ_SCHEMA_VERSION,
            "kind": self.kind,
            "ready": self.ready,
            "draining": self.draining,
            "queue_depth": depth,
            "queue_capacity": cap,
            "load": round(depth / cap, 4),
            "mean_fill": None,
            "slot_occupancy": occupancy,
            "compiles": {"expected": self.engine.expected_compiles(self.kind),
                         "unexpected": counter("serving/gen_unexpected_compiles").value,
                         "jit_misses": self.engine.compile_count()},
        }

    def statz(self) -> dict:
        e, sched = self.engine, self.scheduler
        s = dict(sched.stats)
        uptime = max(time.monotonic() - self._t0, 1e-9)
        out = {
            **self.healthz(),
            "requests": {"submitted": s["requests"], "completed": s["responses"],
                         "rejected_429": s["rejected"], "deadline_expired": s["expired"],
                         "errors": s["errors"]},
            "generation": {
                "tokens_generated": s["tokens"],
                "tokens_per_sec": round(s["tokens"] / uptime, 3),
                "slot_occupancy": round(sched.occupancy(), 4),
                "midbatch_admissions": s["midbatch_admissions"],
                "kv_cache_dtype": e.kv_cache_dtype,
                "kv_bytes_per_token": e.kv_bytes_per_token(),
                "kv_cache_bytes": e.cache_nbytes(),
                "hbm_required_bytes": e.hbm_required_bytes(),
                "suggested_decode_slots": e.suggest_decode_slots(),
            },
            # draft proposals accepted per round decide how many target
            # forwards a token costs
            "speculative": e.spec_stats(),
            # the paged layout's pool occupancy, copy-on-write traffic and
            # prefix-index accounting, overall and per tenant (the ring
            # reports its layout only)
            "paging": e.paging_stats(),
            "latency": {name: sched.quantiles(name) for name in ("token", "ttft", "e2e")},
            "compiles": {
                "prefill_buckets": len(e.prefill_buckets),
                "decode": 2 if e.speculative else 1,
                "expected": e.expected_compiles(self.kind),
                "programs": e.graphs(),
                "unexpected": e.extra_compiles() if e.watch.armed else 0,
            },
        }
        if self.kind == "prefill":
            with self._prefill_count_lock:
                out["prefill"] = {"waiting": self._prefill_waiting,
                                  "active": self._prefill_active,
                                  "concurrency": PREFILL_CONCURRENCY}
        return out
