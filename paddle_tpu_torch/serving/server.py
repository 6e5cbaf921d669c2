"""HTTP frontend for online serving (``paddle_tpu/serving/server.py``).

A stdlib ``ThreadingHTTPServer`` exposing:

- ``POST /predict`` — JSON ``{"inputs": {feed: nested list}, "deadline_ms":
  optional}`` through the dynamic batcher; answers ``{"outputs": {fetch:
  nested list}, "rows": n}``. **429** queue full, **504** deadline passed
  in the queue, **400** malformed request, **503** draining or not ready.
- ``GET /healthz`` — readiness: 200 once every bucket has run (warmup) and
  the server is not draining; 503 otherwise.
- ``GET /statz`` — queue depth, batch fill, request counters, the kernel
  launch counts and ``compiles``: the buckets and the unexpected graph
  captures after warmup.

``stop(drain=True)`` refuses new work (503), flushes what is queued
through the replicas, answers the waiting handlers, then closes.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..errors import InvalidArgumentError
from ..ops.cuda import launch_counts
from .batcher import DeadlineExceededError, DynamicBatcher, QueueFullError, ServingClosedError
from .replica import ReplicaPool

__all__ = ["InferenceServer"]


class _HTTPServer(ThreadingHTTPServer):
    # the stdlib backlog of 5 refuses connections under a burst; refusals
    # belong to the bounded admission queue (429)
    request_queue_size = 128
    daemon_threads = True


class _ServingHandler(BaseHTTPRequestHandler):
    server_version = "ptt-serving/1"
    protocol_version = "HTTP/1.1"  # every reply has a Content-Length

    def log_message(self, *args):  # no per-request stderr lines
        pass

    @property
    def _srv(self):
        return self.server.inference_server

    def _reply(self, status, payload):
        data = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        srv = self._srv
        if path == "/healthz":
            self._reply(200 if srv.ready else 503, srv.healthz())
        elif path == "/statz":
            self._reply(200, srv.statz())
        elif path == "/":
            self._reply(200, {"service": "paddle_tpu_torch serving",
                              "routes": ["/predict (POST)", "/healthz", "/statz"]})
        else:
            self._reply(404, {"error": f"unknown path {path!r}"})

    def do_POST(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        # read (drain) the body before any reply: unread bytes on a
        # keep-alive connection would parse as the next request
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            self.close_connection = True
            self._reply(400, {"error": "malformed Content-Length"})
            return
        raw = self.rfile.read(length) if length > 0 else b"{}"
        if path != "/predict":
            self._reply(404, {"error": f"unknown path {path!r}"})
            return
        self._predict(raw)

    def _predict(self, raw):
        srv = self._srv
        if not srv.ready:
            self._reply(503, {"error": "draining" if srv.draining else "not ready"})
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
        except (ValueError, TypeError, InvalidArgumentError) as e:
            self._reply(400, {"error": str(e)})
            return
        try:
            req = srv.batcher.submit(inputs, deadline_ms=deadline_ms)
        except QueueFullError as e:
            self._reply(429, {"error": str(e)})
            return
        except ServingClosedError as e:
            self._reply(503, {"error": str(e)})
            return
        except InvalidArgumentError as e:
            self._reply(400, {"error": str(e)})
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
