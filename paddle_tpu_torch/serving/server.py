"""HTTP frontends for online serving (``paddle_tpu/serving/server.py``).

Stdlib ``ThreadingHTTPServer``s. :class:`InferenceServer` exposes:

- ``POST /predict`` — JSON ``{"inputs": {feed: nested list}, "deadline_ms":
  optional}`` through the dynamic batcher; answers ``{"outputs": {fetch:
  nested list}, "rows": n}``. **429** queue full, **504** deadline passed
  in the queue, **400** malformed request, **503** draining or not ready.
- ``GET /healthz`` — readiness: 200 once every bucket has run (warmup) and
  the server is not draining; 503 otherwise.
- ``GET /statz`` — queue depth, batch fill, request counters, the kernel
  launch counts and ``compiles``: the buckets and the unexpected graph
  captures after warmup.

:class:`GenerationServer` (``:740-1358``) serves a causal LM through a
:class:`~paddle_tpu_torch.serving.continuous.ContinuousBatcher` over a
:class:`~paddle_tpu_torch.generation.GenerationEngine`:

- ``POST /generate`` — JSON ``{"prompt": [ids], "max_new_tokens",
  "temperature", "deadline_ms", "stream", "tenant"}`` (all but the prompt
  optional); answers ``{"tokens", "finish_reason", "prompt_tokens"}``, or
  with ``"stream": true`` chunked ndjson, one ``{"token": id}`` line a
  decoded token and a final ``{"done": true, ...}``; the statuses of
  ``/predict``.
- ``GET /healthz``, ``GET /`` and ``GET /statz`` (requests, tokens/s, slot
  occupancy, latency quantiles, the KV cache's bytes, and ``compiles``:
  the graphs and the unexpected captures after warmup).

The JAX package's other routes (``/metrics``, ``/loadz``, ``/tracez``, ...)
and the prefill/decode backend kinds wait for ROADMAP Queue A items 8 and 3.

``stop(drain=True)`` refuses new work (503), flushes what is queued, answers
the waiting handlers, then closes.
"""
from __future__ import annotations

import json
import queue as _queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..errors import InvalidArgumentError, UnimplementedError
from ..flags import flag
from ..ops.cuda import launch_counts
from .batcher import DeadlineExceededError, DynamicBatcher, QueueFullError, ServingClosedError
from .continuous import ContinuousBatcher
from .replica import ReplicaPool

__all__ = ["InferenceServer", "GenerationServer"]


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

    def _check_ready(self, srv) -> bool:
        if not srv.ready:
            self._reply(503, {"error": "draining" if srv.draining else "not ready"})
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
        raw = self._read_body()
        if raw is None:
            return
        if path != "/predict":
            self._reply(404, {"error": f"unknown path {path!r}"})
            return
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
        except (ValueError, TypeError, InvalidArgumentError) as e:
            self._reply(400, {"error": str(e)})
            return
        req = self._try_submit(lambda: srv.batcher.submit(inputs, deadline_ms=deadline_ms))
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


class _GenerationHandler(_BaseHandler):
    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        srv = self._srv
        if path == "/healthz":
            self._reply(200 if srv.ready else 503, srv.healthz())
        elif path == "/statz":
            self._reply(200, srv.statz())
        elif path == "/":
            self._reply(200, {"service": "paddle_tpu_torch generation", "kind": srv.kind,
                              "routes": ["/generate (POST)", "/healthz", "/statz"]})
        else:
            self._reply(404, {"error": f"unknown path {path!r}"})

    def do_POST(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        raw = self._read_body()
        if raw is None:
            return
        if path != "/generate":
            self._reply(404, {"error": f"unknown path {path!r} (this backend's kind is "
                                       f"{self._srv.kind!r})"})
            return
        self._generate(raw)

    @staticmethod
    def _parse_gen_body(raw) -> dict:
        """The ``/generate`` JSON body's parameters; raises on malformed
        input (400)."""
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
        }

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
        if req is None:
            return
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
    card unless named). ``start()`` warms by default, so ``/healthz``
    readiness means every prefill bucket and the decode step are captured.
    ``kind`` other than ``generate`` raises (the disaggregated tiers are not
    ported)."""

    def __init__(self, model_or_engine, port=0, host="127.0.0.1", slots=None, cache_len=None,
                 prefill_buckets=None, queue_capacity=None, max_new_tokens=None,
                 temperature=None, top_k=None, kv_cache_dtype=None, draft_model=None,
                 draft_k=None, kind=None, request_timeout_s=120.0, device=None):
        self.kind = str(kind if kind is not None else flag("backend_kind"))
        if self.kind in ("prefill", "decode"):
            raise UnimplementedError(
                f"backend kind {self.kind!r}: the disaggregated prefill/decode handoff "
                "(ROADMAP.md Queue A item 3, entry 4) is not ported yet")
        if self.kind != "generate":
            raise InvalidArgumentError(f"backend kind must be one of ['decode', 'generate', "
                                       f"'prefill'], got {self.kind!r}")
        if hasattr(model_or_engine, "step") and hasattr(model_or_engine, "admit"):
            given = {"slots": slots, "cache_len": cache_len, "prefill_buckets": prefill_buckets,
                     "max_new_tokens": max_new_tokens, "temperature": temperature,
                     "top_k": top_k, "kv_cache_dtype": kv_cache_dtype,
                     "draft_model": draft_model, "draft_k": draft_k, "device": device}
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
                draft_model=draft_model, draft_k=draft_k, device=device)
        self.scheduler = ContinuousBatcher(self.engine, queue_capacity=queue_capacity,
                                           kind=self.kind)
        self.request_timeout_s = request_timeout_s
        self._httpd = _HTTPServer((host, int(port)), _GenerationHandler)
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
        return self.engine.warmed and not self.draining

    def start(self, warmup=True):
        """Start the decode loop and the listener; warm unless
        ``warmup=False``."""
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

    def statz(self) -> dict:
        e, sched = self.engine, self.scheduler
        s = dict(sched.stats)
        uptime = max(time.monotonic() - self._t0, 1e-9)
        return {
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
            "latency": {name: sched.quantiles(name) for name in ("token", "ttft", "e2e")},
            "compiles": {
                "prefill_buckets": len(e.prefill_buckets),
                "decode": 1,
                "expected": e.expected_compiles(self.kind),
                "programs": e.graphs(),
                "unexpected": e.extra_compiles() if e.watch.armed else 0,
            },
        }
