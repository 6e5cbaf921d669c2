"""The port's serving router against the JAX package's.

- **Policy parity.** The JAX ``Router`` and the port's stand in front of
  identical HTTP stub fleets (a copy of the stub of ``tests/test_router.py``,
  which also answers the disaggregated routes) and get the same request
  script: the same statuses, the same backend picked per request, the same
  hits per backend and equal ``fleet`` counters, in every case of
  ``tests/test_router.py``'s dispatch section, the disaggregated
  composition, a prefill leg past ``serving_handoff_timeout_s`` (504) and a
  backend that dies mid-response (502).
- **Real backends on the CPU.** The port's ``InferenceServer`` (a small
  saved static program) and ``GenerationServer`` (a tiny GPT: kinds
  ``generate``, ``prefill``, ``decode``) behind the port's router: answers
  equal direct calls, ``/statz`` merges the backends' histograms exactly.
- **Interop.** A port router in front of JAX backends and a JAX router in
  front of port backends; ``/loadz`` key for key, ``/histz`` merged across
  packages.
"""
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import flags as jflags  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu import monitor as jmon  # noqa: E402
from paddle_tpu import serving as jserving  # noqa: E402
from paddle_tpu.inference import Config as JConfig  # noqa: E402
from paddle_tpu.inference import create_predictor as jcreate_predictor  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import convert, static  # noqa: E402
from paddle_tpu_torch import flags as pflags  # noqa: E402
from paddle_tpu_torch import models as pmodels  # noqa: E402
from paddle_tpu_torch import monitor as pmon  # noqa: E402
from paddle_tpu_torch import serving as pserving  # noqa: E402
from paddle_tpu_torch.generation import GenerationEngine  # noqa: E402
from paddle_tpu_torch.inference import Config, create_predictor  # noqa: E402

torch.set_num_threads(1)

ROUTERS = {"jax": jserving.Router, "port": pserving.Router}
IN_DIM, OUT_DIM = 6, 3
CACHE, BUCKETS = 24, (4, 8)


@pytest.fixture(autouse=True)
def _zero_registries():
    """Both registries' counters start at 0 in every test."""
    jmon.reset_registry()
    pmon.reset_registry()
    yield
    pserving.shutdown_all()


# -- stub backend (a copy of tests/test_router.py's, with the handoff routes) ----------


class StubBackend:
    """A fake serving backend: ``/healthz``, ``/loadz``, ``/histz`` and the
    POST routes with scriptable behaviour. A ``prefill`` stub answers a slab
    (``SLAB|`` + the request body), a ``decode`` stub the slab's length."""

    def __init__(self, kind="predict", name="stub"):
        self.kind = kind
        self.name = name
        self.ready = True
        self.draining = False
        self.queue_depth = 0
        self.queue_capacity = 8
        self.hist = {}
        self.post_hits = 0
        self.post_paths = []
        self.post_status = 200
        self.post_delay_s = 0.0
        self.on_post = None        # hook(stub) called while handling
        self.stream_chunks = None  # list[bytes] -> chunked reply
        self.truncate = False      # announce a body, send part, close
        stub = self

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, status, payload):
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.rstrip("/")
                if path == "/healthz":
                    ok = stub.ready and not stub.draining
                    self._json(200 if ok else 503, {"ready": ok})
                elif path == "/loadz":
                    self._json(200, {
                        "schema": 1, "kind": stub.kind,
                        "ready": stub.ready and not stub.draining,
                        "draining": stub.draining,
                        "queue_depth": stub.queue_depth,
                        "queue_capacity": stub.queue_capacity,
                        "load": stub.queue_depth / stub.queue_capacity,
                        "mean_fill": None, "slot_occupancy": None,
                        "compiles": {"expected": 0, "unexpected": 0, "jit_misses": 0}})
                elif path == "/histz":
                    self._json(200, {"histograms": stub.hist})
                else:
                    self._json(404, {"error": path})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                stub.post_hits += 1
                stub.post_paths.append(self.path)
                if stub.on_post is not None:
                    stub.on_post(stub)
                if stub.post_delay_s:
                    time.sleep(stub.post_delay_s)
                if stub.truncate:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", "1000")
                    self.end_headers()
                    self.wfile.write(b'{"partial": ')
                    self.wfile.flush()
                    self.close_connection = True
                    return
                if stub.stream_chunks is not None:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for chunk in stub.stream_chunks:
                        self.wfile.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                    return
                if stub.kind == "prefill" and stub.post_status == 200:
                    data = b"SLAB|" + body
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ptpu-kv-slab")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                payload = {"ok": stub.post_status == 200, "backend": stub.name}
                if stub.kind == "decode":
                    payload["slab"] = body.decode()
                self._json(stub.post_status, payload)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        self._httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


@pytest.fixture()
def stubs():
    live = []

    def make(**kw):
        s = StubBackend(**kw)
        live.append(s)
        return s

    yield make
    for s in live:
        try:
            s.stop()
        except Exception:
            pass


def _post(url, path="/predict", payload=None):
    body = json.dumps(payload or {"inputs": [[0.0]]}).encode()
    try:
        r = urlopen(Request(url + path, data=body, headers={"Content-Type": "application/json"}),
                    timeout=30)
        return r.status, json.loads(r.read())
    except HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _seen(status, out):
    return status, out.get("backend"), ("error" in out)


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def _settled(router, timeout=15.0):
    """``router`` once it has booked every request it answered: no backend
    has one in flight and the request counter has caught up with the
    backends' ``completed`` counts. Both routers relay the answer first and
    count it in ``finish()`` after, so a client holding its answer may read
    the counters a moment too early; every script reads ``statz()``, the
    stubs' hits and ``backend_states()`` only through this."""
    def booked():
        states = router.backend_states()
        return (all(b.inflight == 0 for b in states)
                and router.statz()["fleet"]["requests"] == sum(b.completed for b in states))

    _wait(booked, timeout)
    return router


# -- the request scripts ------------------------------------------------------------------


def _p2c(R, make):
    light, heavy = make(name="light"), make(name="heavy")
    heavy.queue_depth = 7
    router = R(backends=[light.url, heavy.url], probe_interval_s=30).start()
    try:
        seq = [_seen(*_post(router.url)) for _ in range(8)]
        _settled(router)
        return {"seq": seq, "hits": [light.post_hits, heavy.post_hits],
                "fleet": router.statz()["fleet"]}
    finally:
        router.stop(drain=False)


def _p2c_four(R, make):
    """Four backends of distinct load: the two sampled differ per request
    (``random.Random(0xB0DE)``), the lighter of them answers."""
    bs = [make(name=f"b{i}") for i in range(4)]
    for i, b in enumerate(bs):
        b.queue_depth = (3, 0, 2, 1)[i]
    router = R(backends=[b.url for b in bs], probe_interval_s=30).start()
    try:
        seq = [_seen(*_post(router.url)) for _ in range(24)]
        _settled(router)
        return {"seq": seq, "hits": [b.post_hits for b in bs], "fleet": router.statz()["fleet"]}
    finally:
        router.stop(drain=False)


def _connect_failure(R, make):
    dead, live = make(name="dead"), make(name="live")
    live.queue_depth = 3  # the first pick lands on the dying backend
    router = R(backends=[dead.url, live.url], probe_interval_s=30).start()
    try:
        healthy = router.healthy_count
        dead.stop()
        seq = [_seen(*_post(router.url)) for _ in range(4)]
        states = {b.url: b for b in _settled(router).backend_states()}
        return {"healthy": healthy, "seq": seq, "dead_in_rotation": states[dead.url].in_rotation,
                "dead_error": states[dead.url].last_error, "fleet": router.statz()["fleet"]}
    finally:
        router.stop(drain=False)


def _answered_errors(R, make):
    a, b = make(name="a"), make(name="b")
    b.queue_depth = 1
    router = R(backends=[a.url, b.url], probe_interval_s=30).start()
    try:
        seq = []
        for status in (429, 400, 500, 504):
            a.post_status = b.post_status = status
            seq.append(_seen(*_post(router.url)))
        _settled(router)
        return {"seq": seq, "hits": [a.post_hits, b.post_hits],
                "rotation": [s.in_rotation for s in router.backend_states()],
                "fleet": router.statz()["fleet"]}
    finally:
        router.stop(drain=False)


def _admission_503(R, make):
    draining, ok = make(name="draining"), make(name="ok")
    ok.queue_depth = 5
    router = R(backends=[draining.url, ok.url], probe_interval_s=30).start()
    draining.post_status = 503
    draining.draining = True
    try:
        seq = [_seen(*_post(router.url))]
        states = {b.url: b for b in _settled(router).backend_states()}
        out = {"evicted": not states[draining.url].in_rotation,
               "error": states[draining.url].last_error}
        hits0 = draining.post_hits
        seq.append(_seen(*_post(router.url)))
        _settled(router)
        out.update(seq=seq, knocked_again=draining.post_hits - hits0,
                   fleet=router.statz()["fleet"])
        return out
    finally:
        router.stop(drain=False)


def _drain_mid_dispatch(R, make):
    b1, b2 = make(name="b1"), make(name="b2")
    b2.queue_depth = 99

    def begin_drain(stub):
        stub.draining = True

    b1.on_post = begin_drain
    router = R(backends=[b1.url, b2.url], probe_interval_s=30).start()
    try:
        seq = [_seen(*_post(router.url))]
        _settled(router)
        hits = b1.post_hits
        b1.on_post = None
        b1.post_status = 503
        b2.queue_depth = 0
        seq.append(_seen(*_post(router.url)))
        states = {b.url: b for b in _settled(router).backend_states()}
        return {"seq": seq, "b1_hits_first": hits, "b1_in_rotation": states[b1.url].in_rotation,
                "fleet": router.statz()["fleet"]}
    finally:
        router.stop(drain=False)


def _readmission(R, make):
    s = make(name="s")
    router = R(backends=[s.url], probe_interval_s=0.05).start()
    try:
        out = {"healthy0": router.healthy_count}
        s.draining = True
        s.post_status = 503
        out["evicted"] = _wait(lambda: router.healthy_count == 0)
        out["while_out"] = _post(router.url)[0]
        s.draining = False
        s.post_status = 200
        out["readmitted"] = _wait(lambda: router.healthy_count == 1)
        out["after"] = _seen(*_post(router.url))
        fleet = _settled(router).statz()["fleet"]
        out["readmissions"], out["evictions"] = fleet["readmissions"], fleet["evictions"]
        out["no_backend"] = fleet["no_backend_503"]
        return out
    finally:
        router.stop(drain=False)


def _no_backend(R, make):
    router = R(probe_interval_s=30).start()
    try:
        status, out = _post(router.url)
        return {"status": status, "no_backend_msg": "no backend" in out["error"],
                "fleet": _settled(router).statz()["fleet"], "healthz": router.healthz()["ready"]}
    finally:
        router.stop(drain=False)


def _kind_routing(R, make):
    p, g = make(name="p", kind="predict"), make(name="g", kind="generate")
    router = R(backends=[p.url, g.url], probe_interval_s=30).start()
    try:
        seq = [_seen(*_post(router.url, "/generate", {"prompt": [1, 2]})) for _ in range(3)]
        seq += [_seen(*_post(router.url, "/predict")) for _ in range(3)]
        seq.append(_seen(*_post(router.url, "/nothing")))
        _settled(router)
        return {"seq": seq, "hits": [p.post_hits, g.post_hits], "fleet": router.statz()["fleet"]}
    finally:
        router.stop(drain=False)


def _streaming(R, make):
    g = make(name="g", kind="generate")
    g.stream_chunks = [json.dumps({"token": i}).encode() + b"\n" for i in range(5)]
    router = R(backends=[g.url], probe_interval_s=30).start()
    try:
        r = urlopen(Request(router.url + "/generate",
                            data=json.dumps({"prompt": [1], "stream": True}).encode(),
                            headers={"Content-Type": "application/json"}), timeout=30)
        body = r.read().decode()
        return {"status": r.status, "body": body, "fleet": _settled(router).statz()["fleet"]}
    finally:
        router.stop(drain=False)


def _split_hist(values, shards):
    hs = [pmon.Histogram(f"s{i}", buckets=(1.0, 5.0, 10.0, 50.0, 100.0)) for i in range(shards)]
    for i, v in enumerate(values):
        hs[i % shards].observe(v)
    return hs


def _statz_merge(R, make):
    hs = _split_hist(np.random.RandomState(11).gamma(2.0, 9.0, size=400), 2)
    b1, b2 = make(name="b1"), make(name="b2")
    b1.hist = {"serving/e2e_ms": hs[0].snapshot()}
    b2.hist = {"serving/e2e_ms": hs[1].snapshot()}
    router = R(backends=[b1.url, b2.url], probe_interval_s=30).start()
    try:
        merged = _settled(router).merged_backend_quantiles(names=("serving/e2e_ms",))
        return {"merged": merged,
                "statz": router.statz()["latency"]["backends_merged"]["serving/e2e_ms"]}
    finally:
        router.stop(drain=False)


def _disagg(R, make):
    """Prefill + decode tiers beside a unified generate backend: /generate
    composes the two legs; when the decode tier refuses at admission the
    request answers 503 (its prefill leg was answered, the decode leg had
    nowhere to go) and the next /generate falls back to the unified
    backend."""
    g = make(name="g", kind="generate")
    pre, dec = make(name="pre", kind="prefill"), make(name="dec", kind="decode")
    router = R(backends=[g.url, pre.url, dec.url], probe_interval_s=30).start()
    try:
        body = {"prompt": [3, 4, 5], "max_new_tokens": 2}
        seq = [_post(router.url, "/generate", body) for _ in range(2)]
        _settled(router)
        out = {"seq": [(s, o) for s, o in seq], "paths": [pre.post_paths, dec.post_paths],
               "g_hits": g.post_hits}
        dec.draining = True
        dec.post_status = 503
        out["after_decode_drained"] = _seen(*_post(router.url, "/generate", body))
        out["fleet"] = _settled(router).statz()["fleet"]
        out["tail"] = _seen(*_post(router.url, "/generate", body))
        _settled(router)
        out["g_hits_after"] = g.post_hits
        return out
    finally:
        router.stop(drain=False)


def _handoff_timeout(R, make):
    pre, dec = make(name="pre", kind="prefill"), make(name="dec", kind="decode")
    router = R(backends=[pre.url, dec.url], probe_interval_s=30).start()
    try:
        pre.post_delay_s = 1.0
        status, out = _post(router.url, "/generate", {"prompt": [1]})
        _settled(router)
        return {"status": status, "msg": "prefill handoff" in out.get("error", ""),
                "decode_hits": dec.post_hits, "fleet": router.statz()["fleet"]}
    finally:
        router.stop(drain=False)


def _died_mid_response(R, make):
    a, b = make(name="a"), make(name="b")
    b.queue_depth = 4
    a.truncate = True
    router = R(backends=[a.url, b.url], probe_interval_s=30).start()
    try:
        first = _post(router.url)[0]
        states = {s.url: s for s in _settled(router).backend_states()}
        second = _seen(*_post(router.url))
        _settled(router)
        return {"first": first, "a_error": states[a.url].last_error,
                "a_in_rotation": states[a.url].in_rotation, "second": second,
                "hits": [a.post_hits, b.post_hits], "fleet": router.statz()["fleet"]}
    finally:
        router.stop(drain=False)


SCRIPTS = {
    "p2c_prefers_less_loaded": _p2c, "p2c_four_backends": _p2c_four,
    "connect_failure_retries": _connect_failure, "answered_errors_pass": _answered_errors,
    "admission_503_evicts": _admission_503, "drain_mid_dispatch": _drain_mid_dispatch,
    "readmission_on_healthz": _readmission, "no_backend_503": _no_backend,
    "kind_routing": _kind_routing, "streaming": _streaming, "statz_merge": _statz_merge,
    "disaggregated": _disagg, "handoff_timeout_504": _handoff_timeout,
    "died_mid_response_502": _died_mid_response,
}

# what the JAX router does in each script, held absolutely besides the parity
WANT = {
    "p2c_prefers_less_loaded": lambda r: r["hits"] == [8, 0],
    "p2c_four_backends": lambda r: r["hits"][0] == 0 and sum(r["hits"]) == 24,
    "connect_failure_retries": lambda r: r["seq"] == [(200, "live", False)] * 4
    and r["fleet"]["evictions"] == 1 and r["fleet"]["retries"] == 1,
    "answered_errors_pass": lambda r: [s[0] for s in r["seq"]] == [429, 400, 500, 504]
    and sum(r["hits"]) == 4 and r["fleet"]["retries"] == 0,
    "admission_503_evicts": lambda r: r["evicted"] and r["knocked_again"] == 0,
    "drain_mid_dispatch": lambda r: r["b1_hits_first"] == 1 and not r["b1_in_rotation"],
    "readmission_on_healthz": lambda r: r["while_out"] == 503 and r["readmissions"] == 1,
    "no_backend_503": lambda r: r["status"] == 503 and r["fleet"]["no_backend_503"] == 1,
    "kind_routing": lambda r: r["hits"] == [3, 3] and r["seq"][-1][0] == 404,
    "streaming": lambda r: r["body"].count("token") == 5,
    "statz_merge": lambda r: r["merged"]["serving/e2e_ms"]["count"] == 400,
    "disaggregated": lambda r: r["g_hits"] == 0 and r["seq"][0][0] == 200
    and r["seq"][0][1]["backend"] == "dec" and r["after_decode_drained"][0] == 503
    and r["tail"] == (200, "g", False),
    "handoff_timeout_504": lambda r: r["status"] == 504 and r["decode_hits"] == 0,
    "died_mid_response_502": lambda r: r["first"] == 502 and not r["a_in_rotation"]
    and r["second"][:2] == (200, "b"),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_policy_parity_with_the_jax_router(script, stubs, monkeypatch):
    """The same script against both routers over identical stub fleets:
    every observation equal."""
    for reg in (jflags._REGISTRY, pflags._REGISTRY):
        monkeypatch.setattr(reg["serving_handoff_timeout_s"], "value", 0.3)
    got = {}
    for pkg, R in ROUTERS.items():
        jmon.reset_registry()
        pmon.reset_registry()
        got[pkg] = SCRIPTS[script](R, stubs)
    assert got["port"] == got["jax"]
    assert WANT[script](got["port"]), got["port"]


def test_router_refuses_a_nonpositive_retry_budget():
    for R in ROUTERS.values():
        with pytest.raises(Exception, match="retry budget must be positive"):
            R(retries=0)


def test_router_routes_and_loadz_schema(stubs):
    s = stubs(name="s")
    router = pserving.Router(backends=[s.url], probe_interval_s=30).start()
    jrouter = jserving.Router(backends=[s.url], probe_interval_s=30).start()
    try:
        lz, jlz = (json.loads(urlopen(r.url + "/loadz").read()) for r in (router, jrouter))
        assert set(lz) == set(jlz) and set(lz["compiles"]) == set(jlz["compiles"])
        assert lz == jlz
        routes = json.loads(urlopen(router.url + "/").read())["routes"]
        assert "/fleetz" in routes and "/metricz" in routes
        assert json.loads(urlopen(router.url + "/fleetz").read()) == jrouter.fleetz()
        text = urlopen(router.url + "/metrics").read().decode()
        assert "serving_router_backends_healthy 1" in text
        assert json.loads(urlopen(router.url + "/healthz").read())["backends_healthy"] == 1
        assert router.remove_backend(s.url) is not None and router.healthy_count == 0
    finally:
        router.stop()
        jrouter.stop()


# -- real backends ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A small fc program saved by the port (which the JAX ``Predictor``
    loads too)."""
    d = str(tmp_path_factory.mktemp("fleet") / "model")
    static.enable_static()
    static.reset_default_programs()
    static.global_scope().clear()
    try:
        ptt.seed(4)
        x = static.data("x", [None, IN_DIM], "float32")
        h = static.nn.fc(x, 8, activation="relu")
        y = static.nn.fc(h, OUT_DIM)
        exe = static.Executor("cpu")
        exe.run_startup()
        static.save_inference_model(d, ["x"], [y], exe)
    finally:
        static.disable_static()
        static.reset_default_programs()
        static.global_scope().clear()
    return d


def _requests(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(r, IN_DIM).astype("float32") for r in (1, 2, 3, 1, 2, 3)[:n]]


def _answer(out):
    return np.asarray(next(iter(out["outputs"].values())), dtype="float32")


def _server(model_dir, pkg="port"):
    if pkg == "port":
        pred = create_predictor(Config(model_dir), device="cpu")
        return pserving.InferenceServer(pred, port=0, buckets=(1, 2, 4), batch_timeout_ms=1.0)
    return jserving.InferenceServer(jcreate_predictor(JConfig(model_dir)), port=0,
                                    buckets=(1, 2, 4), batch_timeout_ms=1.0)


def test_port_router_over_port_predict_servers(model_dir):
    """Two port ``InferenceServer``s behind the port router: answers equal
    the predictor's, ``/loadz`` discovered, ``/statz`` merged counts exact,
    a drained backend evicted while every request answers 200."""
    ref = create_predictor(Config(model_dir), device="cpu")
    reqs = _requests()
    wants = [ref.run([a])[0] for a in reqs]
    s1, s2 = _server(model_dir).start(), _server(model_dir).start()
    router = pserving.Router(backends=[s1.url, s2.url], probe_interval_s=0.05).start()
    try:
        assert router.healthy_count == 2
        for b in router.backend_states():
            assert b.kind == "predict" and b.compiles["expected"] == 3
        for a, want in zip(reqs, wants):
            status, out = _post(router.url, payload={"inputs": a.tolist(), "tenant": "t1"})
            assert status == 200, out
            np.testing.assert_array_equal(_answer(out), want)
        merged = router.statz()["latency"]["backends_merged"]
        own = [json.loads(urlopen(s.url + "/histz").read())["histograms"] for s in (s1, s2)]
        for name in ("serving/e2e_ms", "serving/queue_ms", "serving/dispatch_ms"):
            # the two servers share this process's registry: each /histz is
            # the process's, and the merge counts it once per backend
            assert merged[name]["count"] == sum(h[name]["count"] for h in own)
        assert own[0]["serving/e2e_ms"]["count"] == len(reqs)
        assert 'kind="predict",tenant="t1"' in "".join(
            own[0]["serving/e2e_ms"]["series"])
        s1.draining = True
        for a in reqs:
            assert _post(router.url, payload={"inputs": a.tolist()})[0] == 200
        assert _wait(lambda: not {b.url: b for b in router.backend_states()}[s1.url].in_rotation)
        sz = _settled(router).statz()
        assert sz["fleet"]["requests"] >= 12 and sz["backends_healthy"] == 1
        fz = router.fleetz()
        assert fz["backends_scraped"] == 1 and "serving/e2e_ms" in fz["fleet"]["predict"]
    finally:
        router.stop(drain=True)
        s1.stop(drain=False)
        s2.stop(drain=False)


# the histograms a predict server observes: the other server kinds'
# (``serving/gen_*``, ``serving/router_*``) may lie in the same process's
# registries, put there by whatever ran in it before
PREDICT_HISTOGRAMS = {"serving/queue_ms", "serving/assemble_ms", "serving/dispatch_ms",
                      "serving/e2e_ms"}
_FILL_COUNTERS = ("serving/batched_rows_total", "serving/batch_slots_total",
                  "serving/unexpected_compiles")


def test_loadz_schema_equals_the_jax_server(model_dir):
    """``/loadz`` of a port and a JAX server over the same directory: the
    same keys, the same kind, readiness and expectations; ``/histz`` and
    ``/metricz?format=snapshot`` shaped alike. The registries are the
    process's, so the counters are read as deltas over this test's one
    request and only a predict server's histograms are compared."""
    ps, js = _server(model_dir, "port").start(), _server(model_dir, "jax").start()
    try:
        before = {mon: [mon.counter(n).value for n in _FILL_COUNTERS] for mon in (pmon, jmon)}
        for s in (ps, js):
            assert _post(s.url, payload={"inputs": _requests(1)[0].tolist()})[0] == 200
        delta = {mon: [mon.counter(n).value - b for n, b in zip(_FILL_COUNTERS, before[mon])]
                 for mon in (pmon, jmon)}
        plz, jlz = (json.loads(urlopen(s.url + "/loadz").read()) for s in (ps, js))
        assert set(plz) == set(jlz) and set(plz["compiles"]) == set(jlz["compiles"])
        for key in ("schema", "kind", "ready", "draining", "queue_capacity", "slot_occupancy"):
            assert plz[key] == jlz[key], key
        assert plz["compiles"]["expected"] == jlz["compiles"]["expected"] == 3
        (p_rows, p_slots, p_unexpected), (j_rows, j_slots, j_unexpected) = delta[pmon], delta[jmon]
        assert p_unexpected == j_unexpected == 0
        assert p_slots > 0 and j_slots > 0 and p_rows / p_slots == j_rows / j_slots
        phz, jhz = (json.loads(urlopen(s.url + "/histz").read()) for s in (ps, js))
        assert set(phz) == set(jhz) == {"histograms"}
        assert PREDICT_HISTOGRAMS <= set(phz["histograms"])
        assert PREDICT_HISTOGRAMS <= set(jhz["histograms"])
        for name in sorted(PREDICT_HISTOGRAMS):
            snap = phz["histograms"][name]
            assert set(snap) == set(jhz["histograms"][name]), name
            assert snap["bounds"] == jhz["histograms"][name]["bounds"]
        pmz = json.loads(urlopen(ps.url + "/metricz?format=snapshot").read())
        assert set(pmz) == {"metrics"} and "serving/requests_total" in pmz["metrics"]
        text = urlopen(ps.url + "/metricz").read().decode()
        assert "# TYPE serving_e2e_ms histogram" in text
        sz = json.loads(urlopen(ps.url + "/statz").read())
        assert sz["requests"]["completed"] == 1 and sz["batches"]["dispatched"] == 1
    finally:
        ps.stop(drain=False)
        js.stop(drain=False)


def test_port_router_over_jax_backends_and_back(model_dir):
    """A port router in front of a JAX and a port predict server, and a JAX
    router in front of two port servers: answers equal the predictor's
    (1e-6 of the largest across packages), the merged ``/histz`` counts the
    requests of both packages' backends exactly."""
    ref = create_predictor(Config(model_dir), device="cpu")
    reqs = _requests()
    wants = [ref.run([a])[0] for a in reqs]
    js, ps = _server(model_dir, "jax").start(), _server(model_dir, "port").start()
    ps2 = _server(model_dir, "port").start()
    router = pserving.Router(backends=[js.url, ps.url], probe_interval_s=30).start()
    jrouter = jserving.Router(backends=[ps2.url], probe_interval_s=30).start()
    try:
        # the routers, and each backend straight (idle backends tie on load,
        # so sequential requests through a router may all land on one)
        for r in (router, jrouter, js, ps):
            for a, want in zip(reqs, wants):
                status, out = _post(r.url, payload={"inputs": a.tolist()})
                assert status == 200, out
                got = _answer(out)
                assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        merged = router.merged_backend_quantiles(names=("serving/e2e_ms",))["serving/e2e_ms"]
        jcount = json.loads(urlopen(js.url + "/histz").read())["histograms"]["serving/e2e_ms"]
        pcount = json.loads(urlopen(ps.url + "/histz").read())["histograms"]["serving/e2e_ms"]
        assert merged["backends"] == 2 and merged["count"] == jcount["count"] + pcount["count"]
        assert jcount["count"] >= len(reqs) and pcount["count"] >= len(reqs)
        assert {b.kind for b in router.backend_states()} == {"predict"}
        jmerged = jrouter.merged_backend_quantiles(names=("serving/e2e_ms",))
        assert jmerged["serving/e2e_ms"]["count"] == pcount["count"]
    finally:
        router.stop()
        jrouter.stop()
        for s in (js, ps, ps2):
            s.stop(drain=False)


# -- generation backends ------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt():
    with jax.enable_x64(False):
        paddle.seed(3)
        cfg = jmodels.gpt_tiny_config()
        cfg.attention_window = CACHE
        jm = jmodels.GPTForCausalLM(cfg)
        jm.eval()
        state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    pm = pmodels.GPTForCausalLM(pmodels.GPTConfig(**vars(cfg)))
    pm.load_state_dict(convert.gpt_state_from_numpy(state, pm))
    return jm, pm.eval()


def _engine(model, slots=2):
    return GenerationEngine(model, slots=slots, cache_len=CACHE, prefill_buckets=BUCKETS,
                            seed=7, device="cpu")


def _gen(url, prompt, n=6, stream=False):
    body = json.dumps({"prompt": prompt, "max_new_tokens": n, "temperature": 0.0,
                       "stream": stream}).encode()
    r = urlopen(Request(url + "/generate", data=body), timeout=60)
    if not stream:
        return r.status, json.loads(r.read())["tokens"]
    lines = [json.loads(ln) for ln in r.read().decode().splitlines() if ln]
    return r.status, lines[-1]["tokens"]


def test_port_router_over_generation_kinds(gpt):
    """A generate server behind the router, then a prefill and a decode
    tier beside it: /generate (plain and streamed) equals the engine's
    greedy tokens, unified and composed from the two legs; the tiers'
    /statz show the legs, every /loadz its kind and no unexpected capture."""
    _, pm = gpt
    ref = _engine(pm, slots=1).warmup()
    prompts = [[5, 6, 7, 8], [17, 4, 99], [3, 3, 9, 12, 40, 2]]
    wants = [ref.generate([p], max_new_tokens=6, temperature=0.0)[0] for p in prompts]
    g = pserving.GenerationServer(_engine(pm), kind="generate").start()
    router = pserving.Router(backends=[g.url], probe_interval_s=0.05).start()
    pre = dec = None
    try:
        for p, want in zip(prompts, wants):
            assert _gen(router.url, p) == (200, want)
        assert _gen(router.url, prompts[0], stream=True) == (200, wants[0])
        pre = pserving.GenerationServer(_engine(pm, slots=1), kind="prefill").start()
        dec = pserving.GenerationServer(_engine(pm), kind="decode").start()
        router.add_backend(pre.url)
        router.add_backend(dec.url)
        assert router.has_kind("prefill") and router.has_kind("decode")
        hits = g.statz()["requests"]["submitted"]
        for p, want in zip(prompts, wants):
            assert _gen(router.url, p) == (200, want)
        assert _gen(router.url, prompts[1], stream=True) == (200, wants[1])
        assert g.statz()["requests"]["submitted"] == hits  # every /generate composed
        assert dec.statz()["requests"]["completed"] == len(prompts) + 1
        for s, kind in ((g, "generate"), (pre, "prefill"), (dec, "decode")):
            lz = json.loads(urlopen(s.url + "/loadz").read())
            assert lz["kind"] == kind and lz["compiles"]["unexpected"] == 0
            assert lz["compiles"]["expected"] == s.engine.expected_compiles(kind)
        fz = router.fleetz()
        assert {"generate", "decode"} <= set(fz["fleet"])
        assert "serving/gen_ttft_ms" in fz["fleet"]["decode"]
    finally:
        router.stop()
        for s in (g, pre, dec):
            if s is not None:
                s.stop(drain=False)


def test_jax_router_composes_port_tiers(gpt):
    """The JAX router in front of the port's prefill and decode tiers: the
    composed /generate equals the port engine's greedy tokens and the JAX
    engine's."""
    jm, pm = gpt
    ref = _engine(pm, slots=1).warmup()
    prompt = [9, 2, 14, 6]
    want = ref.generate([prompt], max_new_tokens=6, temperature=0.0)[0]
    with jax.enable_x64(False):
        jref = jserving.GenerationServer(jm, port=0, slots=1, cache_len=CACHE,
                                         prefill_buckets=BUCKETS).engine
        jref.warmup()
        jwant = jref.generate([prompt], max_new_tokens=6, temperature=0.0)[0]
    pre = pserving.GenerationServer(_engine(pm, slots=1), kind="prefill").start()
    dec = pserving.GenerationServer(_engine(pm), kind="decode").start()
    jrouter = jserving.Router(backends=[pre.url, dec.url], probe_interval_s=30).start()
    try:
        assert jrouter.has_kind("prefill") and jrouter.has_kind("decode")
        assert _gen(jrouter.url, prompt) == (200, want)
        assert list(want) == list(jwant)
    finally:
        jrouter.stop()
        pre.stop(drain=False)
        dec.stop(drain=False)


def test_shutdown_all_stops_servers_and_routers(model_dir):
    s = _server(model_dir).start()
    router = pserving.Router(backends=[s.url], probe_interval_s=30).start()
    pserving.shutdown_all()
    assert router.draining and s.draining and s.pool.alive == 0
    with pytest.raises(OSError):
        urlopen(router.url + "/healthz", timeout=2)


def test_loadz_counts_a_capture_after_warmup(gpt):
    """A graph captured after warmup (a store's miss) shows as ``unexpected``
    on ``/loadz``: on a prefill tier at its next export (it has no decode
    loop to note it), on a generate tier at its next decode step."""
    _, pm = gpt
    for kind in ("prefill", "generate"):
        pmon.reset_registry()
        srv = pserving.GenerationServer(_engine(pm, slots=1), kind=kind).start()
        try:
            assert srv.loadz()["compiles"]["unexpected"] == 0
            srv.engine._stores["prefill"].misses += 1  # as a capture after warmup books it
            route = "/prefill" if kind == "prefill" else "/generate"
            body = json.dumps({"prompt": [5, 6], "max_new_tokens": 2, "temperature": 0.0})
            assert urlopen(Request(srv.url + route, data=body.encode()), timeout=60).status == 200
            lz = json.loads(urlopen(srv.url + "/loadz").read())
            assert lz["compiles"]["unexpected"] == 1 and lz["compiles"]["jit_misses"] == 1
        finally:
            srv.stop(drain=False)
