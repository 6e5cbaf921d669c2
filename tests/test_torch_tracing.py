"""The port's request tracing against the JAX package's.

Every pure test of ``tests/test_tracing.py`` (the ``traceparent`` wire
format, span nesting and context, retroactive intervals, fan-in links, the
tail-sampled store's retention, merges and eviction) runs here twice, its
body and assertions unchanged: once on ``paddle_tpu.monitor.tracing`` and
once with the port's module and flags in its place. Payloads of the same
spans are compared key for key. Beyond them, on the port alone: the
TrainingMonitor's step trace, the merged chrome trace, the debug server's
``/tracez``, the executor's cache disposition on the current span, and one
``/predict`` through the port's router to a port server under a client
``traceparent``: one trace id from the router's root through the attempt
span to the backend's queue-wait, assemble and dispatch spans.
"""
import json
import os
import sys
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.flags import set_flags as jset_flags  # noqa: E402
from paddle_tpu.monitor import tracing as jtracing  # noqa: E402

import _port_counterparts as counterparts  # noqa: E402
from paddle_tpu_torch import monitor as pmon  # noqa: E402
from paddle_tpu_torch import static  # noqa: E402
from paddle_tpu_torch.flags import set_flags  # noqa: E402
from paddle_tpu_torch.inference import Predictor  # noqa: E402
from paddle_tpu_torch.jit_api import InputSpec  # noqa: E402
from paddle_tpu_torch.monitor import flight_recorder as pfr  # noqa: E402
from paddle_tpu_torch.monitor import tracing  # noqa: E402
from paddle_tpu_torch.serving import InferenceServer, Router  # noqa: E402

JAX_TESTS = counterparts.jax_tests("test_tracing")
PURE = [
    "test_traceparent_round_trip", "test_traceparent_rejects_garbage",
    "test_ids_are_wire_valid_and_unique", "test_span_nesting_and_parentage",
    "test_span_outside_trace_is_free_noop", "test_trace_disabled_flag",
    "test_annotate_and_note_status", "test_remote_parent_preserves_trace_id",
    "test_record_interval_retroactive", "test_record_fanin_links_each_member_exactly_once",
    "test_tail_sampling_keeps_flags_and_slowest_drops_bulk",
    "test_tail_sampling_window_forgets_old_champions", "test_store_capacity_fifo_eviction",
    "test_second_finish_merges_instead_of_overwriting",
    "test_errored_outer_root_merge_promotes_to_always_kept",
    "test_dropped_inner_root_subtree_survives_for_outer_root",
    "test_dropped_then_retained_counts_one_request",
    "test_active_gc_evicts_lingerers_before_live_traces",
    "test_flag_after_retention_merges_reasons",
]
NAMESPACES = {
    "jax": counterparts.namespace(JAX_TESTS),
    "port": counterparts.namespace(JAX_TESTS, tracing=tracing, set_flags=set_flags),
}


@pytest.fixture(autouse=True)
def _clean():
    for tr in (tracing, jtracing):
        tr.reset_store()
    pmon.reset_registry(unregister=True)
    pfr.reset_recorder()
    yield
    for tr in (tracing, jtracing):
        tr.reset_store()
    pmon.reset_registry(unregister=True)
    pfr.reset_recorder()


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("test_name", PURE)
def test_jax_counterpart(test_name, pkg, request):
    counterparts.call(NAMESPACES[pkg], test_name, request)


def _normalized(payload):
    """A trace payload with its ids and clocks taken out: what the same
    calls must make alike in both packages."""
    out = {k: v for k, v in payload.items() if k not in ("trace_id", "t_start", "duration_ms")}
    out["spans"] = [{k: v for k, v in s.items()
                     if k not in ("trace_id", "span_id", "parent_id", "t", "dur_ms", "links")}
                    for s in payload["spans"]]
    return out


def test_same_spans_make_the_same_payload():
    payloads, listings = [], []
    for tr, sf in ((jtracing, jset_flags), (tracing, set_flags)):
        with tr.start_trace("serving::predict", client="c") as root:
            tr.annotate(bucket=4, rows=3)
            with tr.start_span("serving::dispatch", replica=0):
                tr.annotate(cache_key="executor#abc")
            tr.record_interval("serving::queue_wait", root.context, 0.0, 0.001, rows=3)
            tr.flag_current_trace("test")
            tr.note_status(200)
        payloads.append(tr.store().get(root.trace_id))
        listings.append(tr.tracez_payload({})[1])
    j, p = payloads
    assert set(p) == set(j)
    assert _normalized(p) == _normalized(j)
    assert [set(s) for s in p["spans"]] == [set(s) for s in j["spans"]]
    assert set(listings[1]) == set(listings[0])
    assert set(listings[1]["stats"]) == set(listings[0]["stats"])
    assert set(listings[1]["store"]) == set(listings[0]["store"])
    assert listings[1]["stats"] == listings[0]["stats"]
    chrome = [tr.chrome_events(pl) for tr, pl in ((jtracing, j), (tracing, p))]
    assert [sorted(e) for e in chrome[1]] == [sorted(e) for e in chrome[0]]
    assert [e["name"] for e in chrome[1]] == [e["name"] for e in chrome[0]]


def test_training_monitor_step_trace_cites_flight_events():
    mon = pmon.TrainingMonitor("trace_test", interval=0)
    with mon.step(examples=4):
        ctx = tracing.current_context()
        assert ctx is not None
        tracing.flag_current_trace("test")
        pfr.record_event("test_step_event", detail=1)
    ev = [e for e in pfr.get_recorder().events() if e["kind"] == "test_step_event"][0]
    assert ev["trace_id"] == ctx.trace_id
    p = tracing.store().get(ctx.trace_id)
    assert p["spans"][-1]["name"] == "train::trace_test::step"
    assert p["spans"][-1]["attrs"]["step"] == 1
    mon.close()


def test_training_monitor_aborted_step_trace_is_errored():
    mon = pmon.TrainingMonitor("trace_abort", interval=0)
    ctx = [None]
    with pytest.raises(RuntimeError):
        with mon.step():
            ctx[0] = tracing.current_context()
            raise RuntimeError("boom")
    p = tracing.store().get(ctx[0].trace_id)
    assert p is not None and "error" in p["kept"]
    assert p["spans"][-1]["error"] == "step aborted"
    assert [e for e in pfr.events() if e["kind"] == "step_aborted"]
    mon.close()


def test_export_merged_chrome_trace_embeds_retained(tmp_path):
    with tracing.start_trace("serving::export_probe") as root:
        tracing.flag_current_trace("test")
        with tracing.start_span("serving::dispatch", flops=9.0):
            pass
    path = str(tmp_path / "merged.json")
    pmon.export_merged_chrome_trace(path, device_trace_dir=str(tmp_path / "none"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("args", {}).get("trace_id") == root.trace_id]
    assert {e["name"] for e in mine} == {"serving::export_probe", "serving::dispatch"}
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    import trace_summary

    assert len(trace_summary.filter_trace_id(events, root.trace_id[:10])) == 2
    assert trace_summary.filter_trace_id(events, "f" * 32) == []


def _http_json(url):
    try:
        r = urlopen(url, timeout=30)
        return r.status, json.loads(r.read())
    except HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_debug_server_tracez_endpoint():
    with tracing.start_trace("serving::dbg_probe") as root:
        tracing.flag_current_trace("test")
    srv = pmon.DebugServer(port=0).start()
    try:
        status, listing = _http_json(srv.url + "/tracez")
        assert status == 200
        assert any(r["trace_id"] == root.trace_id for r in listing["retained"])
        status, one = _http_json(srv.url + f"/tracez?id={root.trace_id}")
        assert status == 200 and one["trace_id"] == root.trace_id
        assert _http_json(srv.url + "/tracez?id=" + "1" * 32)[0] == 404
    finally:
        srv.stop()


def test_executor_tags_the_span_with_its_cache_disposition():
    static.enable_static()
    static.reset_default_programs()
    scope = static.Scope()
    try:
        x = static.data("x", [2, 3], "float32")
        y = static.nn.fc(x, 4)
        exe = static.Executor("cpu")
        exe.run_startup(scope=scope)
        feed = {"x": np.ones((2, 3), "float32")}
        for plan in ("miss", "hit"):
            with tracing.start_trace("serving::probe") as root:
                tracing.flag_current_trace("test")
                exe.run(feed=feed, fetch_list=[y], scope=scope)
            attrs = tracing.store().get(root.trace_id)["spans"][-1]["attrs"]
            assert attrs["plan_cache"] == plan and attrs["jit_cache"] == "uncaptured"
        kinds = [e["kind"] for e in pfr.events()]
        assert kinds.count("executor_run_begin") == 2 and kinds.count("executor_run_end") == 2
    finally:
        static.disable_static()
        static.reset_default_programs()


class _Affine(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 2)

    def forward(self, x):
        return self.fc(x)


def test_router_traceparent_reaches_the_backend_spans():
    """A client ``traceparent`` -> the router's root and attempt span ->
    the backend's request span and its stages, all under one trace id
    (router and backend share this process, so the store merges both
    subtrees)."""
    pred = Predictor(_Affine(), [InputSpec([None, 3], "float32", "x")], ["y"], device="cpu")
    srv = InferenceServer(pred, port=0, buckets=(1, 2), batch_timeout_ms=1.0).start()
    router = Router(backends=[srv.url], probe_interval_s=30).start()
    try:
        client = tracing.SpanContext(tracing.new_trace_id(), tracing.new_span_id())
        body = json.dumps({"inputs": [[0.5, 1.0, -1.0]]}).encode()
        req = Request(router.url + "/predict", data=body,
                      headers={"Content-Type": "application/json",
                               tracing.TRACEPARENT_HEADER: tracing.format_traceparent(client)})
        set_flags({"trace_sample_slowest_k": 1000})  # keep every trace of this request
        try:
            assert urlopen(req, timeout=30).status == 200
            # the handlers close their traces just after they answer
            deadline = time.monotonic() + 5.0
            while True:
                status, one = _http_json(srv.url + f"/tracez?id={client.trace_id}")
                names = {s["name"] for s in one.get("spans", ())}
                if {"serving::router", "serving::predict"} <= names or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.02)
        finally:
            set_flags({"trace_sample_slowest_k": 5})
        assert status == 200
        spans = {s["name"]: s for s in one["spans"]}
        assert {"serving::router", "serving::attempt", "serving::predict",
                "serving::queue_wait", "serving::assemble",
                "serving::dispatch"} <= set(spans)
        assert spans["serving::router"]["parent_id"] == client.span_id
        assert spans["serving::predict"]["parent_id"] == spans["serving::attempt"]["span_id"]
        assert spans["serving::attempt"]["attrs"]["status"] == 200
        kinds = [e["kind"] for e in pfr.events()]
        assert "router_backend_added" in kinds and "router_start" in kinds
        for route in ("/costz", "/goodputz", "/profilez", "/sloz"):
            assert _http_json(srv.url + route)[0] == 200, route
    finally:
        router.stop()
        srv.stop()
    assert "router_stop" in [e["kind"] for e in pfr.events()]
