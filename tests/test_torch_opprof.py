"""The port's per-op profiler against the JAX package's.

- The stamp grammar, every trace-attribution edge case of
  ``tests/test_opprof.py`` (empty and missing dirs, a truncated gzip,
  unstamped time against coverage, cross-block stamps, nested scopes,
  only stamped timelines scored) and the profiler's double start and
  stop-without-start run twice, bodies unchanged: on the JAX modules and
  with the port's ``opprof``, ``profiler`` and ``monitor`` in their place.
- A ``torch.profiler`` trace of the card folds by launch: a kernel goes to
  the stamped range holding its launch on the launching thread
  (synthetic trace); a real interpreted run of the port's executor on the
  CPU under ``torch.profiler`` carries the executor's op stamps.
- ``profile_program`` on the CPU (the JAX tests' replay, closure, trace
  coverage, skipped ``grad::`` ops, chrome track, ``/profilez`` store and
  HTTP, top-K table), the per-op FLOPs by the cost model's counts.
- ``analysis.measure_pass_deltas`` on the same programs in both packages:
  the same passes fire with the same rewrites, and the per-op-type counts
  before and after agree.
"""
import gzip
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.analysis import optimizer as jiropt  # noqa: E402

import _port_counterparts as counterparts  # noqa: E402
from paddle_tpu_torch import monitor, ops, profiler, static  # noqa: E402
from paddle_tpu_torch.analysis import optimizer as iropt  # noqa: E402
from paddle_tpu_torch.monitor import opprof  # noqa: E402

JAX_TESTS = counterparts.jax_tests("test_opprof")
PURE = ["test_stamp_round_trip", "test_stamp_parses_inside_scope_paths",
        *[n for n in vars(JAX_TESTS) if n.startswith("test_attribute_trace_")],
        "test_double_start_is_noop_with_flight_event", "test_stop_without_start_is_clean"]
NAMESPACES = {
    "jax": counterparts.namespace(JAX_TESTS),
    "port": counterparts.namespace(JAX_TESTS, opprof=opprof, profiler=profiler,
                                   monitor=monitor),
}


@pytest.fixture(autouse=True)
def _clean():
    opprof.reset_profiles()
    monitor.reset_registry(unregister=True)
    monitor.cost_model.reset_cost_records()
    yield
    opprof.reset_profiles()
    monitor.reset_registry(unregister=True)
    monitor.cost_model.reset_cost_records()
    for st in (static, jstatic):
        st.disable_static()
        st.reset_default_programs()
        st.global_scope().clear()


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("test_name", PURE)
def test_jax_counterpart(test_name, pkg, request):
    counterparts.call(NAMESPACES[pkg], test_name, request)


def _write_trace(dirpath, events, name="t.trace.json.gz"):
    with gzip.open(os.path.join(dirpath, name), "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_device_kernels_fold_onto_the_range_that_launched_them(tmp_path):
    """A ``torch.profiler`` trace of the card: kernels on the stream's lane,
    launches (``cuda_runtime``) on the host thread inside the stamped
    ranges, paired by ``args.correlation``. A kernel whose launch lies in
    no range counts against coverage; the innermost range wins."""
    host = {"pid": 1, "tid": 7, "ph": "X"}
    dev = {"pid": 0, "tid": 3, "ph": "X", "cat": "kernel"}
    events = [
        dict(host, name="mul#0/0", ts=0, dur=100, cat="user_annotation"),
        dict(host, name="fused_conv_bn_relu#0/1", ts=100, dur=100, cat="user_annotation"),
        dict(host, name="inner#0/2", ts=150, dur=20, cat="user_annotation"),
        dict(host, name="cudaLaunchKernel", ts=10, dur=5, cat="cuda_runtime",
             args={"correlation": 1}),
        dict(host, name="cudaLaunchKernel", ts=120, dur=5, cat="cuda_runtime",
             args={"correlation": 2}),
        dict(host, name="cudaLaunchKernel", ts=160, dur=5, cat="cuda_runtime",
             args={"correlation": 3}),
        dict(host, name="cudaLaunchKernel", ts=300, dur=5, cat="cuda_runtime",
             args={"correlation": 4}),
        dict(dev, name="sm90_gemm", ts=20, dur=40, args={"correlation": 1}),
        dict(dev, name="ptt_conv_mm", ts=130, dur=30, args={"correlation": 2}),
        dict(dev, name="ptt_bn_relu", ts=170, dur=20, args={"correlation": 3}),
        dict(dev, name="stray", ts=310, dur=10, args={"correlation": 4}),
    ]
    _write_trace(str(tmp_path), events)
    table = opprof.attribute_trace(str(tmp_path))
    assert table["status"] == "ok" and table["timelines"] == 1
    assert table["total_us"] == 100.0 and table["stamped_us"] == 90.0
    assert table["coverage"] == 0.9
    by = {r["scope"]: r["time_us"] for r in table["ops"]}
    assert by == {"mul#0/0": 40.0, "fused_conv_bn_relu#0/1": 30.0, "inner#0/2": 20.0}


def _small_program(st=static, o=ops, device="cpu"):
    """Tiny fc + relu inference program, run once so the scope holds its
    parameters."""
    st.enable_static()
    st.global_scope().clear()
    main, startup = st.Program(), st.Program()
    with st.program_guard(main, startup):
        x = st.data("x", [8, 16], "float32")
        h = st.nn.fc(x, 8, name="l1")
        out = o.relu(h)
    exe = st.Executor(device) if device else st.Executor()
    exe.run_startup(startup)
    feeds = {"x": np.ones((8, 16), np.float32)}
    exe.run(main, feed=feeds, fetch_list=[out])
    return main, feeds, out, exe


def test_interpreted_run_under_the_profiler_carries_op_stamps(tmp_path):
    main, feeds, out, exe = _small_program()
    profiler.start_profiler(trace_dir=str(tmp_path))
    try:
        exe.run(main, feed=feeds, fetch_list=[out])
    finally:
        profiler.stop_profiler()
    table = opprof.attribute_trace(str(tmp_path))
    assert table["status"] == "ok"
    assert {r["op_type"] for r in table["ops"]} >= {"mul", "relu"}
    # stamps exist only while a profiler records
    assert not torch.autograd._profiler_enabled()


def test_profile_program_replay_and_closures():
    main, feeds, _, _ = _small_program()
    monitor.cost_model.capture("executor", cost={"flops": 1.0, "bytes accessed": 1.0}, mem={})
    prof = opprof.profile_program(main, feeds, name="small", with_trace=False, device="cpu")
    assert prof["replayed_ops"] == prof["n_ops"] > 0
    replayed = [r for r in prof["ops"] if r["replayed"]]
    for row in replayed:
        assert row["time_us"] > 0
        assert 0.0 <= row["share"] <= 1.0
        assert row["roofline"] in ("compute-bound", "memory-bound", "unknown")
        assert row["predicted_us"] > 0 and row["mfu"] >= 0.0
    assert prof["total_us"] == pytest.approx(sum(r["time_us"] for r in replayed), rel=1e-6)
    mul = [r for r in replayed if r["op_type"] == "mul"][0]
    assert mul["flops"] == 2 * 8 * 16 * 8  # the cost model's count of the product
    rec = monitor.cost_model.latest_record("executor")
    assert rec.time_accuracy == prof["time_accuracy"] is not None
    assert rec.measured_op_us == prof["total_us"]
    assert rec.to_dict()["predicted_op_us"] == rec.predicted_op_us
    txt = monitor.prometheus_text()
    assert "opprof_op_time_ms" in txt and 'op_type="mul"' in txt


def test_profile_program_trace_coverage():
    main, feeds, _, _ = _small_program()
    prof = opprof.profile_program(main, feeds, name="covered", device="cpu")
    att = prof["attribution"]
    assert att["status"] == "ok"
    assert prof["coverage"] is not None and prof["coverage"] >= 0.9
    assert any(r["op_type"] == "mul" for r in att["ops"])


def test_profile_program_skips_grad_ops_cleanly():
    static.enable_static()
    static.global_scope().clear()
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = static.data("x", [4, 4], "float32")
        loss = ops.mean(static.nn.fc(x, 4, name="g1"))
        static.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = static.Executor("cpu")
    exe.run_startup(startup)
    feeds = {"x": np.ones((4, 4), np.float32)}
    exe.run(main, feed=feeds, fetch_list=[loss])
    prof = opprof.profile_program(main, feeds, name="train", with_trace=False, device="cpu")
    skipped = [r for r in prof["ops"] if not r["replayed"]]
    assert any("grad" in r["scope"] for r in skipped)
    assert all(r["reason"] for r in skipped)
    assert prof["replayed_ops"] > 0


def test_chrome_events_track():
    main, feeds, _, _ = _small_program()
    opprof.profile_program(main, feeds, name="tracked", with_trace=False, device="cpu")
    events = opprof.chrome_events()
    ops_events = [e for e in events if e.get("cat") == "opprof"]
    assert ops_events and all(opprof.parse_op_scope(e["name"]) for e in ops_events)
    assert any("tracked" in str(e["args"]) for e in events if e.get("ph") == "M")


def test_profilez_payload_no_data_then_populated():
    status, payload = opprof.profilez_payload({})
    assert status == 200 and payload["status"] == "no-data"
    main, feeds, _, _ = _small_program()
    opprof.profile_program(main, feeds, name="zpage", with_trace=False, device="cpu")
    status, payload = opprof.profilez_payload({})
    assert status == 200 and payload["status"] == "ok" and payload["program"] == "zpage"
    assert payload["summary"]["time_accuracy_envelope"] == opprof.TIME_ACCURACY_ENVELOPE
    status, payload = opprof.profilez_payload({"program": "ghost"})
    assert status == 404 and payload["status"] == "unknown-program"
    assert len(opprof.profilez_payload({"topk": "2"})[1]["ops"]) <= 2


def test_profilez_served_by_debug_server():
    main, feeds, _, _ = _small_program()
    opprof.profile_program(main, feeds, name="http", with_trace=False, device="cpu")
    srv = monitor.start_debug_server(port=0)
    try:
        body = json.load(urllib.request.urlopen(srv.url + "/profilez"))
        assert body["status"] == "ok" and "http" in body["programs"]
        body = json.load(urllib.request.urlopen(srv.url + "/profilez?program=http&topk=1"))
        assert len(body["ops"]) == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/profilez?program=ghost")
        assert ei.value.code == 404
        assert "/profilez" in urllib.request.urlopen(srv.url + "/").read().decode()
    finally:
        monitor.stop_debug_server()


def test_top_ops_table():
    main, feeds, _, _ = _small_program()
    opprof.profile_program(main, feeds, name="topk", with_trace=False, device="cpu")
    top = opprof.top_ops(2)
    assert len(top) == 2 and top[0]["time_us"] >= top[1]["time_us"]
    stats = opprof.opprof_stats()
    assert stats["latest"]["name"] == "topk" and stats["top_ops"]


def _ln_residual_net(st, o):
    x = st.data("x", [4, 16], "float32")
    ff = st.nn.fc(x, 16, activation="relu", bias_attr=False)
    return {"x": np.random.RandomState(1).randn(4, 16).astype("float32")}, \
        o.mean(st.nn.layer_norm(o.add(ff, x)))


def _conv_bn_relu_net(st, o):
    img = st.data("img", [2, 3, 8, 8], "float32")
    h = st.nn.conv2d(img, num_filters=4, filter_size=3, padding=1, bias_attr=False)
    out = st.nn.fc(o.relu(st.nn.batch_norm(h, is_test=True)), 5)
    return {"img": np.random.RandomState(0).randn(2, 3, 8, 8).astype("float32")}, out


@pytest.mark.parametrize("net", [_ln_residual_net, _conv_bn_relu_net],
                         ids=["layernorm_residual", "conv_bn_relu"])
def test_measure_pass_deltas_matches_the_jax_report(net):
    reports = []
    for st, o, kw, mpd in ((jstatic, jops, {}, jiropt.measure_pass_deltas),
                           (static, ops, {"device": "cpu"}, iropt.measure_pass_deltas)):
        st.enable_static()
        st.reset_default_programs()
        st.global_scope().clear()
        feeds, out = net(st, o)
        exe = st.Executor("cpu") if kw else st.Executor()
        exe.run_startup()
        exe.run(feed=feeds, fetch_list=[out])
        reports.append(mpd(st.default_main_program(), feeds, [out.name], level=1,
                           warmup=0, repeats=1, **kw))
        st.disable_static()
    j, p = reports
    assert set(p) == set(j)
    assert p["changed"] is j["changed"] is True
    assert [(s["name"], s["ops_rewritten"]) for s in p["passes"]] == \
        [(s["name"], s["ops_rewritten"]) for s in j["passes"]]
    assert {t: (d["before_ops"], d["after_ops"]) for t, d in p["deltas"].items()} == \
        {t: (d["before_ops"], d["after_ops"]) for t, d in j["deltas"].items()}
    assert p["before_us"] > 0 and p["after_us"] > 0 and p["speedup"] > 0
    assert set(opprof.profiles()) >= {f"{p['name']}@pre", f"{p['name']}@post"}
