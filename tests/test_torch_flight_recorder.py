"""The port's flight recorder against the JAX package's.

Every test of ``tests/test_flight_recorder.py`` that needs no JAX program,
collective, parameter server or launcher runs here twice, its body and
assertions unchanged: on ``paddle_tpu.monitor.flight_recorder`` and with the
port's recorder, debug server, registry and flags in its place (the ring,
collective tails, dump format and paths, the watchdog, the excepthook and
``SIGUSR1`` triggers, ``first_divergence``, the desync exchange over a fake
channel and in a world of one, the debug endpoints, Prometheus help lines).
The collective, parameter-server, launch and cross-rank tests wait for the
port's multi-process runtime. Beyond them, on the port: a dump and a
snapshot hold the JAX layout key for key and read under
``tools/debug_dump.py``; the executor's run events with their cache
disposition and the progress clock; ``check_nan_inf_action`` through the
executor (warn counts, dump writes then raises, a bad value is loud); flag
changes; the graph store's capture, refusal and eviction events and the
IR gates' events; the registry's series-overflow event.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.monitor import flight_recorder as jfr  # noqa: E402

import _port_counterparts as counterparts  # noqa: E402
from paddle_tpu_torch import monitor, ops, profiler, static  # noqa: E402
from paddle_tpu_torch.errors import FatalError, InvalidArgumentError  # noqa: E402
from paddle_tpu_torch.flags import flag, set_flags  # noqa: E402
from paddle_tpu_torch.monitor import debug_server as dbg  # noqa: E402
from paddle_tpu_torch.monitor import flight_recorder as fr  # noqa: E402
from paddle_tpu_torch.runtime import compiled  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TESTS = counterparts.jax_tests("test_flight_recorder")
PURE = [
    "test_ring_buffer_eviction_and_indices",
    "test_record_collective_per_group_seq_and_fingerprint",
    "test_recorder_disabled_records_nothing", "test_dump_file_format",
    "test_default_dump_path_uses_flag_dir", "test_distinct_dump_reasons_never_clobber",
    "test_watchdog_trips_dumps_and_rearms", "test_watchdog_progress_prevents_trip",
    "test_start_watchdog_flag_gate", "test_excepthook_dump_and_chain", "test_sigusr1_dump",
    "test_first_divergence_in_sync_is_empty", "test_first_divergence_names_skipped_collective",
    "test_first_divergence_call_count_mismatch", "test_first_divergence_window_intersection",
    "test_exchange_and_diagnose_over_fake_channel", "test_exchange_reports_missing_ranks",
    "test_exchange_single_process_is_none",
    "test_exchange_shares_one_deadline_across_missing_ranks",
    "test_exchange_dead_low_rank_does_not_starve_available_peers",
    "test_exchange_survives_publish_failure", "test_debug_server_endpoints",
    "test_start_debug_server_flag_gate", "test_prometheus_help_lines_escaped",
    "test_prometheus_no_help_line_without_help", "test_prometheus_name_collision_is_an_error",
]
NAMESPACES = {
    "jax": counterparts.namespace(JAX_TESTS),
    "port": counterparts.namespace(JAX_TESTS, fr=fr, dbg=dbg, monitor=monitor, flag=flag,
                                   set_flags=set_flags, profiler=profiler),
}


@pytest.fixture(autouse=True)
def _clean():
    fr.reset_recorder()
    monitor.reset_registry(unregister=True)
    yield
    fr.reset_recorder()
    monitor.reset_registry(unregister=True)


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("test_name", PURE)
def test_jax_counterpart(test_name, pkg, request):
    counterparts.call(NAMESPACES[pkg], test_name, request)


def test_snapshot_and_dump_match_the_jax_layout(tmp_path, capsys):
    snaps = []
    for mod in (jfr, fr):
        rec = mod.FlightRecorder(capacity=4)
        for i in range(6):
            rec.record("probe", n=i)
        rec.record_collective("all_reduce", "dp", shape=(4,), dtype="float32", reduce_op="sum")
        snaps.append(rec.snapshot(reason="unit"))
    j, p = snaps
    assert set(p) == set(j)
    assert [set(e) for e in p["events"]] == [set(e) for e in j["events"]]
    assert [(e["kind"], e["i"]) for e in p["events"]] == [(e["kind"], e["i"]) for e in j["events"]]
    for k in ("capacity", "events_recorded", "dropped", "collective_tails", "reason"):
        assert p[k] == j[k], k
    path = fr.FlightRecorder(capacity=8).dump(path=str(tmp_path / "d.json"), reason="unit")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import debug_dump

    capsys.readouterr()
    assert debug_dump.main([path]) in (0, None)
    out = capsys.readouterr().out
    assert "reason: 'unit'" in out


@pytest.fixture
def _static_env():
    static.reset_default_programs()
    static.global_scope().clear()
    static.enable_static()
    yield
    static.disable_static()
    static.reset_default_programs()
    static.global_scope().clear()


def _tiny_train(lr=0.05):
    x = static.data("x", [4, 8], "float32")
    w = static.nn.create_parameter([8, 1], "float32")
    loss = ops.mean(ops.square(ops.matmul(x, w)))
    static.optimizer.Adam(learning_rate=lr).minimize(loss)
    exe = static.Executor("cpu")
    exe.run_startup()
    return exe, loss, np.random.RandomState(0).randn(4, 8).astype("float32")


def test_executor_run_events_with_cache_disposition(_static_env):
    """The port interprets on the CPU (``jit_cache`` uncaptured); the plan
    of value lifetimes is made once per program and fetches."""
    exe, loss, X = _tiny_train()
    fr.reset_recorder()
    exe.run(feed={"x": X}, fetch_list=[loss])
    exe.run(feed={"x": X}, fetch_list=[loss])
    begins = [e for e in fr.events() if e["kind"] == "executor_run_begin"]
    ends = [e for e in fr.events() if e["kind"] == "executor_run_end"]
    assert len(begins) == 2 and len(ends) == 2
    assert [(b["plan_cache"], b["jit_cache"]) for b in begins] == [
        ("miss", "uncaptured"), ("hit", "uncaptured")]
    assert begins[0]["program"] == begins[1]["program"]
    assert all(e["ok"] for e in ends)
    assert fr.last_progress_what() == "executor_run"


def test_executor_run_error_event(_static_env, monkeypatch):
    from paddle_tpu_torch.static import executor as pexec

    x = static.data("x", [3], "float32")
    y = ops.add(x, x)

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(pexec._BlockRunner, "_exec_op", boom)
    with pytest.raises(RuntimeError, match="boom"):
        static.Executor("cpu").run(feed={"x": np.ones(3, "float32")}, fetch_list=[y])
    (ev,) = [e for e in fr.events() if e["kind"] == "executor_run_error"]
    assert "boom" in ev["error"]
    assert not [e for e in fr.events() if e["kind"] == "executor_run_end"]


def test_flag_change_recorded():
    set_flags({"opprof_topk": 7})
    try:
        evs = [e for e in fr.events() if e["kind"] == "flag_change"]
        assert evs and evs[-1]["flag"] == "opprof_topk" and evs[-1]["value"] == "7"
    finally:
        set_flags({"opprof_topk": 10})


def _nan_program():
    x = static.data("x", [3], "float32")
    z = ops.add(ops.log(x), ops.full([3], 1.0))  # log of a negative input: nan
    return z, np.array([-1.0, 1.0, 2.0], np.float32)


@pytest.fixture
def _nan_flags():
    yield
    set_flags({"check_nan_inf": False, "check_nan_inf_action": "raise",
               "flight_recorder_dump_dir": ""})


def test_nan_action_warn_continues_and_counts(_static_env, _nan_flags):
    z, X = _nan_program()
    set_flags({"check_nan_inf": True, "check_nan_inf_action": "warn"})
    with pytest.warns(RuntimeWarning, match="check_nan_inf"):
        out = static.Executor("cpu").run(feed={"x": X}, fetch_list=[z])
    assert np.isnan(np.asarray(out[0])).any()
    assert monitor.counter("debug/nan_events").value == 1
    assert any(e["kind"] == "nan_inf" and e["action"] == "warn" for e in fr.events())


def test_nan_action_dump_writes_snapshot_then_raises(_static_env, _nan_flags, tmp_path):
    z, X = _nan_program()
    set_flags({"check_nan_inf": True, "check_nan_inf_action": "dump",
               "flight_recorder_dump_dir": str(tmp_path)})
    with pytest.raises(FatalError, match="check_nan_inf"):
        static.Executor("cpu").run(feed={"x": X}, fetch_list=[z])
    (dump,) = tmp_path.glob("paddle_tpu_flight_*.json")
    snap = json.loads(dump.read_text())
    assert snap["reason"].startswith("check_nan_inf:")
    assert any(e["kind"] == "executor_run_begin" for e in snap["events"])


def test_nan_action_invalid_value_is_loud(_static_env, _nan_flags):
    z, X = _nan_program()
    set_flags({"check_nan_inf": True, "check_nan_inf_action": "explode"})
    with pytest.raises(InvalidArgumentError, match="raise|warn|dump"):
        static.Executor("cpu").run(feed={"x": X}, fetch_list=[z])


def test_program_verify_and_memory_budget_events(_static_env):
    x = static.data("x", [2, 4], "float32")
    y = static.nn.fc(x, 3)
    exe = static.Executor("cpu")
    exe.run_startup()
    set_flags({"memory_budget_check": "warn", "device_peaks": "hbm_bytes=1e12"})
    try:
        exe.run(feed={"x": np.ones((2, 4), "float32")}, fetch_list=[y])
    finally:
        set_flags({"memory_budget_check": "warn", "device_peaks": ""})
    kinds = {e["kind"]: e for e in fr.events()}
    assert kinds["program_verify"]["ok"] is True
    mb = kinds["memory_budget"]
    assert mb["verdict"] == "ok" and mb["budget_bytes"] == int(1e12) and mb["peak_bytes"] > 0


def test_memory_plan_accuracy_event():
    from paddle_tpu_torch.analysis import memory as mem

    class _Plan:
        peak_bytes, baseline_bytes = 300, 100

    assert mem.note_actual(mem.MeasuredRun("sig", "executor", 400, 300), _Plan()) == 0.75
    ev = [e for e in fr.events() if e["kind"] == "plan_accuracy"][-1]
    assert ev["predicted_bytes"] == 300 and ev["actual_bytes"] == 400 and ev["ratio"] == 0.75


class _StandInGraph:
    def register_generator_state(self, gen):
        pass

    def replay(self):
        pass


def test_graph_store_capture_refusal_and_eviction_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)

    def graph(g, **kw):
        import contextlib

        return contextlib.nullcontext(g)

    monkeypatch.setattr(torch.cuda, "graph", graph)
    store = compiled.GraphStore("probe")
    set_flags({"compiled_cache_capacity": 1})
    try:
        x = torch.ones(2)
        store.capture(("a",), lambda t: t * 2, [x])
        store.capture(("b",), lambda t: t * 3, [x])

        def refuse(t):
            raise RuntimeError("cannot capture")

        with pytest.raises(compiled.CaptureError):
            store.capture(("c",), refuse, [x])
    finally:
        set_flags({"compiled_cache_capacity": 128})
    kinds = [e["kind"] for e in fr.events()]
    assert kinds.count("runtime_compile") == 2
    assert "runtime_cache_evict" in kinds and "runtime_capture_refused" in kinds


def test_series_overflow_event_once(monkeypatch):
    set_flags({"metrics_max_series": 2})
    try:
        c = monitor.counter("ovf/c")
        for t in "abcde":
            c.labels(tenant=t).inc()
    finally:
        set_flags({"metrics_max_series": 64})
    evs = [e for e in fr.events() if e["kind"] == "metric_series_overflow"]
    assert len(evs) == 1 and evs[0]["metric"] == "ovf/c" and evs[0]["max_series"] == 2


def test_clusterz_says_it_waits_for_the_multiprocess_runtime():
    from urllib.error import HTTPError
    from urllib.request import urlopen

    srv = dbg.DebugServer(port=0).start()
    try:
        with pytest.raises(HTTPError) as ei:
            urlopen(srv.url + "/clusterz")
        assert ei.value.code == 501
        assert json.loads(ei.value.read())["available"] is False
        for route in ("/costz", "/goodputz", "/sloz", "/profilez", "/tracez"):
            assert urlopen(srv.url + route).status == 200, route
    finally:
        srv.stop()
