"""The port's profiler and merged chrome trace against the JAX package's.

Every test of ``tests/test_profiler_export.py`` runs here twice, its body
and assertions unchanged, on ``paddle_tpu.profiler`` and on the port's
(host spans round-trip as chrome-trace JSON, the summary table and its
sort keys, spans straddling a stop, the counters' isolation between tests,
``tools/trace_summary.py`` over an export). Beyond them, on the port: the
same spans export the same event keys as the JAX profiler's; a
``torch.profiler`` session started by ``start_profiler`` writes its trace
in the JAX run layout, and ``export_merged_chrome_trace`` puts host spans,
that device trace (its clock re-based onto the host's), goodput phases and
opprof tracks in one file that ``tools/trace_summary.py`` reads; the JAX
test of merging a device-trace file, on the port.
"""
import gzip
import json
import os

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import profiler as jprofiler  # noqa: E402

import _port_counterparts as counterparts  # noqa: E402
from paddle_tpu_torch import monitor, profiler  # noqa: E402

JAX_TESTS = counterparts.jax_tests("test_profiler_export")
PURE = [n for n in vars(JAX_TESTS) if n.startswith("test_")]
NAMESPACES = {
    "jax": counterparts.namespace(JAX_TESTS),
    "port": counterparts.namespace(JAX_TESTS, profiler=profiler),
}


@pytest.fixture(autouse=True)
def _clean():
    """The port's counters and spans start and end each test empty (the
    suite's conftest resets the JAX profiler's)."""
    yield
    profiler.stop_profiler()
    profiler.reset_counters()
    profiler.reset_profiler()


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("test_name", PURE)
def test_jax_counterpart(test_name, pkg, request):
    counterparts.call(NAMESPACES[pkg], test_name, request)


def test_same_spans_export_the_same_event_keys(tmp_path):
    events = []
    for prof in (jprofiler, profiler):
        prof.reset_profiler()
        prof.start_profiler(state="CPU")
        with prof.RecordEvent("executor::run"):
            pass
        prof.stop_profiler(profile_path=str(tmp_path / "t.json"))
        events.append(json.load(open(tmp_path / "t.json"))["traceEvents"])
        prof.reset_profiler()
    j, p = events
    assert [sorted(e) for e in p] == [sorted(e) for e in j]
    assert [e["name"] for e in p] == [e["name"] for e in j]


def test_merged_trace_includes_device_trace_files(tmp_path):
    profiler.reset_profiler()
    profiler.start_profiler(state="CPU")
    with profiler.RecordEvent("host_side"):
        pass
    profiler.stop_profiler()
    run_dir = tmp_path / "plugins" / "profile" / "run1"
    os.makedirs(run_dir)
    dev_event = {"name": "fusion.42", "ph": "X", "ts": 1, "dur": 5, "pid": 7, "tid": 0}
    with gzip.open(run_dir / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": [dev_event]}, f)
    path = str(tmp_path / "merged.json")
    monitor.export_merged_chrome_trace(path, device_trace_dir=str(tmp_path))
    by_name = {e.get("name"): e for e in json.load(open(path))["traceEvents"]}
    assert "host_side" in by_name and "fusion.42" in by_name
    assert by_name["fusion.42"]["ts"] == by_name["host_side"]["ts"]


def test_torch_profiler_session_merges_and_summarizes(tmp_path, capsys):
    """``start_profiler`` (not ``state="CPU"``) runs ``torch.profiler``;
    its trace lands in the JAX layout and merges with the host spans,
    the goodput track and the opprof tracks into a file
    ``tools/trace_summary.py`` reads."""
    profiler.start_profiler(trace_dir=str(tmp_path / "dev"))
    with profiler.RecordEvent("executor::run"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    profiler.stop_profiler()
    assert profiler.device_trace_dir() == str(tmp_path / "dev")
    files = list((tmp_path / "dev" / "plugins" / "profile").glob("*/*.trace.json.gz"))
    assert len(files) == 1
    monitor.opprof.record_profile({"name": "p", "ops": [
        {"scope": "mul#0/0", "replayed": True, "time_us": 3.0}]})
    try:
        path = str(tmp_path / "merged.json")
        monitor.export_merged_chrome_trace(path)
    finally:
        monitor.opprof.reset_profiles()
    events = json.load(open(path))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"executor::run", "aten::mm", "mul#0/0"} <= names
    ts = JAX_TESTS._load_trace_summary()
    assert ts.main([path]) == 0
    out = capsys.readouterr().out
    assert "executor::run" in out and "aten::mm" in out


def test_executor_phases_are_host_spans():
    from paddle_tpu_torch import static

    import numpy as np

    static.enable_static()
    static.reset_default_programs()
    scope = static.Scope()
    try:
        x = static.data("x", [2, 3], "float32")
        y = static.nn.fc(x, 4)
        exe = static.Executor("cpu")
        exe.run_startup(scope=scope)
        profiler.start_profiler(state="CPU")
        exe.run(feed={"x": np.ones((2, 3), "float32")}, fetch_list=[y], scope=scope)
        profiler.stop_profiler()
    finally:
        static.disable_static()
        static.reset_default_programs()
    names = {e["name"] for e in profiler.host_events()}
    assert {"executor::feed", "executor::program_verify", "executor::ir_opt",
            "executor::memory_plan", "executor::run"} <= names
