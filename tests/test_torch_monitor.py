"""The port's metrics registry and Prometheus text against the JAX package's.

The same observations go into both registries (``paddle_tpu.monitor`` and
``paddle_tpu_torch.monitor``): snapshots equal key for key (bounds, counts,
sums, labeled series), ``histogram_quantile`` equal, merges equal to the
pooled golden across packages, the series cap alike, and every Prometheus
line of a metric equal to the JAX line.

The TrainingMonitor and memory-gauge tests of ``tests/test_monitor.py`` run
twice, bodies unchanged, on the JAX monitor and on the port's (the periodic
line and its fields, the interval flag and silence, a failed step
discarded, a step end without a begin, the gauges of fake devices and of
devices that publish nothing); beyond them, on the port: the compile-event
listener counts graph captures into the line's ``compiles``, and a CPU
train step under a monitor feeds ``mfu=``, ``hbm_bw_util=`` and
``roofline=`` from its counted cost.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from paddle_tpu import flags as jflags  # noqa: E402
from paddle_tpu import monitor as jmon  # noqa: E402

import _port_counterparts as counterparts  # noqa: E402
import paddle_tpu_torch  # noqa: E402
from paddle_tpu_torch import flags as pflags  # noqa: E402
from paddle_tpu_torch import monitor as pmon  # noqa: E402

BOUNDS = (1.0, 5.0, 10.0, 50.0, 100.0)


@pytest.fixture(autouse=True)
def _clean_registries():
    """Both registries start empty (the JAX one is also reset after every
    test by the suite's conftest)."""
    jmon.reset_registry(unregister=True)
    pmon.reset_registry(unregister=True)
    yield
    jmon.reset_registry(unregister=True)
    pmon.reset_registry(unregister=True)


def _both(fn):
    return fn(jmon), fn(pmon)


def _feed(mon, values, tenants=("a", "b", "c")):
    """The same stream of events into one package's registry."""
    h = mon.histogram("serving/e2e_ms")
    hb = mon.histogram("serving/custom_ms", buckets=BOUNDS, help="a custom ladder")
    c = mon.counter("serving/requests_total", help="requests\nwith a newline \\ and a slash")
    g = mon.gauge("serving/queue_depth")
    for i, v in enumerate(values):
        t = tenants[i % len(tenants)]
        h.labels(kind="predict", tenant=t).observe(v)
        hb.observe(v)
        c.labels(kind="predict").inc()
        c.inc(2)
        g.set(float(i))
        g.labels(kind="predict").set(v)
    return ["serving/e2e_ms", "serving/custom_ms", "serving/requests_total",
            "serving/queue_depth"]


def _values(n=300, seed=7):
    return np.random.RandomState(seed).gamma(2.0, 9.0, size=n)


def test_snapshots_equal_key_for_key():
    values = _values()
    names, _ = _both(lambda m: _feed(m, values))
    js, ps = jmon.registry_snapshot(), pmon.registry_snapshot()
    for name in names:
        assert ps[name] == js[name], name
    assert set(ps) == set(names)
    h = ps["serving/e2e_ms"]
    assert h["bounds"] == list(pmon.DEFAULT_BUCKETS) == list(jmon.registry.DEFAULT_BUCKETS)
    assert h["count"] == len(values) == sum(s["count"] for s in h["series"].values())
    assert set(h["series"]) == {f'kind="predict",tenant="{t}"' for t in "abc"}


@pytest.mark.parametrize("q", [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantile_equal(q):
    values = _values(seed=3)
    jh, ph = _both(lambda m: m.histogram("x_ms", buckets=BOUNDS))
    for v in values:
        jh.observe(v)
        ph.observe(v)
    assert pmon.histogram_quantile(ph, q) == jmon.histogram_quantile(jh, q)


def test_quantile_of_nothing_is_none_and_q_is_checked():
    jh, ph = _both(lambda m: m.histogram("empty_ms"))
    assert pmon.histogram_quantile(ph, 0.5) is None is jmon.histogram_quantile(jh, 0.5)
    with pytest.raises(ValueError):
        pmon.histogram_quantile(ph, 1.5)


def _split(mon, values, shards):
    hs = [mon.Histogram(f"shard{i}", buckets=BOUNDS) for i in range(shards)]
    pooled = mon.Histogram("pooled", buckets=BOUNDS)
    for i, v in enumerate(values):
        hs[i % shards].labels(tenant=str(i % 2)).observe(v)
        pooled.labels(tenant=str(i % 2)).observe(v)
    return hs, pooled


@pytest.mark.parametrize("order", ["jax_first", "port_first"])
def test_merge_across_packages_equals_the_pooled_golden(order):
    """A merge of snapshots from both packages (either first) is exactly the
    pooled histogram, per labeled series too, and equals the JAX merge."""
    values = _values(600, seed=11)
    jhs, _ = _split(jmon, values, 3)
    phs, pooled = _split(pmon, values, 3)
    snaps = [jhs[0].snapshot(), phs[1].snapshot(), jhs[2].snapshot()]
    if order == "port_first":
        snaps = [phs[0].snapshot(), jhs[1].snapshot(), phs[2].snapshot()]
    for merge in (pmon.merge_histogram_snapshots, jmon.merge_histogram_snapshots):
        merged = merge(snaps)
        assert merged.count == pooled.count == 600
        assert merged.bucket_counts() == pooled.bucket_counts()
        for q in (0.5, 0.9, 0.99):
            assert pmon.histogram_quantile(merged, q) == pmon.histogram_quantile(pooled, q)
        series = merged.series()
        assert set(series) == set(pooled.series())
        for sel, child in pooled.series().items():
            assert series[sel].bucket_counts() == child.bucket_counts()
    assert pmon.merge_histogram_snapshots(snaps).snapshot() == \
        jmon.merge_histogram_snapshots(snaps).snapshot()


def test_merge_refuses_what_jax_refuses():
    a = pmon.Histogram("a", buckets=(1.0, 2.0))
    b = jmon.Histogram("b", buckets=(1.0, 3.0))
    for merge in (pmon.merge_histogram_snapshots, jmon.merge_histogram_snapshots):
        with pytest.raises(ValueError, match="bounds mismatch"):
            merge([a.snapshot(), b.snapshot()])
        with pytest.raises(ValueError, match=">= 1 snapshot"):
            merge([])
        bad = a.snapshot()
        bad["buckets"] = bad["buckets"][:-1]
        with pytest.raises(ValueError, match="expected"):
            merge([a.snapshot(), bad])


@pytest.mark.parametrize("kind", ["counter", "histogram", "gauge"])
def test_series_cap_collapses_alike(kind, monkeypatch):
    """Past ``FLAGS_metrics_max_series`` new label sets land in the shared
    "other" series in both packages; the parent total stays exact."""
    monkeypatch.setattr(jflags._REGISTRY["metrics_max_series"], "value", 3)
    monkeypatch.setattr(pflags._REGISTRY["metrics_max_series"], "value", 3)
    for mon in (jmon, pmon):
        m = getattr(mon, kind)(f"capped_{kind}")
        for i in range(7):
            child = m.labels(tenant=f"t{i}")
            if kind == "counter":
                child.inc(i + 1)
            elif kind == "histogram":
                child.observe(float(i))
            else:
                child.set(float(i))
    js, ps = jmon.registry_snapshot(), pmon.registry_snapshot()
    name = f"capped_{kind}"
    assert ps[name] == js[name]
    assert 'tenant="other"' in ps[name]["series"] and len(ps[name]["series"]) == 4


def test_label_rules_match():
    for mon in (jmon, pmon):
        c = mon.counter("lab_total")
        c.labels(kind="a")
        with pytest.raises(ValueError, match="fixed by its first use"):
            c.labels(tenant="x")
        with pytest.raises(ValueError, match="labeled child"):
            c.labels(kind="a").labels(kind="b")
        with pytest.raises(ValueError, match="at least one"):
            c.labels()
        with pytest.raises(TypeError, match="already registered"):
            mon.gauge("lab_total")
        mon.histogram("h_ms", buckets=(1.0, 2.0))
        with pytest.raises(ValueError, match="already registered with bounds"):
            mon.histogram("h_ms", buckets=(1.0, 3.0))
        g = mon.gauge("g")
        g.set(5.0)
        g.labels(kind="a").set(7.0)
        assert g.value == 5.0  # gauge children do not propagate


def _lines_of(text, pname):
    return [ln for ln in text.splitlines()
            if ln.split("{")[0].split(" ")[0].startswith(pname)
            or ln.startswith((f"# TYPE {pname} ", f"# HELP {pname} "))]


def test_prometheus_lines_equal_the_jax_lines():
    values = _values(50, seed=5)
    names, _ = _both(lambda m: _feed(m, values))
    jtext = jmon.prometheus_text()
    ptext = pmon.prometheus_text()
    assert pmon.PROMETHEUS_CONTENT_TYPE == jmon.PROMETHEUS_CONTENT_TYPE
    for name in names:
        pname = name.replace("/", "_")
        got = _lines_of(ptext, pname)
        assert got and got == _lines_of(jtext, pname), name
    assert ptext.endswith("\n")
    # only the registry: every sample line belongs to one of its families
    assert {ln.split(" ")[2] for ln in ptext.splitlines() if ln.startswith("# TYPE")} == \
        {n.replace("/", "_") for n in names}


def test_prometheus_refuses_a_name_collision():
    pmon.counter("a/b")
    pmon.counter("a:b")
    with pytest.raises(ValueError, match="collision"):
        pmon.prometheus_text()


def test_special_values_and_reset():
    for mon in (jmon, pmon):
        mon.gauge("inf").set(float("inf"))
        mon.gauge("nan").set(float("nan"))
        mon.gauge("neg").set(float("-inf"))
    assert _lines_of(pmon.prometheus_text(), "inf") == _lines_of(jmon.prometheus_text(), "inf")
    text = pmon.prometheus_text()
    assert "nan NaN" in text and "neg -Inf" in text
    c = pmon.counter("zeroed_total")
    c.labels(kind="a").inc(3)
    pmon.reset_registry()
    assert c.value == 0 and c.labels(kind="a").value == 0
    assert "zeroed_total" in pmon.all_metrics()
    pmon.reset_registry(unregister=True)
    assert pmon.all_metrics() == {}


JAX_TESTS = counterparts.jax_tests("test_monitor")
MONITOR_TESTS = [
    "test_hbm_gauge_population", "test_hbm_gauges_skip_statless_backends",
    "test_hbm_gauges_real_devices_never_raise", "test_training_monitor_periodic_line_fields",
    "test_training_monitor_interval_flag_and_silence",
    "test_training_monitor_step_end_without_begin_raises",
    "test_training_monitor_failed_step_is_discarded",
]
NAMESPACES = {
    "jax": counterparts.namespace(JAX_TESTS),
    "port": counterparts.namespace(JAX_TESTS, monitor=pmon, paddle=paddle_tpu_torch),
}


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("test_name", MONITOR_TESTS)
def test_jax_counterpart(test_name, pkg, request):
    counterparts.call(NAMESPACES[pkg], test_name, request)


def test_the_compile_listener_counts_graph_captures(monkeypatch):
    import contextlib

    import torch

    from paddle_tpu_torch.runtime import compiled

    class _Graph:
        def register_generator_state(self, gen):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, **kw: contextlib.nullcontext(g))
    store = compiled.GraphStore("probe")
    lines = []
    mon = pmon.TrainingMonitor("cap", interval=1, log_fn=lines.append)
    with mon.step():
        store.capture(("during",), lambda t: t, [torch.ones(1)])
    assert pmon.counter("graph/compile").value == 1
    assert pmon.histogram("graph/compile/duration_ms").count == 1
    assert " compiles=1 " in lines[-1]
    mon.close()


def test_monitored_cpu_train_step_reports_utilization():
    import re

    import torch

    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.optimizer import Momentum

    torch.manual_seed(0)
    model = torch.nn.Linear(8, 4)
    step = train_step(model, Momentum(learning_rate=0.1, parameters=model.parameters()),
                      lambda m, x, t: ((m(x) - t) ** 2).mean(), device="cpu")
    x, t = np.ones((4, 8), "f4"), np.zeros((4, 4), "f4")
    lines = []
    mon = pmon.TrainingMonitor("util", interval=3, log_fn=lines.append)
    for _ in range(3):
        with mon.step(examples=4):
            float(step(x, t)["loss"])
    (line,) = lines
    m = re.search(r"mfu=(\S+) hbm_bw_util=(\S+) roofline=(\S+)$", line)
    assert m and float(m.group(1)) > 0 and float(m.group(2)) > 0
    assert m.group(3) in ("compute-bound", "memory-bound")
    rec = pmon.cost_model.latest_record("train_step")
    assert pmon.counter("cost/executed_flops").value == 3 * rec.flops
    mon.close()
