"""The port's SLO engine against the JAX package's.

Every test of ``tests/test_slo.py`` that needs no JAX serving fleet runs
here twice, its body and assertions unchanged: on
``paddle_tpu.monitor.slo`` and with the port's engine, registry, flight
recorder, errors and flags in its place (labeled families and their
aggregation, the series bound and its flight event, labeled Prometheus
series, the label-aware merge, selector and objective parsing, validation,
the latency and error-mode burn-rate goldens, one ``slo_burn`` event per
alert transition, ``install_from_flags``). The autoscaler and the
two-process ``/fleetz`` tests wait for ports of the scaler and the
multi-process fleet. Beyond them: the same samples make the same
``/sloz`` payload on both engines, and the port's backend CLI and router
install ``FLAGS_slo_objectives`` before serving.
"""
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu  # noqa: E402
from paddle_tpu.monitor import flight_recorder as jfr  # noqa: E402
from paddle_tpu.monitor import registry as jreg  # noqa: E402
from paddle_tpu.monitor import slo as jslo  # noqa: E402

import _port_counterparts as counterparts  # noqa: E402
import paddle_tpu_torch  # noqa: E402
from paddle_tpu_torch import monitor  # noqa: E402
from paddle_tpu_torch.errors import InvalidArgumentError  # noqa: E402
from paddle_tpu_torch.flags import set_flags  # noqa: E402
from paddle_tpu_torch.monitor import flight_recorder as fr  # noqa: E402
from paddle_tpu_torch.monitor import registry as preg  # noqa: E402
from paddle_tpu_torch.monitor import slo  # noqa: E402

JAX_TESTS = counterparts.jax_tests("test_slo")
PURE = [name for name in vars(JAX_TESTS)
        if name.startswith("test_") and "scaler" not in name and "fleetz" not in name]
NAMESPACES = {
    "jax": counterparts.namespace(JAX_TESTS),
    "port": counterparts.namespace(JAX_TESTS, monitor=monitor, slo_mod=slo, _flight=fr,
                                   InvalidArgumentError=InvalidArgumentError,
                                   paddle=paddle_tpu_torch,
                                   OVERFLOW_LABEL_VALUE=preg.OVERFLOW_LABEL_VALUE),
}


@pytest.fixture(autouse=True)
def _clean():
    for mod in (slo, jslo):
        mod.reset_engine()
    monitor.reset_registry(unregister=True)
    # the flight events of the tests that ran before in this process (another
    # family's series overflow, say) are not this test's
    for rec in (fr, jfr):
        rec.reset_recorder()
    yield
    for mod in (slo, jslo):
        mod.reset_engine()
    monitor.reset_registry(unregister=True)


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("test_name", PURE)
def test_jax_counterpart(test_name, pkg, request):
    counterparts.call(NAMESPACES[pkg], test_name, request)


def _feed(reg, mod):
    h = reg.histogram("t_slo/parity_ms", buckets=(10.0, 100.0))
    eng = mod.SLOEngine(clock=lambda: 0.0)
    eng.add(mod.SLO("lat", "t_slo/parity_ms{kind=predict}", threshold_ms=10.0,
                    target=0.9, window_s=600.0))
    eng.sample(now=0.0)
    for i, v in enumerate((5.0, 50.0, 1.0, 500.0, 7.0, 70.0)):
        h.labels(kind="predict" if i % 3 else "generate").observe(v)
    for t in (10.0, 20.0, 50.0):
        eng.sample(now=t)
    return eng.sloz_payload(now=50.0)


def test_same_samples_make_the_same_sloz():
    jreg.reset_registry(unregister=True)
    try:
        j = _feed(jreg, jslo)
        p = _feed(preg, slo)
    finally:
        jreg.reset_registry(unregister=True)
    assert set(p) == set(j) and len(p["slos"]) == len(j["slos"]) == 1
    assert p["slos"] == j["slos"]
    assert set(p["sampler"]) == set(j["sampler"])
    assert set(slo.sloz_payload()) == set(jslo.sloz_payload())


def test_backend_and_router_entry_points_install_the_flags(monkeypatch):
    """Both CLIs call ``slo.install_from_flags()`` before they serve."""
    from paddle_tpu_torch.serving import backend, router

    seen = []
    monkeypatch.setattr(slo, "install_from_flags", lambda *a, **k: seen.append("slo") or [])

    class _Stop(Exception):
        pass

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(backend, "build_server", lambda args: type(
        "S", (), {"start": stop})())
    with pytest.raises(_Stop):
        backend.main(["--kind", "predict", "--model-dir", "nowhere", "--device", "cpu"])
    monkeypatch.setattr(router, "Router", stop)
    with pytest.raises(_Stop):
        router.main(["--backend", "http://127.0.0.1:1"])
    assert seen == ["slo", "slo"]


def test_objectives_from_flags_serve_on_sloz():
    set_flags({"slo_objectives": "p99|serving/e2e_ms{kind=predict}|threshold_ms=250|target=0.99"})
    try:
        installed = slo.install_from_flags(start_sampler=False)
        assert [s.name for s in installed] == ["p99"]
        rows = slo.sloz_payload()["slos"]
        assert [r["name"] for r in rows] == ["p99"]
    finally:
        set_flags({"slo_objectives": ""})
    assert paddle_tpu.get_flags("slo_objectives")["slo_objectives"] == ""
