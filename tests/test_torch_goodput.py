"""The port's goodput ledger against the JAX package's.

Every test of ``tests/test_goodput.py`` but the two of ``bench.py``'s trend
comparator runs here twice, its body, fake clock and assertions unchanged:
on ``paddle_tpu.monitor.goodput`` and with the port's ledger, registry,
flight recorder, SLO engine, TrainingMonitor and flags in its place
(exclusive phases and conservation, background work, aborts, the
``GOODPUT.json`` sidecar and lost work after a resume, corrupt sidecars,
labeled counters, the goodput line, the chrome track, ``/goodputz``, the
input-wait feed, the monitor's window and goodput lines, the goodput SLO).
Beyond them: the same phases on both packages' ledgers give the same
snapshot key for key and value for value, and a graph capture is the
ledger's ``compile`` phase.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.monitor import goodput as jgp  # noqa: E402

import _port_counterparts as counterparts  # noqa: E402
from paddle_tpu_torch import monitor  # noqa: E402
from paddle_tpu_torch.flags import get_flags, set_flags  # noqa: E402
from paddle_tpu_torch.monitor import flight_recorder as fr  # noqa: E402
from paddle_tpu_torch.monitor import goodput as gp  # noqa: E402
from paddle_tpu_torch.monitor import registry as _reg  # noqa: E402
from paddle_tpu_torch.monitor import slo as slo_mod  # noqa: E402
from paddle_tpu_torch.monitor.training_monitor import _fmt_util  # noqa: E402
from paddle_tpu_torch.runtime import compiled  # noqa: E402

JAX_TESTS = counterparts.jax_tests("test_goodput")
PURE = [name for name in vars(JAX_TESTS)
        if name.startswith("test_") and "bench_trend" not in name]
NAMESPACES = {
    "jax": counterparts.namespace(JAX_TESTS),
    "port": counterparts.namespace(JAX_TESTS, gp=gp, monitor=monitor, fr=fr, _reg=_reg,
                                   slo_mod=slo_mod, set_flags=set_flags, get_flags=get_flags,
                                   _fmt_util=_fmt_util),
}


def _fixtures(g):
    """The JAX module's ``clock`` and ``ledger`` fixtures over ``g``."""
    return {"clock": lambda get: g["FakeClock"](),
            "ledger": lambda get: g["gp"].GoodputLedger(dir=None, clock=get("clock"))}


@pytest.fixture(autouse=True)
def _clean():
    gp.reset_ledger()
    monitor.reset_registry(unregister=True)
    yield
    gp.reset_ledger()
    monitor.reset_registry(unregister=True)


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("test_name", PURE)
def test_jax_counterpart(test_name, pkg, request):
    g = NAMESPACES[pkg]
    counterparts.call(g, test_name, request, _fixtures(g))


def _drive(mod, clock):
    led = mod.GoodputLedger(dir=None, clock=clock)
    for s in range(3):
        led.step_begin()
        clock.advance(1.0)
        with led.span("compile"):
            clock.advance(0.25)
        led.note_phase("input_wait", 0.125)
        led.step_commit(global_step=s)
    clock.advance(0.5)
    led.step_begin()
    clock.advance(0.75)
    led.step_abort()
    return led


def test_same_phases_make_the_same_snapshot():
    snaps = []
    for mod in (jgp, gp):
        clock = JAX_TESTS.FakeClock()
        snaps.append(_drive(mod, clock).snapshot())
    j, p = snaps
    assert set(p) == set(j)
    for key in j:
        if key not in ("started_unix", "wall_start_unix", "time"):
            assert p[key] == j[key], key


def test_a_capture_is_the_compile_phase(monkeypatch):
    class _Graph:
        def register_generator_state(self, gen):
            pass

    clock = JAX_TESTS.FakeClock()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)

    @contextlib.contextmanager
    def graph(g, **kw):
        clock.advance(0.5)  # the capture's time
        yield g

    monkeypatch.setattr(torch.cuda, "graph", graph)
    led = gp.start_ledger(clock=clock)
    led.step_begin()
    clock.advance(1.0)
    compiled.GraphStore("probe").capture(("s",), lambda t: t + 1, [torch.ones(2)])
    led.step_commit(global_step=0)
    phases = led.snapshot()["phases"]
    assert phases["compile"] == pytest.approx(0.5)
    assert phases["compute"] == pytest.approx(1.0)
