"""Port parity: ``FLAGS_check_nan_inf`` on the train step and the static executor.

- The train step's four verdicts against the JAX step's (``checkify``
  with ``float_checks``) on a ``Linear(4, 2)`` under SGD: a clean batch, a
  batch with an inf, a batch with a NaN and lr = inf. Only the NaN raises
  ``FatalError``, naming the op that made it (``aten::mm`` where the JAX
  step names ``dot_general``); the state after each call equals the JAX
  step's: bit for bit after the raise (the pre-step state), within 4 ulps
  of the largest entry after a step (XLA's fusion of the update).
- The three actions: ``raise`` leaves parameters, accumulators and both
  step counts as before the step; ``warn`` keeps the new state, warns and
  counts the event; ``dump`` writes a flight-recorder snapshot, then
  raises ``FatalError`` with the state restored; any other value raises
  ``InvalidArgumentError``.
- A hand-written kernel's output is checked under the kernel's name
  (through a stub wrapper on the CPU: its NaN would otherwise be blamed on
  the next aten op).
- The static executor's post-run scan names the same variable and op as
  the JAX executor's, in the same message, and leaves the scope as before
  the run.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jax_opt  # noqa: E402
import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import flags as jflags  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402

from paddle_tpu_torch import convert, ops, static  # noqa: E402
from paddle_tpu_torch import flags  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.errors import FatalError, InvalidArgumentError  # noqa: E402
from paddle_tpu_torch.framework import nan_inf  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402
from paddle_tpu_torch.ops.cuda import _tally  # noqa: E402
from paddle_tpu_torch.ops.cuda import layernorm_residual  # noqa: E402

torch.set_num_threads(1)

PREFIX = "check_nan_inf: non-finite value produced inside the train step: nan generated by " \
         "primitive: "


@pytest.fixture
def check_on(monkeypatch):
    monkeypatch.setattr(flags._REGISTRY["check_nan_inf"], "value", True)
    jflags.set_flags({"check_nan_inf": True})
    yield lambda action: (monkeypatch.setattr(flags._REGISTRY["check_nan_inf_action"], "value",
                                              action))
    jflags.set_flags({"check_nan_inf": False})


def _weights():
    rng = np.random.RandomState(0)
    return rng.randn(4, 2).astype("f4"), rng.randn(2).astype("f4")


def _mse(m, x, t):
    return ((m(x) - t) ** 2).mean()


def _jax_step(lr):
    w, b = _weights()
    jm = paddle.nn.Linear(4, 2)
    jm.weight._array, jm.bias._array = jnp.asarray(w), jnp.asarray(b)
    return jax_jit.train_step(jm, jax_opt.SGD(lr, parameters=jm.parameters()), _mse)


def _port_step(lr, opt="sgd"):
    w, b = _weights()
    tm = pnn.Linear(4, 2)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(w))
        tm.bias.copy_(torch.from_numpy(b))
    o = (port_opt.SGD(lr, parameters=tm.parameters()) if opt == "sgd"
         else port_opt.Adam(lr, parameters=tm.parameters()))
    return train_step(tm, o, _mse, jit=True, device="cpu")


def _batch(case):
    x, t = np.ones((3, 4), "f4"), np.zeros((3, 2), "f4")
    if case == "inf_input":
        x[0, 0] = np.inf
    if case == "nan_input":
        x[0, 0] = np.nan
    return x, t


def _verdict(fn):
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 — the verdict is the exception's type and text
        return e


@pytest.mark.parametrize("case", ["clean", "inf_input", "nan_input", "inf_lr"])
def test_verdict_and_state_match_the_jax_step(case, check_on):
    lr = float("inf") if case == "inf_lr" else 0.1
    x, t = _batch(case)
    jstep, tstep = _jax_step(lr), _port_step(lr)
    jerr = _verdict(lambda: jstep(x, t))
    terr = _verdict(lambda: tstep(x, t))
    assert (jerr is None) == (terr is None) == (case != "nan_input"), (jerr, terr)
    if case == "nan_input":
        assert type(jerr).__name__ == type(terr).__name__ == "FatalError"
        jmsg, tmsg = jerr.raw_message, terr.raw_message
        assert jmsg.startswith(PREFIX + "dot_general.")
        assert tmsg == PREFIX + "aten::mm."
    state = jstep.state["params"]
    for name in ("weight", "bias"):
        got, want = getattr(tstep.model, name).detach().numpy(), np.asarray(state[name])
        if case == "nan_input":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            ulp = float(np.spacing(np.float32(np.abs(want[np.isfinite(want)]).max(initial=1))))
            np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp, err_msg=name)
    steps = 0 if case == "nan_input" else 1
    assert int(np.asarray(jstep.state["opt"]["step"])) == steps
    assert tstep.optimizer._global_step == int(tstep.optimizer._step_t) == steps


def test_raise_leaves_the_whole_state_as_before(check_on):
    """Adam, two clean steps, then a NaN batch: parameters, moments and
    both step counts are bit-equal to the snapshot, and a clean step after
    it continues as a run that never saw the NaN batch."""
    tstep, ref = _port_step(0.01, "adam"), _port_step(0.01, "adam")
    clean = _batch("clean")
    for s in (tstep, ref):
        s(*clean)
        s(*clean)
    snap = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in tstep.optimizer.state_dict().items()}
    params = [p.detach().clone() for p in tstep.model.parameters()]
    with pytest.raises(FatalError, match=r"primitive: aten::mm\."):
        tstep(*_batch("nan_input"))
    assert tstep.optimizer._global_step == int(tstep.optimizer._step_t) == 2
    for k, v in tstep.optimizer.state_dict().items():
        assert torch.equal(v, snap[k]) if isinstance(v, torch.Tensor) else v == snap[k], k
    assert all(torch.equal(p, q) for p, q in zip(tstep.model.parameters(), params))
    tstep(*clean)
    ref(*clean)
    assert all(torch.equal(p, q) for p, q in zip(tstep.model.parameters(), ref.model.parameters()))


def test_warn_keeps_the_new_state_and_counts(check_on):
    check_on("warn")
    tstep = _port_step(0.1)
    before = nan_inf.nan_events()
    with pytest.warns(RuntimeWarning, match="aten::mm"):
        tstep(*_batch("nan_input"))
    assert nan_inf.nan_events() == before + 1
    assert tstep.optimizer._global_step == 1
    assert torch.isnan(tstep.model.weight).any()


def test_dump_waits_for_the_flight_recorder_and_restores(check_on, monkeypatch, tmp_path):
    """``dump`` writes the flight-recorder snapshot (a ``nan_inf`` event in
    it), then raises as ``raise`` does, the state restored."""
    check_on("dump")
    monkeypatch.setattr(flags._REGISTRY["flight_recorder_dump_dir"], "value", str(tmp_path))
    tstep = _port_step(0.1)
    w = tstep.model.weight.detach().clone()
    with pytest.raises(FatalError, match="aten::mm"):
        tstep(*_batch("nan_input"))
    assert torch.equal(tstep.model.weight, w) and tstep.optimizer._global_step == 0
    (dump,) = tmp_path.glob("paddle_tpu_flight_rank*_check_nan_inf_train_step.json")
    events = json.loads(dump.read_text())["events"]
    assert events[-1]["kind"] == "nan_inf" and events[-1]["action"] == "dump"


def test_other_action_is_invalid(check_on):
    check_on("explode")
    tstep = _port_step(0.1)
    with pytest.raises(InvalidArgumentError, match="raise\\|warn\\|dump"):
        tstep(*_batch("nan_input"))
    tstep(*_batch("clean"))  # a clean step never reads the action


def test_the_check_sees_the_backward_and_the_update(check_on):
    """The checked step lists the forward's, the backward's and the
    update's ops, in order, and its verdict is rewritten each call."""
    tstep = _port_step(0.1)
    tstep(*_batch("clean"))
    names = tstep._nan_names
    assert "aten::mm" in names and "aten::mse_loss" not in names
    assert names.count("aten::mm") == 2  # the forward's, and the backward's for the weight
    assert names.index("aten::mm") < len(names) - 1
    assert not bool(tstep._nan_found)
    with pytest.raises(FatalError):
        tstep(*_batch("nan_input"))
    tstep(*_batch("clean"))
    assert not bool(tstep._nan_found)


def _stub_kernel(x, checked):
    """A stand-in for a hand-written kernel's wrapper: its output is
    written outside aten (as a ctypes launch writes it), then handed to the
    check under the count of ``layernorm_residual_fwd``."""
    out = torch.from_numpy(np.full(x.shape, np.nan, "f4"))
    if checked:
        _tally.check_outputs(vars(layernorm_residual), "LAUNCHES", out)
    return out


@pytest.mark.parametrize("checked", [True, False], ids=["wrapper_checks", "control"])
def test_a_kernels_nan_is_named_after_the_kernel(checked):
    """With the wrapper's call the NaN is the kernel's; without it (the
    control) the next aten op that reads it takes the blame."""
    x = torch.ones(2, 3)
    with nan_inf.NanCheck() as check:
        y = _stub_kernel(x, checked) * 2.0 + x
    found, first = torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.int64)
    check.verdict_into(found, first)
    assert bool(found) and torch.isnan(y).all()
    assert check.names[int(first)] == ("layernorm_residual_fwd" if checked else "aten::mul")


def test_no_check_outside_a_nan_check():
    out = torch.full((2,), float("nan"))
    _tally.check_outputs(vars(layernorm_residual), "LAUNCHES", out)  # no mode: nothing happens


# -- the static executor -----------------------------------------------------------------


@pytest.fixture
def both_static():
    for st in (jstatic, static):
        st.enable_static()
        st.reset_default_programs()
        st.global_scope().clear()
    yield
    for st in (jstatic, static):
        st.disable_static()
        st.reset_default_programs()
        st.global_scope().clear()


def _program(st, op_mod):
    x = st.data("x", [None, 3], "float32")
    h = st.nn.fc(x, 2)
    loss = op_mod.mean(op_mod.square(h))
    st.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return h, loss


@pytest.mark.parametrize("fetch", ["loss", "hidden"])
def test_executor_scan_names_the_jax_executors_variable(fetch, both_static, check_on):
    outs = [_program(st, m) for st, m in ((jstatic, jops), (static, ops))]
    jexe = jstatic.Executor()
    jexe.run_startup()
    jscope = jstatic.global_scope()
    convert.scope_from_numpy({n: np.asarray(jscope.get(n)) for n in jscope.var_names()},
                             scope=static.global_scope(), device="cpu")
    texe = static.Executor("cpu")
    feed = {"x": np.array([[1.0, np.nan, 2.0], [0.5, 0.5, 0.5]], "f4")}
    k = 1 if fetch == "loss" else 0
    scope = static.global_scope()
    before = {n: scope.numpy(n).copy() for n in scope.var_names()}
    with pytest.raises(Exception) as jerr:
        jexe.run(jstatic.default_main_program(), feed=feed, fetch_list=[outs[0][k]])
    with pytest.raises(FatalError) as terr:
        texe.run(static.default_main_program(), feed=feed, fetch_list=[outs[1][k]])
    assert type(jerr.value).__name__ == "FatalError"
    assert str(terr.value) == str(jerr.value)
    assert "contains NaN/Inf after the block ran" in str(terr.value)
    for n, v in before.items():
        np.testing.assert_array_equal(scope.numpy(n), v, err_msg=n)


def test_executor_scan_passes_a_clean_run_and_writes_back(both_static, check_on):
    _, loss = _program(static, ops)
    texe = static.Executor("cpu")
    texe.run_startup()
    scope = static.global_scope()
    w = scope.numpy("param_0").copy()
    texe.run(static.default_main_program(), feed={"x": np.ones((2, 3), "f4")}, fetch_list=[loss])
    assert not np.array_equal(scope.numpy("param_0"), w)


# -- the captured paths (CUDA graphs replaced by stand-ins that run their body) --------


class _ReplayingGraph:
    """``torch.cuda.CUDAGraph``'s surface; a replay runs the captured body."""

    def __init__(self):
        self.body = None

    def register_generator_state(self, gen):
        pass

    def replay(self):
        self.body()


def _write(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    else:
        for d, s in zip(dst, src):
            _write(d, s)


@pytest.fixture
def graphs(monkeypatch):
    import contextlib

    from paddle_tpu_torch.framework import jit as port_jit
    from paddle_tpu_torch.runtime import compiled
    from paddle_tpu_torch.static import executor as port_executor

    capture = compiled.GraphStore.capture

    def capturing(self, sig, fn, inputs, generators=()):
        entry = capture(self, sig, fn, inputs, generators)
        entry.graph.body = lambda: _write(entry.outputs, fn(*entry.inputs))
        return entry

    @contextlib.contextmanager
    def graph(g, **kw):
        yield g

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _ReplayingGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(compiled.GraphStore, "capture", capturing)
    for mod in (port_jit, port_executor):
        monkeypatch.setattr(mod, "_captures", lambda device: True)
        monkeypatch.setattr(mod, "_first_run", lambda device, fn: fn())


def test_the_checked_step_is_a_graph_of_its_own(graphs, check_on, monkeypatch):
    """Flag off, on, on, off: two graphs, one per variant; a NaN in a
    replay of the checked graph raises with the names its capture listed."""
    tstep = _port_step(0.1)
    monkeypatch.setattr(flags._REGISTRY["check_nan_inf"], "value", False)
    tstep(*_batch("clean"))
    monkeypatch.setattr(flags._REGISTRY["check_nan_inf"], "value", True)
    tstep(*_batch("clean"))
    tstep(*_batch("clean"))
    assert (len(tstep.store), tstep.store.misses) == (2, 2)
    with pytest.raises(FatalError, match=r"aten::mm\."):
        tstep(*_batch("nan_input"))
    monkeypatch.setattr(flags._REGISTRY["check_nan_inf"], "value", False)
    tstep(*_batch("clean"))
    assert (len(tstep.store), tstep.store.misses) == (2, 2)


def test_executor_scan_on_a_captured_run(graphs, both_static, check_on):
    """A captured run with the scan keeps one graph, which returns the
    written values: a NaN replay raises before anything is written back,
    a clean replay writes back."""
    h, loss = _program(static, ops)
    texe = static.Executor("cpu")
    texe.run_startup()
    scope = static.global_scope()
    texe.run(static.default_main_program(), feed={"x": np.ones((2, 3), "f4")}, fetch_list=[loss])
    w = scope.numpy("param_0").copy()
    with pytest.raises(FatalError, match="contains NaN/Inf"):
        texe.run(static.default_main_program(),
                 feed={"x": np.array([[np.inf, 0, 0], [1, 1, 1]], "f4")}, fetch_list=[loss])
    np.testing.assert_array_equal(scope.numpy("param_0"), w)
    texe.run(static.default_main_program(), feed={"x": np.ones((2, 3), "f4")}, fetch_list=[loss])
    assert not np.array_equal(scope.numpy("param_0"), w)
    assert (len(texe.store), texe.store.misses) == (1, 1)
