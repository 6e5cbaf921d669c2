"""Port parity: the executor's named io slots (``paddle_tpu/static/executor.py:111-130``).

An op may name its inputs and outputs by slot (``__in_slots__``,
``__out_slots__``); the kernel then takes the slots' variables concatenated
in that order. ``tests/test_static_guardrails_rnn.py``'s
``test_named_multi_slot_op`` builds such an op in the JAX package; here the
same program, with a gradient op written with named slots too (the JAX
``append_backward`` reads ``X`` and ``Out`` only), is built and run by the
JAX executor, crosses through ``Program.to_dict`` and runs in the port's
executor, eagerly and through its capture path (the stand-in graph); the
answers are held to ``RTOL`` (XLA fuses ``alpha * x + beta * y`` into one
rounding; torch rounds twice: 1 ulp apart) and to the closed forms. A
program in which the slot op feeds ordinary ops differentiated by
``append_backward`` runs alike in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu.ops import registry as jregistry  # noqa: E402

from paddle_tpu_torch import static  # noqa: E402
from paddle_tpu_torch.ops import registry as pregistry  # noqa: E402
from tests.test_torch_serving_compiled import graphs  # noqa: E402,F401

torch.set_num_threads(1)

if not jregistry.has_op("_test_axpby"):
    @jregistry.register_op("_test_axpby", num_outputs=2)
    def _jax_axpby(alpha, x, y, *, beta=1.0):
        return alpha * x + beta * y, alpha * x - beta * y

if not pregistry.has_op("_test_axpby"):
    @pregistry.register_op("_test_axpby", num_outputs=2)
    def _port_axpby(alpha, x, y, *, beta=1.0):
        return alpha * x + beta * y, alpha * x - beta * y

SLOTS_IN, SLOTS_OUT = ["Alpha", "Input", "Other"], ["SumOut", "DiffOut"]
RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture
def jax_static():
    jstatic.enable_static()
    jstatic.reset_default_programs()
    yield
    jstatic.disable_static()
    jstatic.reset_default_programs()


def _feed(seed):
    rng = np.random.RandomState(seed)
    return {"a": np.float32(rng.randn()), "x": rng.randn(3).astype(np.float32),
            "y": rng.randn(3).astype(np.float32), "g1": rng.randn(3).astype(np.float32),
            "g2": rng.randn(3).astype(np.float32)}


def _slot_program():
    """The JAX program: the slot op forward, and its gradient op in named
    slots taking the feeds g1, g2 as the outputs' cotangents."""
    prog = jstatic.default_main_program()
    block = prog.global_block()
    for name, shape in (("a", []), ("x", [3]), ("y", [3]), ("g1", [3]), ("g2", [3])):
        jstatic.data(name, shape, "float32")
    for name in ("sum_out", "diff_out", "a@GRAD", "x@GRAD", "y@GRAD"):
        block.create_var(name=name, shape=[] if name == "a@GRAD" else [3], dtype="float32")
    block.append_op("_test_axpby", {"Alpha": ["a"], "Input": ["x"], "Other": ["y"]},
                    {"SumOut": ["sum_out"], "DiffOut": ["diff_out"]},
                    {"beta": 2.0, "__in_slots__": SLOTS_IN, "__out_slots__": SLOTS_OUT})
    block.append_op("grad::_test_axpby",
                    {"Alpha": ["a"], "Input": ["x"], "Other": ["y"], "SumOutGrad": ["g1"],
                     "DiffOutGrad": ["g2"]},
                    {"AlphaGrad": ["a@GRAD"], "InputGrad": ["x@GRAD"], "OtherGrad": ["y@GRAD"]},
                    {"beta": 2.0, "__n_fwd_in__": 3,
                     "__in_slots__": SLOTS_IN + ["SumOutGrad", "DiffOutGrad"],
                     "__out_slots__": ["AlphaGrad", "InputGrad", "OtherGrad"]})
    return prog


FETCH = ["sum_out", "diff_out", "a@GRAD", "x@GRAD", "y@GRAD"]


def _closed_form(f):
    a, x, y, g1, g2 = (f[k] for k in ("a", "x", "y", "g1", "g2"))
    return [a * x + 2 * y, a * x - 2 * y, np.sum((g1 + g2) * x), a * (g1 + g2), 2 * (g1 - g2)]


def test_a_jax_named_slot_program_runs_forward_and_backward_in_the_port(jax_static):
    jprog = _slot_program()
    feeds = [_feed(s) for s in range(3)]
    want = [jstatic.Executor().run(jprog, feed=f, fetch_list=FETCH) for f in feeds]
    prog = static.Program.from_dict(jprog.to_dict())
    exe = static.Executor("cpu")
    for f, w in zip(feeds, want):
        got = exe.run(prog, feed=f, fetch_list=FETCH, scope=static.Scope())
        for g, ww, c in zip(got, w, _closed_form(f)):
            np.testing.assert_allclose(g, np.asarray(ww), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g, c, rtol=1e-5, atol=1e-6)


def test_the_named_slot_program_replays_through_the_capture_path(jax_static, graphs):
    prog = static.Program.from_dict(_slot_program().to_dict())
    exe = static.Executor("cpu")
    scope = static.Scope()
    for s in range(3):
        f = _feed(10 + s)
        got = exe.run(prog, feed=f, fetch_list=FETCH, scope=scope)
        for g, c in zip(got, _closed_form(f)):
            np.testing.assert_allclose(g, c, rtol=1e-5, atol=1e-6)
    assert (exe.store.misses, exe.store.hits, len(graphs)) == (1, 2, 1)


def test_a_slot_op_feeding_append_backward_runs_alike(jax_static):
    """The slot op's outputs feed ops that ``append_backward`` differentiates
    (mean of a tanh of each output), the gradients taken to the outputs:
    the JAX program and its copy in the port answer alike."""
    jprog = jstatic.default_main_program()
    block = jprog.global_block()
    for name, shape in (("a", []), ("x", [3]), ("y", [3])):
        jstatic.data(name, shape, "float32")
    for name in ("sum_out", "diff_out"):
        v = block.create_var(name=name, shape=[3], dtype="float32")
        v.stop_gradient = False
    block.append_op("_test_axpby", {"Alpha": ["a"], "Input": ["x"], "Other": ["y"]},
                    {"SumOut": ["sum_out"], "DiffOut": ["diff_out"]},
                    {"beta": 0.5, "__in_slots__": SLOTS_IN, "__out_slots__": SLOTS_OUT})
    from paddle_tpu import ops as jops

    loss = jops.mean(jops.add(jops.tanh(block.var("sum_out")), jops.tanh(block.var("diff_out"))))
    grads = jstatic.gradients([loss], [block.var("sum_out"), block.var("diff_out")])
    fetch = [loss.name] + [g.name for g in grads]
    f = _feed(7)
    f = {k: f[k] for k in ("a", "x", "y")}
    want = jstatic.Executor().run(jprog, feed=f, fetch_list=fetch)
    got = static.Executor("cpu").run(static.Program.from_dict(jprog.to_dict()), feed=f,
                                     fetch_list=fetch, scope=static.Scope())
    s = f["a"] * f["x"] + 0.5 * f["y"]
    np.testing.assert_allclose(got[1], (1 - np.tanh(s) ** 2) / 3, rtol=1e-5, atol=1e-7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)
