"""Port parity: static checkpoints, startup programs with random ops, dropout in programs.

- ``save``/``load`` (``.pdparams`` + ``.pdmodel``) and
  ``save_persistables``/``load_persistables`` both ways across the
  packages: a small LSTM language model trained in one package, saved,
  loaded into the other, gives the same next loss (within 1e-5 relative)
  and the same parameters after it (within 1e-5 of their largest entry).
- A startup program with ``uniform_random``, ``gaussian_random``,
  ``truncated_gaussian_random`` and ``fill_constant`` ops (the same program
  in both): each package's draws have the law the op names, the constant
  is equal; a second startup draws anew and ``seed`` repeats the first.
- Dropout in a program: the keep rate over 10^5 draws is 0.5 +- 0.01, the
  gradient's mask is the forward's, inside a ``scan`` too (a new mask at
  each step), and ``clone(for_test=True)`` turns it off in sub-blocks.
- The uncaptured-run count: each run of a program holding an unbounded
  ``while`` adds one to ``Executor.store.uncaptured``; ``scan``, ``cond``
  and ``while_loop(max_iters=...)`` programs add none.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import convert, ops, static  # noqa: E402

from test_torch_static_rnn import _lm_batches, ptb_lm  # noqa: E402

torch.set_num_threads(1)

PKGS = ((jstatic, jops), (static, ops))
RTOL = 1e-5


@pytest.fixture(autouse=True)
def both_static():
    for st in (jstatic, static):
        st.reset_default_programs()
        st.global_scope().clear()
        st.enable_static()
    yield
    for st in (jstatic, static):
        st.disable_static()
        st.reset_default_programs()
        st.global_scope().clear()


def _assert_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= RTOL * scale, (what, np.abs(got - want).max(), scale)


def _lm_momentum():
    """The small LM under Momentum built in both packages: the losses."""
    losses = []
    for st, o in PKGS:
        loss, _ = ptb_lm(st, o)
        st.optimizer.Momentum(learning_rate=0.5, momentum=0.9).minimize(loss)
        losses.append(loss)
    return losses


def _scope_values(st):
    scope = st.global_scope()
    if st is static:
        return {n: scope.numpy(n) for n in scope.var_names()}
    return {n: np.asarray(scope.get(n)) for n in scope.var_names()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_persistables_across_packages(tmp_path, writer):
    """Two Momentum steps in the writer, ``save_persistables``, a load into
    the other package's fresh scope: step 3 agrees, velocities included."""
    jloss, ploss = _lm_momentum()
    jexe = jstatic.Executor()
    jexe.run_startup()
    pexe = static.Executor("cpu")
    if writer == "port":
        convert.scope_from_numpy(_scope_values(jstatic), scope=static.global_scope(),
                                 device="cpu")
    batches = _lm_batches(3)
    d = str(tmp_path / "ckpt")
    wst, wexe, wloss = ((jstatic, jexe, jloss) if writer == "jax" else (static, pexe, ploss))
    for feed in batches[:2]:
        wexe.run(feed=feed, fetch_list=[wloss])
    wst.save_persistables(wexe, d)
    assert os.path.exists(os.path.join(d, "__params__"))
    rst, rexe = (static, pexe) if writer == "jax" else (jstatic, jexe)
    rst.global_scope().clear()
    rst.load_persistables(rexe, d)
    want = float(jexe.run(feed=batches[2], fetch_list=[jloss])[0])
    got = float(pexe.run(feed=batches[2], fetch_list=[ploss])[0])
    assert abs(got - want) <= RTOL * abs(want), (got, want)
    jvals, pvals = _scope_values(jstatic), _scope_values(static)
    names = [n for n in pvals if n.startswith("param_")]
    assert any(n.endswith("@velocity") for n in names)
    for n in names:
        _assert_close(pvals[n], jvals[n], n)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_program_and_params_across_packages(tmp_path, writer):
    """``save`` writes ``.pdparams`` and ``.pdmodel``; the other package
    parses the program, ``load``s the parameters and computes the same
    loss."""
    losses = [ptb_lm(st, o)[0] for st, o in PKGS]
    jexe = jstatic.Executor()
    jexe.run_startup()
    convert.scope_from_numpy(_scope_values(jstatic), scope=static.global_scope(), device="cpu")
    pexe = static.Executor("cpu")
    feed = _lm_batches(1)[0]
    want = float(jexe.run(feed=feed, fetch_list=[losses[0]])[0])
    path = str(tmp_path / "lm" / "model")
    wst = jstatic if writer == "jax" else static
    wst.save(wst.default_main_program(), path)
    assert os.path.exists(path + ".pdparams") and os.path.exists(path + ".pdmodel")
    rst, rexe = (static, pexe) if writer == "jax" else (jstatic, jexe)
    rst.global_scope().clear()
    with open(path + ".pdmodel", "rb") as f:
        prog = rst.Program.parse_from_string(f.read())
    rst.load(prog, path, rexe)
    got = float(np.asarray(rexe.run(prog, feed=feed, fetch_list=[losses[0].name])[0]))
    assert abs(got - want) <= RTOL * abs(want), (got, want)


def _random_startup(st, o):
    """A startup program of random and constant ops, built through the ops
    front (uniform, normal) and ``append_op`` (the rest)."""
    startup = st.Program()
    with st.program_guard(startup):
        u = o.uniform([100000], "float32", min=-0.05, max=0.05)
        g = o.normal(1.0, 2.0, [100000])
    blk = startup.global_block()
    for name, dtype in (("t", "float32"), ("f", "int64")):
        blk.create_var(name=name, shape=[100000] if name == "t" else [3], dtype=dtype)
    blk.append_op("truncated_gaussian_random", {"X": []}, {"Out": ["t"]},
                  {"shape": [100000], "mean": 0.0, "std": 1.0, "dtype": "float32",
                   "__rng__": True, "__rng_id__": 2})
    blk.append_op("fill_constant", {"X": []}, {"Out": ["f"]},
                  {"shape": [3], "value": 7, "dtype": "int64"})
    return startup, [u.name, g.name, "t", "f"]


def _check_laws(vals, what):
    u, g, t, f = (np.asarray(v) for v in vals)
    assert u.dtype == g.dtype == t.dtype == np.float32 and f.dtype == np.int64, what
    assert u.min() >= -0.05 and u.max() < 0.05, what
    assert abs(u.mean()) < 0.001 and abs(u.std() / (0.1 / np.sqrt(12)) - 1) < 0.02, what
    assert abs(g.mean() - 1.0) < 0.03 and abs(g.std() / 2.0 - 1) < 0.02, what
    # a standard normal truncated to [-2, 2]: std 0.87962
    assert t.min() >= -2.0 and t.max() <= 2.0 and abs(t.std() / 0.87962 - 1) < 0.02, what
    np.testing.assert_array_equal(f, [7, 7, 7])


def test_startup_program_with_random_ops():
    starts = [_random_startup(st, o) for st, o in PKGS]
    assert starts[0][0].to_dict() == starts[1][0].to_dict()
    (jstart, names), (pstart, _) = starts
    jstatic.Executor().run_startup(jstart)
    _check_laws([jstatic.global_scope().get(n) for n in names], "jax")
    pexe = static.Executor("cpu")
    ptt.seed(11)
    pexe.run_startup(pstart)
    first = [static.global_scope().numpy(n) for n in names]
    _check_laws(first, "port")
    assert all(static.global_scope().get(n).device.type == "cpu" for n in names)
    pexe.run_startup(pstart)
    second = [static.global_scope().numpy(n) for n in names]
    assert not any(np.array_equal(a, b) for a, b in zip(first[:3], second[:3]))
    ptt.seed(11)
    pexe.run_startup(pstart)
    for a, n in zip(first, names):
        np.testing.assert_array_equal(static.global_scope().numpy(n), a)


def test_dropout_keep_rate_in_a_program():
    x = static.data("x", [100000], "float32")
    y = ops.dropout(x, p=0.5, training=True)
    op = static.default_main_program().global_block().ops[-1]
    assert op.type == "dropout" and op.attrs["__rng__"] and op.attrs["__rng_id__"] == 0
    yv = static.Executor("cpu").run(feed={"x": np.ones(100000, np.float32)}, fetch_list=[y])[0]
    assert abs(float((yv != 0).mean()) - 0.5) <= 0.01
    assert set(np.unique(yv).tolist()) == {0.0, 2.0}


def _dropout_scan(st, o):
    seq = st.data("seq", [4, 1000], "float32")
    seq.stop_gradient = False
    c0 = st.data("c0", [1000], "float32")

    def body(c, x):
        h = o.dropout(x, p=0.5, training=True)
        return [o.add(c, h)], [h]

    finals, ys = st.nn.scan(body, [c0], [seq])
    return seq, ys[0], o.sum(finals[0])


def test_dropout_grad_mask_matches_forward_inside_scan():
    """In each package: the gradient of ``sum`` over a scan of dropouts is
    2 exactly where that step's forward kept the entry; each step draws
    its own mask."""
    feed = {"seq": np.ones((4, 1000), np.float32), "c0": np.zeros(1000, np.float32)}
    for st, o in PKGS:
        seq, ys, loss = _dropout_scan(st, o)
        (g,) = st.gradients(loss, [seq])
        exe = st.Executor() if st is jstatic else st.Executor("cpu")
        yv, gv = (np.asarray(v) for v in exe.run(feed=feed, fetch_list=[ys, g]))
        kept = yv != 0
        assert 0.45 < kept.mean() < 0.55, st
        np.testing.assert_array_equal(gv, np.where(kept, 2.0, 0.0).astype(np.float32))
        assert not np.array_equal(kept[0], kept[1])


def test_clone_for_test_turns_dropout_off_in_sub_blocks():
    seq, ys, _ = _dropout_scan(static, ops)
    test_prog = static.default_main_program().clone(for_test=True)
    body = test_prog.blocks[1]
    assert [op.attrs["training"] for op in body.ops if op.type == "dropout"] == [False]
    yv = static.Executor("cpu").run(test_prog, feed={"seq": np.ones((4, 1000), np.float32),
                                                     "c0": np.zeros(1000, np.float32)},
                                    fetch_list=[ys.name])[0]
    np.testing.assert_array_equal(yv, np.ones((4, 1000), np.float32))


@pytest.mark.parametrize("form", ["while", "bounded_while", "scan", "cond"])
def test_uncaptured_run_count(form):
    x = static.data("x", [3], "float32")
    i0 = ops.full([], 0, "int64")
    if form in ("while", "bounded_while"):
        out = static.nn.while_loop(lambda i, v: ops.less_than(i, np.int64(3)),
                                   lambda i, v: [ops.add(i, np.int64(1)), ops.scale(v, 2.0)],
                                   [i0, x], max_iters=None if form == "while" else 5)[1]
    elif form == "scan":
        out = static.nn.scan(lambda c: ([ops.scale(c, 2.0)], []), [x], length=3)[0][0]
    else:
        out = static.nn.cond(ops.greater_than(ops.sum(x), np.float32(0.0)),
                             lambda: ops.scale(x, 8.0), lambda: x)
    exe = static.Executor("cpu")
    for _ in range(3):
        got = exe.run(feed={"x": np.ones(3, np.float32)}, fetch_list=[out])[0]
        np.testing.assert_array_equal(got, np.full(3, 8.0, np.float32))
    assert exe.store.uncaptured == (3 if form == "while" else 0)
