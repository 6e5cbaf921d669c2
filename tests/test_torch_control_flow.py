"""Port parity: static control flow (``while_loop``, ``cond``, ``scan``, ``case``, ``switch_case``).

One counterpart for each test of ``tests/test_control_flow.py``: the same
program is built in both packages by one function, the JAX startup's
values are carried into the port's scope (or both scopes get the same
numpy arrays), both executors run the same feeds, and

- the programs are the same (``to_dict`` equal, captured constants
  matched by order: their names carry a per-package counter);
- the fetches agree: f32 values within 1e-5 relative, gradients within
  1e-5 of their tensor's largest entry, integers and booleans exactly;
- an unbounded ``while`` on the loss's path raises in both, with the same
  words; dropout's gradient keeps the forward's mask in both (the masks
  themselves differ: the packages draw from different generators);
- a program with ``while``/``cond``/``scan`` sub-blocks serialized by each
  package (``serialize_to_string``, ``save_inference_model``) loads and
  runs in the other.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402

from paddle_tpu_torch import convert, ops, static  # noqa: E402

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


def _normalized(prog_dict):
    """``Program.to_dict()`` with captured constants renamed by their
    order of appearance."""
    text = repr(prog_dict)
    names = {}
    for m in re.finditer(r"const\d+_\d+", text):
        names.setdefault(m.group(0), f"CONST{len(names)}")
    return re.sub(r"const\d+_\d+", lambda m: names[m.group(0)], text)


def _assert_close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= RTOL * scale, (what, got, want)


def _build_both(build):
    """``build(st, ops)`` in each package: (JAX result, port result); the
    two programs must be the same."""
    res = [build(st, o) for st, o in PKGS]
    assert (_normalized(static.default_main_program().to_dict())
            == _normalized(jstatic.default_main_program().to_dict()))
    return res


def _executors(weights=None):
    """The JAX executor after its startup, and the port's (CPU) with a copy
    of the JAX scope; ``weights`` (name -> array) set into both."""
    jexe = jstatic.Executor()
    jexe.run_startup()
    jscope = jstatic.global_scope()
    for n, v in (weights or {}).items():
        jscope.set(n, v)
    convert.scope_from_numpy({n: np.asarray(jscope.get(n)) for n in jscope.var_names()},
                             scope=static.global_scope(), device="cpu")
    return jexe, static.Executor("cpu")


def _run_both(build, feeds, weights=None):
    """Build in both, run every feed of ``feeds`` in both; the port's
    results must equal the JAX ones. Returns the JAX results."""
    jfetch, pfetch = _build_both(build)
    jexe, pexe = _executors(weights)
    out = []
    for feed in feeds:
        want = jexe.run(feed=feed, fetch_list=jfetch)
        got = pexe.run(feed=feed, fetch_list=pfetch)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, np.asarray(w), f"fetch {i}")
        out.append([np.asarray(w) for w in want])
    return out


def test_while_loop_counts():
    def build(st, o):
        i = st.data("i", [], "int64")
        limit = st.data("limit", [], "int64")
        s0 = st.data("s0", [], "float32")
        return st.nn.while_loop(lambda i, s: o.less_than(i, limit),
                                lambda i, s: [o.add(i, np.int64(1)),
                                              o.add(s, o.cast(i, "float32"))], [i, s0])

    (res,) = _run_both(build, [{"i": np.int64(0), "limit": np.int64(5), "s0": np.float32(0)}])
    assert int(res[0]) == 5 and float(res[1]) == 10.0


def test_while_loop_vector_state():
    def build(st, o):
        x = st.data("x", [4], "float32")
        n = st.data("n", [], "int64")
        i0 = st.data("i0", [], "int64")
        return st.nn.while_loop(lambda i, v: o.less_than(i, n),
                                lambda i, v: [o.add(i, np.int64(1)), o.scale(v, 2.0)],
                                [i0, x])[1:]

    xs = np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    (res,) = _run_both(build, [{"x": xs, "n": np.int64(3), "i0": np.int64(0)}])
    np.testing.assert_allclose(res[0], xs * 8.0)


def test_cond_selects_branch():
    def build(st, o):
        pred = st.data("pred", [], "bool")
        x = st.data("x", [3], "float32")
        return [st.nn.cond(pred, lambda: o.scale(x, 2.0), lambda: o.scale(x, -1.0))]

    xs = np.array([1.0, 2.0, 3.0], np.float32)
    r_t, r_f = _run_both(build, [{"pred": np.bool_(True), "x": xs},
                                 {"pred": np.bool_(False), "x": xs}])
    np.testing.assert_allclose(r_t[0], xs * 2)
    np.testing.assert_allclose(r_f[0], -xs)


def test_cond_backward():
    def build(st, o):
        pred = st.data("pred", [], "bool")
        x = st.data("x", [3], "float32")
        x.stop_gradient = False
        y = st.nn.cond(pred, lambda: o.sum(o.square(x)), lambda: o.sum(o.scale(x, 3.0)))
        return st.gradients(y, [x])

    xs = np.array([1.0, 2.0, 3.0], np.float32)
    g_t, g_f = _run_both(build, [{"pred": np.bool_(True), "x": xs},
                                 {"pred": np.bool_(False), "x": xs}])
    np.testing.assert_allclose(g_t[0], 2 * xs)
    np.testing.assert_allclose(g_f[0], np.full(3, 3.0, np.float32))


def test_scan_cumsum_and_backward():
    def build(st, o):
        seq = st.data("seq", [6, 2], "float32")
        seq.stop_gradient = False
        c0 = st.data("c0", [2], "float32")
        finals, ys = st.nn.scan(lambda c, x: ([o.add(c, x)], [o.add(c, x)]), [c0], [seq])
        return [finals[0], ys[0]] + st.gradients(o.sum(finals[0]), [seq])

    s = np.random.RandomState(0).randn(6, 2).astype("float32")
    (res,) = _run_both(build, [{"seq": s, "c0": np.zeros(2, np.float32)}])
    np.testing.assert_allclose(res[1], np.cumsum(s, 0), rtol=1e-5)
    np.testing.assert_allclose(res[2], np.ones_like(s))


def _rnn_model(st, o, T=5, B=8, D=3, H=16):
    seq = st.data("seq", [T, B, D], "float32")
    target = st.data("target", [B, 1], "float32")
    w_ih = st.nn.create_parameter([D, H], "float32")
    w_hh = st.nn.create_parameter([H, H], "float32")
    b_h = st.nn.create_parameter([H], "float32", is_bias=True)
    w_out = st.nn.create_parameter([H, 1], "float32")

    def cell(h, x):
        return [o.tanh(o.add(o.add(o.matmul(x, w_ih), o.matmul(h, w_hh)), b_h))], []

    finals, _ = st.nn.scan(cell, [o.zeros([B, H], "float32")], [seq])
    pred = o.matmul(finals[0], w_out)
    loss = o.mean(o.square(o.subtract(pred, target)))
    return pred, loss


def test_scan_rnn_trains_and_roundtrips(tmp_path):
    """15 SGD steps of the scan RNN in both (losses within 1e-5, then the
    parameters within 1e-5 of their largest entry), and its inference
    model saved by each package runs in the other."""
    def build(st, o):
        pred, loss = _rnn_model(st, o)
        st.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return pred, loss

    (jpred, jloss), (ppred, ploss) = _build_both(build)
    jexe, pexe = _executors()
    rng = np.random.RandomState(0)
    feed = {"seq": rng.randn(5, 8, 3).astype("float32"),
            "target": rng.randn(8, 1).astype("float32")}
    losses = []
    for _ in range(15):
        want = float(jexe.run(feed=feed, fetch_list=[jloss])[0])
        got = float(pexe.run(feed=feed, fetch_list=[ploss])[0])
        assert abs(got - want) <= RTOL * abs(want), (got, want)
        losses.append(want)
    assert losses[-1] < losses[0] * 0.7, losses
    for i in range(4):
        _assert_close(static.global_scope().numpy(f"param_{i}"),
                      np.asarray(jstatic.global_scope().get(f"param_{i}")), f"param_{i}")

    jdir, pdir = str(tmp_path / "jax_rnn"), str(tmp_path / "port_rnn")
    jstatic.save_inference_model(jdir, ["seq"], [jpred], jexe)
    static.save_inference_model(pdir, ["seq"], [ppred], pexe)
    want = np.asarray(jexe.run(feed=feed, fetch_list=[jpred])[0])
    for st in (jstatic, static):
        st.reset_default_programs()
        st.global_scope().clear()
    prog, feeds, fetches = static.load_inference_model(jdir, pexe)
    _assert_close(pexe.run(prog, feed={"seq": feed["seq"]}, fetch_list=fetches)[0], want,
                  "port runs the JAX model")
    prog, feeds, fetches = jstatic.load_inference_model(pdir, jexe)
    _assert_close(np.asarray(jexe.run(prog, feed={"seq": feed["seq"]}, fetch_list=fetches)[0]),
                  want, "JAX runs the port's model")


def test_while_program_serialization_roundtrip():
    """A while program serialized by each package runs in the other."""
    def build(st, o):
        i = st.data("i", [], "int64")
        n = st.data("n", [], "int64")
        return st.nn.while_loop(lambda i: o.less_than(i, n), lambda i: [o.add(i, np.int64(2))],
                                [i])

    (jout,), (pout,) = _build_both(build)
    feed = {"i": np.int64(1), "n": np.int64(9)}
    jprog, pprog = jstatic.default_main_program(), static.default_main_program()
    from_jax = static.Program.parse_from_string(jprog.serialize_to_string())
    from_port = jstatic.Program.parse_from_string(pprog.serialize_to_string())
    assert len(from_jax.blocks) == len(jprog.blocks) == len(from_port.blocks) == 3
    got = static.Executor("cpu").run(from_jax, feed=feed, fetch_list=[jout.name])
    want = jstatic.Executor().run(from_port, feed=feed, fetch_list=[pout.name])
    assert int(got[0]) == int(want[0]) == 9


def test_case_and_switch_case():
    def build(st, o):
        x = st.data("x", [], "float32")
        idx = st.data("idx", [], "int64")
        return [st.nn.switch_case(idx, {0: lambda: o.scale(x, 10.0),
                                        1: lambda: o.scale(x, 100.0),
                                        2: lambda: o.scale(x, -1.0)})]

    res = _run_both(build, [{"x": np.float32(2.0), "idx": np.int64(i)} for i in range(3)])
    assert [float(r[0]) for r in res] == [20.0, 200.0, -2.0]


def _doubling_while(st, o, extra_loss):
    x = st.data("x", [2], "float32")
    x.stop_gradient = False
    i0 = st.data("i0", [], "int64")
    out = st.nn.while_loop(lambda i, v: o.less_than(i, np.int64(3)),
                           lambda i, v: [o.add(i, np.int64(1)), o.scale(v, 2.0)], [i0, x])
    loss = o.sum(out[1])
    if extra_loss:
        loss = o.add(loss, o.sum(o.square(x)))
    return x, loss


@pytest.mark.parametrize("extra_loss", [False, True], ids=["whole_path", "partial_path"])
def test_while_grad_raises_helpfully(extra_loss):
    """``test_while_grad_raises_helpfully`` and
    ``test_while_partial_grad_path_raises``: a loss through an unbounded
    while, wholly or in part, raises in both packages with one message."""
    msgs = []
    for st, o in PKGS:
        x, loss = _doubling_while(st, o, extra_loss)
        with pytest.raises(RuntimeError, match="while") as e:
            st.gradients(loss, [x])
        msgs.append(str(e.value).split(" (")[0].split(".")[0])
    assert msgs[0] == msgs[1]


def test_while_grad_op_raises_at_run():
    """A ``grad::while`` op (a hand-built program) raises when the
    executor reaches it, as the JAX executor does."""
    for st, o in PKGS:
        x, loss = _doubling_while(st, o, False)
        block = st.default_main_program().global_block()
        wop = next(op for op in block.ops if op.type == "while")
        block.append_op("grad::while", {"X": list(wop.inputs["X"]) + [""] * 2},
                        {"Out": ["", ""]}, dict(wop.attrs, __n_fwd_in__=len(wop.inputs["X"])))
    feed = {"x": np.ones(2, np.float32), "i0": np.int64(0)}
    with pytest.raises(RuntimeError, match="not reverse-differentiable"):
        static.Executor("cpu").run(feed=feed, fetch_list=[])
    with pytest.raises(RuntimeError, match="not reverse-differentiable"):
        jstatic.Executor().run(feed=feed, fetch_list=[])


def test_scan_carries_only_with_length():
    def build(st, o):
        c0 = st.data("c0", [], "float32")
        finals, ys = st.nn.scan(lambda c: ([o.scale(c, 2.0)], [c]), [c0], length=4)
        return [finals[0], ys[0]]

    (res,) = _run_both(build, [{"c0": np.float32(1.0)}])
    assert float(res[0]) == 16.0
    np.testing.assert_allclose(res[1], [1.0, 2.0, 4.0, 8.0])


def test_dropout_grad_mask_matches_forward():
    """d(sum(dropout(x)))/dx is 1/(1-p) exactly where the forward kept the
    entry, in both packages (the programs are the same, ``__rng_id__``
    included)."""
    def build(st, o):
        x = st.data("x", [64], "float32")
        x.stop_gradient = False
        y = o.dropout(x, p=0.5, training=True)
        return [y] + st.gradients(o.sum(y), [x])

    fetches = _build_both(build)
    feed = {"x": np.ones(64, np.float32)}
    for exe, fetch in zip((jstatic.Executor(), static.Executor("cpu")), fetches):
        yv, gv = (np.asarray(v) for v in exe.run(feed=feed, fetch_list=fetch))
        kept = yv != 0
        assert 0 < kept.sum() < 64
        np.testing.assert_allclose(gv[kept], 2.0)
        np.testing.assert_allclose(gv[~kept], 0.0)


def _bn_names(st):
    return sorted(n for n in st.default_main_program().global_block().vars
                  if n.startswith("param_"))


def test_bn_under_cond():
    """Batch norm's running statistics under ``cond`` update when its
    branch runs and stay put when the other does, equal in both."""
    def build(st, o):
        x = st.data("x", [4, 3], "float32")
        pred = st.data("pred", [], "bool")
        return [st.nn.cond(pred, lambda: st.nn.batch_norm(x, momentum=0.5),
                           lambda: o.scale(x, 1.0))]

    xv = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    _run_both(build, [{"x": xv, "pred": np.asarray(v)} for v in (True, False, True)])
    mean_name, var_name = _bn_names(static)[2:4]
    expected = 0.5 * (0.5 * xv.mean(0)) + 0.5 * xv.mean(0)
    np.testing.assert_allclose(static.global_scope().numpy(mean_name), expected, atol=1e-5)
    for n in (mean_name, var_name):
        _assert_close(static.global_scope().numpy(n), np.asarray(jstatic.global_scope().get(n)),
                      n)


def test_bn_under_scan():
    """Running statistics ride the scan's carry: five chained updates,
    equal in both."""
    def build(st, o):
        seq = st.data("seq", [5, 4, 3], "float32")
        c0 = st.data("c0", [4, 3], "float32")

        def body(c, x):
            h = st.nn.batch_norm(x, momentum=0.9)
            return [o.add(c, h)], [h]

        finals, _ = st.nn.scan(body, [c0], [seq])
        return [o.sum(finals[0])]

    sv = np.random.RandomState(1).randn(5, 4, 3).astype(np.float32)
    _run_both(build, [{"seq": sv, "c0": np.zeros((4, 3), np.float32)}])
    m = np.zeros(3)
    for t in range(5):
        m = 0.9 * m + 0.1 * sv[t].mean(0)
    mean_name, var_name = _bn_names(static)[2:4]
    np.testing.assert_allclose(static.global_scope().numpy(mean_name), m, atol=1e-5)
    for n in (mean_name, var_name):
        _assert_close(static.global_scope().numpy(n), np.asarray(jstatic.global_scope().get(n)),
                      n)


def _bounded_pair(st, o, i, x):
    def c(i_, x_):
        return o.less_than(i_, o.full([], 4, "int64"))

    def b(i_, x_):
        return [o.add(i_, o.full([], 1, "int64")), o.scale(x_, 2.0)]

    return st.nn.while_loop(c, b, [i, x]), st.nn.while_loop(c, b, [i, x], max_iters=10)


def test_bounded_while_forward_matches_unbounded():
    def build(st, o):
        outs_u, outs_b = _bounded_pair(st, o, st.data("i", [], "int64"),
                                       st.data("x", [3], "float32"))
        return [outs_u[1], outs_b[1], outs_b[0]]

    (res,) = _run_both(build, [{"i": np.asarray(0), "x": np.ones(3, np.float32)}])
    np.testing.assert_allclose(res[0], res[1])
    np.testing.assert_allclose(res[1], 16.0 * np.ones(3))
    assert int(res[2]) == 4


def test_bounded_while_gradient_decode_loop():
    def build(st, o):
        w = st.nn.create_parameter([3], "float32")
        i0 = st.data("i0", [], "int64")
        h0 = st.data("h0", [3], "float32")
        h0.stop_gradient = False
        outs = st.nn.while_loop(lambda i_, h_: o.less_than(i_, o.full([], 3, "int64")),
                                lambda i_, h_: [o.add(i_, o.full([], 1, "int64")),
                                                o.multiply(h_, w)],
                                [i0, h0], max_iters=5)
        loss = o.sum(outs[1])
        return [loss] + st.gradients(loss, [h0, w])

    wv = np.array([1.5, 2.0, 0.5], np.float32)
    h = np.array([1.0, 2.0, 3.0], np.float32)
    (res,) = _run_both(build, [{"i0": np.asarray(0), "h0": h}], weights={"param_0": wv})
    np.testing.assert_allclose(res[0], (h * wv ** 3).sum(), rtol=1e-5)
    np.testing.assert_allclose(res[1], wv ** 3, rtol=1e-5)
    np.testing.assert_allclose(res[2], 3 * h * wv ** 2, rtol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_nested_blocks_saved_by_one_run_by_the_other(tmp_path, writer):
    """A program with ``while``, ``cond`` and ``scan`` sub-blocks (a scan
    inside a while body, a cond inside the scan) saved with
    ``save_inference_model`` by one package runs in the other's executor
    and in the port's ``ProgramPredictor``, with the same answers."""
    from paddle_tpu_torch.inference import Config, create_predictor

    def build(st, o):
        x = st.data("x", [2, 3], "float32")
        n = st.data("n", [], "int64")
        w = st.nn.create_parameter([3, 3], "float32")

        def body(i, v):
            def step(c, row):
                pos = o.greater_than(o.sum(row), np.float32(0.0))
                up = st.nn.cond(pos, lambda: o.tanh(o.matmul(row, w)), lambda: o.scale(row, 0.5))
                return [o.add(c, up)], [up]

            finals, _ = st.nn.scan(step, [o.zeros([3], "float32")], [v])
            return [o.add(i, np.int64(1)), o.add(v, finals[0])]

        return st.nn.while_loop(lambda i, v: o.less_than(i, n), body,
                                [o.full([], 0, "int64"), x])[1]

    jout, pout = _build_both(build)
    jexe, pexe = _executors()
    feed = {"x": np.random.RandomState(4).randn(2, 3).astype(np.float32), "n": np.int64(3)}
    want = np.asarray(jexe.run(feed=feed, fetch_list=[jout])[0])
    _assert_close(pexe.run(feed=feed, fetch_list=[pout])[0], want)
    d = str(tmp_path / "model")
    if writer == "jax":
        jstatic.save_inference_model(d, ["x", "n"], [jout], jexe)
    else:
        static.save_inference_model(d, ["x", "n"], [pout], pexe)
    for st in (jstatic, static):
        st.reset_default_programs()
        st.global_scope().clear()
    reader = (static, static.Executor("cpu")) if writer == "jax" else (jstatic, jexe)
    prog, feeds, fetches = reader[0].load_inference_model(d, reader[1])
    assert len(prog.blocks) == 6  # global, while cond and body, scan body, two branches
    _assert_close(np.asarray(reader[1].run(prog, feed=feed, fetch_list=fetches)[0]), want)
    pred = create_predictor(Config(d), device="cpu")
    _assert_close(pred.run([feed["x"], feed["n"]])[0], want, "ProgramPredictor")


def test_cond_runs_only_the_taken_branch_around_a_while():
    """A branch holding an unbounded while runs only when taken (the
    predicate is read on the host): the untaken branch's loop here would
    never end. Both packages answer alike; the port's run is uncaptured."""
    def build(st, o):
        pred = st.data("pred", [], "bool")
        step = st.data("step", [], "int64")
        x = st.data("x", [3], "float32")

        def looping():
            i, v = st.nn.while_loop(lambda i, v: o.less_than(i, np.int64(4)),
                                    lambda i, v: [o.add(i, step), o.scale(v, 2.0)],
                                    [o.full([], 0, "int64"), x])
            return v

        return [st.nn.cond(pred, lambda: o.scale(x, -1.0), looping)]

    xs = np.array([1.0, 2.0, 3.0], np.float32)
    res = _run_both(build, [{"pred": np.bool_(True), "step": np.int64(0), "x": xs},
                            {"pred": np.bool_(False), "step": np.int64(1), "x": xs}])
    np.testing.assert_allclose(res[0][0], -xs)
    np.testing.assert_allclose(res[1][0], 16 * xs)


_A = np.random.RandomState(5).randn(3, 4).astype(np.float32)
_B = np.random.RandomState(6).randn(3, 4).astype(np.float32)
_I = np.array([[1, 0, 2], [2, 2, 0]], np.int64)
# op -> (build(st, ops, a, b), feeds): each registry op this port adds, built
# through the mode-aware front in both packages
_OPS = {
    "scale": (lambda st, o, a, b: o.scale(a, 2.5, 0.5, bias_after_scale=False), {}),
    "equal": (lambda st, o, a, b: o.equal(o.greater_than(a, b), o.less_equal(b, a)), {}),
    "not_equal": (lambda st, o, a, b: o.not_equal(a, b), {}),
    "less_than": (lambda st, o, a, b: o.less_than(a, b), {}),
    "greater_equal": (lambda st, o, a, b: o.greater_equal(a, b), {}),
    "logical": (lambda st, o, a, b: o.logical_xor(
        o.logical_and(o.less_than(a, b), o.greater_than(a, np.float32(0.0))),
        o.logical_or(o.logical_not(o.less_than(a, b)), o.less_than(b, np.float32(0.0)))), {}),
    "sigmoid": (lambda st, o, a, b: o.sigmoid(a), {}),
    "tanh": (lambda st, o, a, b: o.tanh(a), {}),
    "arg_max": (lambda st, o, a, b: o.argmax(a, axis=1), {}),
    "cast": (lambda st, o, a, b: o.cast(o.scale(a, 3.0), "int64"), {}),
    "transpose": (lambda st, o, a, b: o.transpose(a, [1, 0]), {}),
    "concat": (lambda st, o, a, b: o.concat([a, b], axis=1), {}),
    "stack": (lambda st, o, a, b: o.stack([a, b], axis=0), {}),
    "split": (lambda st, o, a, b: o.split(a, [1, -1], axis=1)[1], {}),
    "slice": (lambda st, o, a, b: o.slice(a, [0, 1], [1, -3], [3, 4]), {}),
    "where": (lambda st, o, a, b: o.where(o.less_than(a, b), a, b), {}),
    "assign": (lambda st, o, a, b: o.assign(a), {}),
    "lookup_table": (lambda st, o, a, b: o.embedding(st.data("ids", [2, 3], "int64"), a,
                                                     padding_idx=2), {"ids": _I}),
    "batch_norm_eval": (lambda st, o, a, b: st.nn.batch_norm(a, is_test=True), {}),
}


@pytest.mark.parametrize("name", sorted(_OPS))
def test_ported_ops_match_jax(name):
    """Each op the control-flow and recurrent programs emit, built through
    the ops front in both packages and run by both executors."""
    build, feeds = _OPS[name]

    def program(st, o):
        a = st.data("a", [3, 4], "float32")
        b = st.data("b", [3, 4], "float32")
        return [build(st, o, a, b)]

    _run_both(program, [dict(feeds, a=_A, b=_B)])
