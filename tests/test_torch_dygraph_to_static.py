"""Port parity: dygraph-to-static (``paddle_tpu_torch/dygraph_to_static.py``) against ``paddle_tpu/dygraph_to_static.py``.

One counterpart of each of the 33 tests of ``tests/test_dygraph_to_static.py``,
under the same name: the same function goes to both packages'
``convert_to_static`` (or converters), built from each package's public
names, on the same numpy inputs (the JAX test's values, and inputs drawn
from a seed where the value decides a branch). Where the JAX test traces
(``jax.jit``), the port runs the function inside a compiled step
(``runtime.compiled.compiled_step``), its counterpart of a trace: an ``if``
on a tensor runs both branches and selects on the device, a ``while`` on a
tensor reads its predicate on the host as a sanctioned read. Integer and
bool results are held exactly, floats to ``RTOL`` (both packages compute
the same f32 operations; they read equal).

Beyond the counterparts: the chip check's phase 12o paths at a small width
against the JAX package's ``jit.to_static`` on the CPU (``chip_smoke``'s
``paddle_sentence_encoder`` over a 2-layer, 64-wide BERT at L = 16,
``paddle_greedy_decode`` over a 2-layer, 64-wide seq2seq, vocabulary 100),
the weights carried by ``convert``; the graph store's dispositions through
the stand-in graph of ``tests/test_torch_serving_compiled.py`` (an ``if``
signature captured once and replayed down both branches; a ``while``,
``print`` or ``assert`` signature never captured, ``uncaptured`` counting
its runs, and its later calls kept off the capture path; a host read
while a graph records refused); a ``to_static`` call's arguments (every
tensor in them a graph input, numbers and strings keys, anything else
refused); and an in-place write in a branch under a tensor predicate
refused, also through a layer or a global.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpaddle  # noqa: E402
from paddle_tpu import dygraph_to_static as jd2s  # noqa: E402
from paddle_tpu.framework.tensor import Tensor as JTensor  # noqa: E402
from paddle_tpu.models import BertConfig as JBertConfig  # noqa: E402
from paddle_tpu.models import BertModel as JBertModel  # noqa: E402
from paddle_tpu.models import TransformerSeq2Seq as JSeq2Seq  # noqa: E402

import chip_smoke  # noqa: E402
import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import dygraph_to_static as d2s  # noqa: E402
from paddle_tpu_torch.errors import InvalidArgumentError  # noqa: E402
from paddle_tpu_torch.framework import jit as port_jit  # noqa: E402
from paddle_tpu_torch.framework import place as _place  # noqa: E402
from paddle_tpu_torch.models import BertConfig  # noqa: E402
from paddle_tpu_torch.runtime import compiled  # noqa: E402
from tests.test_torch_serving_compiled import graphs  # noqa: E402,F401

torch.set_num_threads(1)

RTOL = 1e-6  # the counterparts: the same f32 operations in both packages
PATH_ATOL = 1e-5  # the small phase-12o paths: f32 through 2 layers in another order


@pytest.fixture(autouse=True)
def _on_the_cpu():
    prev = _place._expected_place
    paddle.set_device("cpu")
    yield
    _place._expected_place = prev


# -- helpers ----------------------------------------------------------------------


def _np(v):
    """A result of either package as numpy (a Python number as it is)."""
    if isinstance(v, JTensor):
        return np.asarray(v.numpy())
    if isinstance(v, torch.Tensor):
        return torch.Tensor.detach(v).cpu().numpy()
    if isinstance(v, jax.Array):
        return np.asarray(v)
    return v


def _same(got, want):
    """Exact for integer and bool values, to RTOL for floats."""
    got, want = _np(got), _np(want)
    if isinstance(want, (bool, int, str)) or np.asarray(want).dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype.kind == np.asarray(want).dtype.kind
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _both(make):
    """``(jax function, port function)``: ``make(pd)`` built once with each
    package's namespace, each through its own package's AST pass."""
    return jd2s.convert_to_static(make(jpaddle)), d2s.convert_to_static(make(paddle))


def _jit(tfn):
    """The JAX test's trace: ``tfn`` jitted over Tensors of the arrays."""
    @jax.jit
    def jf(*arrays):
        out = tfn(*[JTensor._from_array(a) for a in arrays])
        return out._array if isinstance(out, JTensor) else out
    return lambda *vs: np.asarray(jf(*[jnp.asarray(v) for v in vs]))


def _compiled(tfn, *arrays):
    """The port's counterpart: ``tfn`` inside a compiled step on tensors of
    the arrays. Returns (result as numpy, the host reads it made)."""
    with compiled.compiled_step(), compiled.noting_host_reads() as reads:
        out = tfn(*[paddle.to_tensor(np.asarray(a)) for a in arrays])
    return _np(out), list(reads)


def _eager(tfn, pd, *arrays):
    return _np(tfn(*[pd.to_tensor(np.asarray(a)) for a in arrays]))


def _held(make, arrays_list):
    """Each array tuple through both packages eagerly and traced / in a
    compiled step; every result equal. Returns the port's host reads of
    its compiled runs."""
    jfn, pfn = _both(make)
    reads = []
    for arrays in arrays_list:
        want = _eager(jfn, jpaddle, *arrays)
        _same(_eager(pfn, paddle, *arrays), want)
        _same(_jit(jfn)(*arrays), want)
        got, r = _compiled(pfn, *arrays)
        _same(got, want)
        reads.append(r)
    return reads


def _signed(seed, n=3):
    """A seeded f32 vector of positive sum and its negation."""
    x = np.abs(np.random.RandomState(seed).randn(n)).astype(np.float32) + 0.1
    return [(x,), (-x,)]


# -- runtime converters ------------------------------------------------------------


def test_convert_ifelse_eager():
    for pd, m in ((jpaddle, jd2s), (paddle, d2s)):
        assert m.convert_ifelse(True, lambda: 1, lambda: 2) == 1
        t = pd.to_tensor(np.asarray(0.0))
        assert m.convert_ifelse(t, lambda: 1, lambda: 2) == 2


def test_convert_ifelse_traced():
    def make(m):
        def f(x):
            return m.convert_ifelse(x.sum() > 0, lambda: x * 2, lambda: x - 1)
        return f

    jf, pf = make(jd2s), make(d2s)
    for (x,) in _signed(0) + [(np.array([1.0, 2.0], np.float32),)]:
        got, reads = _compiled(pf, x)
        _same(got, _jit(jf)(x))
        assert reads == []  # the predicate stayed on the device


def test_convert_while_traced():
    def jf(n):
        i = jnp.asarray(0, jnp.int32)
        s = jnp.asarray(0, jnp.int32)
        i, s = jd2s.convert_while_loop(lambda i, s: i < n, lambda i, s: (i + 1, s + i), (i, s))
        return s

    def pf(n):
        i = torch.tensor(0, dtype=torch.int32)
        s = torch.tensor(0, dtype=torch.int32)
        i, s = d2s.convert_while_loop(lambda i, s: i < n, lambda i, s: (i + 1, s + i), (i, s))
        return s

    want = jax.jit(jf)(jnp.asarray(5, jnp.int32))
    with compiled.compiled_step(), compiled.noting_host_reads() as reads:
        got = pf(torch.tensor(5, dtype=torch.int32))
    assert int(want) == 10 and int(got) == 10 and got.dtype == torch.int32
    assert reads == ["while"] * 6  # the predicate, read once an iteration


# -- AST transformer ---------------------------------------------------------------


def test_transform_if_assignment():
    def make(pd):
        def fn(x):
            if x.sum() > 0:
                y = x * 2
                z = x + 10
            else:
                y = x - 1
                z = x - 10
            return y + z
        return fn

    jfn, pfn = _both(make)
    assert pfn is not make(paddle)
    reads = _held(make, _signed(1) + [(np.array([1.0, 1.0], np.float32),),
                                      (np.array([-1.0, -1.0], np.float32),)])
    assert all(r == [] for r in reads)
    _same(_eager(pfn, paddle, np.array([1.0, 1.0], np.float32)), np.float32([13.0, 13.0]))


def test_transform_if_return_tail():
    def make(pd):
        def fn(x):
            if x.sum() > 0:
                return x * 2
            else:
                return x - 1
        return fn

    _held(make, _signed(2, 1) + [(np.array([3.0], np.float32),),
                                 (np.array([-3.0], np.float32),)])


def test_transform_while():
    def make(pd):
        def fn(x):
            i = pd.to_tensor(np.asarray(0, np.int32))
            while i < 4:
                x = x * 2
                i = i + 1
            return x
        return fn

    reads = _held(make, [(np.array([1.0], np.float32),),
                         (np.random.RandomState(3).randn(2).astype(np.float32),)])
    assert reads[0] == ["while"] * 5


def test_transform_logical_ops():
    def make(pd):
        def fn(x):
            if (x.sum() > 0) and (x.max() > 2):
                y = x * 10
            else:
                y = x
            return y
        return fn

    _held(make, [(np.array([1.0, 3.0], np.float32),), (np.array([1.0, 1.0], np.float32),),
                 (np.array([-5.0, 3.0], np.float32),)])


def _net(pd):
    nn = pd.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.sum() > 0:
                out = h * 2
            else:
                out = h * -1
            return out

    return Net()


def test_to_static_layer_with_data_dependent_if():
    jpaddle.seed(0)
    jnet = _net(jpaddle)
    pnet = _net(paddle)
    pnet.set_state_dict({k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()})
    jnet.eval(), pnet.eval()
    jnet, pnet = jpaddle.jit.to_static(jnet), paddle.jit.to_static(pnet)
    rng = np.random.RandomState(4)
    xs = [np.ones((2, 4), np.float32), -np.ones((2, 4), np.float32) * 100,
          rng.randn(2, 4).astype(np.float32)]
    for x in xs:
        want = _np(jnet(jpaddle.to_tensor(x)))
        got = pnet(paddle.to_tensor(x))
        assert tuple(got.shape) == (2, 4)
        _same(got, want)
    # flipping the input's sign flips the branch in the same captured function
    assert np.asarray(_np(pnet(paddle.to_tensor(xs[1])))).sum() != 0
    assert pnet.forward.store.uncaptured == 0


def test_closure_snapshot():
    def make(pd):
        scale = 3.0

        def fn(x):
            if x.sum() > 0:
                y = x * scale
            else:
                y = x
            return y
        return fn

    _held(make, [(np.array([2.0], np.float32),), (np.array([-2.0], np.float32),)])


# -- review-hardening cases ----------------------------------------------------------


def test_while_carries_write_only_vars():
    def make(pd):
        def fn(x, n):
            out = x
            i = pd.to_tensor(np.asarray(0, np.int32))
            while i < n:
                i = i + 1
                out = x * i
            return out
        return fn

    _held(make, [(np.asarray(2.0, np.float32), np.asarray(3, np.int32)),
                 (np.asarray(-1.5, np.float32), np.asarray(0, np.int32))])


def test_if_single_branch_binding():
    def make(pd):
        def fn(flag):
            if flag:
                y = 1  # noqa: F841
            return "done"
        return fn

    for tfn in _both(make):
        assert tfn(False) == "done" and tfn(True) == "done"


def test_nested_function_locals_not_merged():
    def make(pd):
        def fn(flag):
            if flag:
                def helper():
                    inner_local = 5
                    return inner_local
                z = helper()
            else:
                z = 0
            return z
        return fn

    for tfn in _both(make):
        assert tfn(True) == 5 and tfn(False) == 0


def test_loop_var_unbound_before_loop_python_path():
    def make(pd):
        def fn(n):
            i = 0
            while i < n:
                first_seen = i  # noqa: F841 - unbound before the loop
                i = i + 1
            return i
        return fn

    for tfn in _both(make):
        assert tfn(3) == 3


def test_for_range_transform():
    def make(pd):
        def fn(x, n):
            acc = x
            for i in range(n):
                acc = acc + x * (i + 1)
            return acc
        return fn

    jfn, pfn = _both(make)
    for v, n in ((1.0, 3), (np.random.RandomState(5).randn(), 4)):
        want = _np(jfn(jpaddle.to_tensor(np.asarray(v, np.float32)), n))
        _same(pfn(paddle.to_tensor(np.asarray(v, np.float32)), n), want)
    assert float(want) != 0

    def make2(pd):
        def fn2(x):
            s = 0
            for i in range(2, 8, 2):
                s = s + i
            return s + int(np.asarray(x.numpy()) * 0)
        return fn2

    for tfn, pd in zip(_both(make2), (jpaddle, paddle)):
        assert tfn(pd.to_tensor(np.asarray(1.0))) == 12


def test_for_range_with_traced_bound():
    def make(pd):
        def fn(x, n):
            acc = x
            for i in range(n):
                acc = acc * 2
            return acc
        return fn

    reads = _held(make, [(np.asarray(1.0, np.float32), np.asarray(4, np.int32)),
                         (np.asarray(-0.75, np.float32), np.asarray(2, np.int32))])
    assert reads[0] == ["while"] * 5  # range(n) of a tensor bound: read a step


def test_for_range_python_edge_semantics():
    def make(pd):
        def fn(n):
            c = 0
            for i in range(n):
                n = 0  # python evaluated range(n) once: still 5 iterations
                c = c + 1
            return c
        return fn

    def make2(pd):
        def fn2():
            i = 10
            for i in range(0):
                pass
            return i
        return fn2

    for tfn in _both(make):
        assert tfn(5) == 5
    for tfn in _both(make2):
        assert tfn() == 10


# -- break/continue --------------------------------------------------------------------


def test_break_in_while():
    def make(pd):
        def fn(x):
            i = pd.to_tensor(np.asarray(0, np.int32))
            s = x * 0
            while i < 10:
                if i > 4:
                    break
                s = s + x
                i = i + 1
            return s
        return fn

    _held(make, [(np.array([2.0], np.float32),),
                 (np.random.RandomState(6).randn(3).astype(np.float32),)])


def test_continue_in_for():
    def make(pd):
        def fn(x):
            s = x * 0
            for i in range(6):
                if i % 2 == 1:
                    continue
                s = s + i
            return s
        return fn

    _held(make, [(np.array([0.0], np.float32),), (np.array([1.5, -2.0], np.float32),)])


def test_break_in_for_traced_bound():
    def make(pd):
        def fn(x):
            s = x * 0
            for i in range(8):
                if (s > 5).sum() > 0:
                    break
                s = s + x
            return s
        return fn

    _held(make, [(np.array([3.0], np.float32),),
                 (np.abs(np.random.RandomState(7).randn(2)).astype(np.float32) + 0.5,)])


def test_break_continue_both():
    def make(pd):
        def fn(x):
            s = x * 0
            i = pd.to_tensor(np.asarray(0, np.int32))
            while i < 20:
                i = i + 1
                if i % 2 == 0:
                    continue
                if i > 9:
                    break
                s = s + i
            return s
        return fn

    _held(make, [(np.array([0.0], np.float32),), (np.array([0.5, -1.0], np.float32),)])


# -- early return ------------------------------------------------------------------------


def test_early_return_in_if():
    def make(pd):
        def fn(x):
            if x.sum() > 0:
                return x * 10
            y = x - 5
            return y
        return fn

    _held(make, _signed(8, 1) + [(np.array([2.0], np.float32),),
                                 (np.array([-2.0], np.float32),)])


def test_return_in_while():
    def make(pd):
        def fn(x):
            i = pd.to_tensor(np.asarray(0, np.int32))
            while i < 10:
                x = x + 1
                if (x > 3).sum() > 0:
                    return x * 100
                i = i + 1
            return x
        return fn

    _held(make, [(np.array([2.0], np.float32),), (np.array([-20.0], np.float32),)])


def test_return_nested_if():
    def make(pd):
        def fn(x):
            if x.sum() > 0:
                if x.sum() > 10:
                    return x * 2
                return x * 3
            return x * 4
        return fn

    _held(make, [(np.array([20.0], np.float32),), (np.array([1.0], np.float32),),
                 (np.array([-1.0], np.float32),)])


# -- print / assert / cast ----------------------------------------------------------------


def test_print_transform(capsys):
    def make(pd):
        def fn(x):
            print("value:", 42)
            return x
        return fn

    for tfn, pd in zip(_both(make), (jpaddle, paddle)):
        tfn(pd.to_tensor(np.array([1.0], np.float32)))
        assert "value: 42" in capsys.readouterr().out


def test_print_traced_does_not_crash(capsys):
    def make(pd):
        def fn(x):
            print(x)
            return x + 1
        return fn

    jfn, pfn = _both(make)
    x = np.array([1.0], np.float32)
    want = _jit(jfn)(x)
    jax_out = capsys.readouterr().out
    got, reads = _compiled(pfn, x)
    port_out = capsys.readouterr().out
    _same(got, want)
    assert reads == ["print"]  # printed at run time
    assert port_out == jax_out == "[1.]\n"


def test_assert_transform_eager():
    def make(pd):
        def fn(x):
            assert x.sum() > 0, "must be positive"
            return x
        return fn

    for tfn, pd in zip(_both(make), (jpaddle, paddle)):
        tfn(pd.to_tensor(np.array([1.0], np.float32)))  # passes
        with pytest.raises(AssertionError, match="must be positive"):
            tfn(pd.to_tensor(np.array([-1.0], np.float32)))


def test_assert_traced_raises_at_runtime():
    def make(pd):
        def fn(x):
            assert x.sum() > 0
            return x * 2
        return fn

    jfn, pfn = _both(make)
    x = np.array([1.0], np.float32)
    got, reads = _compiled(pfn, x)
    _same(got, _jit(jfn)(x))
    assert reads == ["assert"]
    with pytest.raises(Exception):
        _jit(jfn)(-x)
    with pytest.raises(AssertionError, match="Assert failed inside compiled function"):
        _compiled(pfn, -x)


def test_cast_transform():
    def make(pd):
        def fn(x):
            n = int(x.sum())        # a dtype cast in a compiled step, a python int eagerly
            f = float(n)
            return x * f
        return fn

    _held(make, [(np.array([3.0], np.float32),), (np.array([2.5, -1.25], np.float32),)])


def test_len_transform():
    def make(pd):
        def fn(x):
            n = len(x)  # a static shape read
            return x * n
        return fn

    _held(make, [(np.array([1.0, 2.0], np.float32),),
                 (np.random.RandomState(9).randn(5).astype(np.float32),)])


def test_list_append_python_loop():
    def make(pd):
        def fn(x):
            outs = []
            for i in range(3):
                outs.append(x * (i + 1))
            return outs[0] + outs[1] + outs[2]
        return fn

    _held(make, [(np.array([1.0], np.float32),), (np.array([-0.5, 4.0], np.float32),)])


def test_break_in_for_leaves_loop_var_at_break_value():
    def make(pd):
        def fn(x):
            j = 0
            for i in range(10):
                j = i
                if i == 3:
                    break
            return x * 0 + j
        return fn

    _held(make, [(np.array([1.0], np.float32),), (np.array([2.0, -3.0], np.float32),)])


def test_continue_in_for_still_advances():
    def make(pd):
        def fn(x):
            s = x * 0
            n = 0
            for i in range(5):
                n = n + 1
                if i % 2 == 0:
                    continue
                s = s + i
            return s + n * 100  # n == 5 shows every iteration ran
        return fn

    _held(make, [(np.array([0.0], np.float32),), (np.array([1.0, -7.0], np.float32),)])


def test_return_in_nested_loop_exits_outer():
    def make(pd):
        def fn(x):
            i = 0
            while i < 5:
                i = i + 1
                j = 0
                while j < 1:
                    j = j + 1
                    if i >= 2:
                        return x * 0 + i
            return x * 0 - 1
        return fn

    jfn, pfn = _both(make)
    for x in (np.array([1.0], np.float32), np.array([-3.0, 2.0], np.float32)):
        want = _eager(jfn, jpaddle, x)
        _same(_eager(pfn, paddle, x), want)
        _same(_compiled(pfn, x)[0], want)


def test_a_forward_calling_super_keeps_its_class():
    """A method using zero-argument ``super()`` is rebuilt with its class
    (the JAX pass rebuilds it without one, and its call raises)."""
    nn = paddle.nn

    class Base(nn.Layer):
        def forward(self, x):
            return x * 2

    class Child(Base):
        def forward(self, x):
            if x.sum() > 0:
                y = super().forward(x)
            else:
                y = x
            return y + 1

    net = paddle.jit.to_static(Child())
    for v in (1.5, -1.5):
        x = np.full((2,), v, np.float32)
        _same(net(paddle.to_tensor(x)), (x * 2 if v > 0 else x) + 1)


# -- in-place writes in branches ----------------------------------------------------------


def test_an_in_place_write_in_a_branch_under_a_tensor_predicate_raises():
    """Both branches run inside a compiled step, so a write in place to a
    carried tensor (``s += 1``) or to a tensor the branch reads from the
    enclosing function (``x.add_``) would land whichever branch is taken:
    refused. Eagerly the predicate is read and the write is Python's."""
    def carried(x):
        s = x * 1
        if x.sum() > 0:
            s += 1
        return s

    def read(x):
        y = x * 0
        if x.sum() > 0:
            x.add_(1)
            y = x
        return y

    for fn in (carried, read):
        tfn = d2s.convert_to_static(fn)
        x = paddle.to_tensor(np.array([2.0], np.float32))
        with pytest.raises(InvalidArgumentError, match="writes in place"):
            with compiled.compiled_step():
                tfn(x)
    _same(d2s.convert_to_static(carried)(paddle.to_tensor(np.array([2.0], np.float32))),
          np.float32([3.0]))
    _same(d2s.convert_to_static(carried)(paddle.to_tensor(np.array([-2.0], np.float32))),
          np.float32([-2.0]))


_COUNTER = torch.zeros(())  # a module global a branch writes to


def _bumps_a_global(x):
    y = x * 1
    if x.sum() > 0:
        _COUNTER.add_(1)
        y = x * 2
    return y


def test_an_in_place_write_through_a_layer_or_a_global_in_a_branch_raises():
    """The guard also watches what a branch reaches beyond its carries:
    the running statistics of a train-mode BatchNorm it calls (a layer the
    function closes over, or ``self``'s), and a tensor among its module's
    globals. Eagerly the predicate is read and only the branch taken
    writes."""
    paddle.seed(5)
    bn = paddle.nn.BatchNorm1D(3)

    def normed(x):
        if x.sum() > 0:
            y = bn(x)
        else:
            y = x
        return y

    class Normed(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.bn = paddle.nn.BatchNorm1D(3)

        def forward(self, x):
            if x.sum() > 0:
                y = self.bn(x)
            else:
                y = x * 2
            return y

    net = Normed()
    x = np.abs(np.random.RandomState(6).randn(4, 3)).astype(np.float32)
    calls = [(d2s.convert_to_static(normed), ()), (d2s.convert_to_static(Normed.forward), (net,)),
             (d2s.convert_to_static(_bumps_a_global), ())]
    for tfn, pre in calls:
        with pytest.raises(InvalidArgumentError, match="writes in place"):
            with compiled.compiled_step():
                tfn(*pre, paddle.to_tensor(x))
    before = [_np(bn._mean).copy(), float(_COUNTER)]
    for v in (x, -x):
        d2s.convert_to_static(normed)(paddle.to_tensor(v))
        d2s.convert_to_static(_bumps_a_global)(paddle.to_tensor(v))
    assert not np.array_equal(_np(bn._mean), before[0]) and float(_COUNTER) == before[1] + 1
    mean = _np(bn._mean).copy()
    d2s.convert_to_static(normed)(paddle.to_tensor(-x))
    np.testing.assert_array_equal(_np(bn._mean), mean)  # the branch not taken wrote nothing


def test_branches_unify_as_lax_cond_does():
    """Under a tensor predicate: dtypes promote, a value one branch leaves
    unbound becomes zeros shaped like the other's, and shapes or structures
    that differ raise."""
    def promote(x):
        if x.sum() > 0:
            y = x.astype("int32") + 1
        else:
            y = x * 0.5
        return y

    def unbound(x):
        if x.sum() > 0:
            y = x * 3
        return y  # noqa: F821 - UNDEF on the other path

    def shapes(x):
        if x.sum() > 0:
            y = x
        else:
            y = x[:1]
        return y

    x = np.array([2.0, -4.0], np.float32)
    jp, pp = _both(lambda pd: promote)
    _same(_compiled(pp, x)[0], _jit(jp)(x))
    assert _compiled(pp, x)[0].dtype == np.float32
    ju, pu = _both(lambda pd: unbound)
    _same(_compiled(pu, x)[0], _jit(ju)(x))
    _same(_compiled(pu, -x)[0], _jit(ju)(-x))
    with pytest.raises(ValueError, match="shape"):
        _compiled(d2s.convert_to_static(shapes), x)
    with pytest.raises(TypeError, match="structures"):
        with compiled.compiled_step():
            d2s.convert_ifelse(paddle.to_tensor(np.asarray(True)), lambda: (x, x), lambda: x)


def test_the_converters_copy_nothing_from_the_host(monkeypatch):
    """Inside a compiled step the converters make the numbers they select
    or combine (the return and break flags, a loop counter) by fills on
    the device, never by a copy from the host, which a graph capture
    refuses: a tensor made from host data for another device raises here."""
    made = []

    def guarded(real):
        def make(*a, device=None, **k):
            if device is not None and torch.device(device).type != "cpu":
                made.append(real.__name__)
            return real(*a, device=device, **k)
        return make

    def fn(t):
        if paddle.sum(t) > 0:
            return paddle.scale(t, 2.0)
        s = t * 0
        for i in range(4):
            if (s > 1).sum() > 0:
                break
            s = s + t
        return s

    tfn = d2s.convert_to_static(fn)
    monkeypatch.setattr(torch, "tensor", guarded(torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", guarded(torch.as_tensor))
    monkeypatch.setattr(d2s, "_traced", lambda v: isinstance(v, torch.Tensor))
    meta = torch.zeros(2, device="meta")
    with compiled.compiled_step():
        d2s.convert_ifelse(meta.sum() > 0, lambda: (meta, True), lambda: (None, False))
        d2s.convert_logical_and(lambda: meta > 0, lambda: 1 < 2)
        d2s.convert_logical_or(lambda: meta > 0, lambda: np.bool_(False))
    assert made == []
    monkeypatch.undo()
    for x in (np.array([1.0, 2.0], np.float32), np.array([-0.5, -0.25], np.float32)):
        got, _ = _compiled(tfn, x)
        _same(got, _eager(d2s.convert_to_static(fn), paddle, x))


# -- the graph store's dispositions (the stand-in graph) -----------------------------------


def test_an_if_signature_is_captured_once_and_replays_both_branches(graphs):
    paddle.seed(3)
    net = _net(paddle)
    net.eval()
    rng = np.random.RandomState(11)
    base = [rng.randn(2, 4).astype(np.float32) * 100 for _ in range(2)]
    xs = [base[0], -base[0], base[1], -base[1]]
    want = [_np(net(paddle.to_tensor(x))) for x in xs]
    signs = [bool(_np(net.fc(paddle.to_tensor(x))).sum() > 0) for x in xs]  # the branch taken
    assert True in signs and False in signs
    net = paddle.jit.to_static(net)
    for x, w in zip(xs, want):
        _same(net(paddle.to_tensor(x)), w)
    store = net.forward.store
    assert (store.misses, store.hits, store.uncaptured, len(store)) == (1, 3, 0, 1)
    assert len(graphs) == 1 and graphs[0].replays == 3


@pytest.mark.parametrize("kind", ["while", "print", "assert"])
def test_a_host_reading_signature_is_never_captured(graphs, kind, capsys):
    @paddle.jit.to_static
    def f(x):
        if kind == "while":
            while x.sum() < 10:
                x = x * 2
        elif kind == "print":
            print(x)
        else:
            assert x.sum() > 0, "the sum must be positive"
        return x + 1

    xs = [np.array([1.0, 2.0], np.float32), np.array([0.5, 0.25], np.float32),
          np.array([3.0, 1.0], np.float32)]
    for x in xs:
        got = f(paddle.to_tensor(x))
        want = x
        while kind == "while" and want.sum() < 10:
            want = want * 2
        _same(got, want + 1)
    assert (f.store.misses, f.store.hits, f.store.uncaptured, len(f.store)) == (1, 0, 3, 0)
    assert f.store.runs_uncaptured(next(iter(f.store._uncapturable))) and not graphs
    if kind == "print":
        assert capsys.readouterr().out == "".join(f"{x}\n" for x in xs)
    if kind == "assert":
        with pytest.raises(AssertionError, match="must be positive"):
            f(paddle.to_tensor(-xs[0]))
        assert f.store.uncaptured == 4


def test_a_host_read_while_a_graph_records_raises(graphs):
    store = compiled.GraphStore("test")
    tfn = d2s.convert_to_static(lambda_free_loop)
    x = paddle.to_tensor(np.array([1.0], np.float32))
    with compiled.compiled_step(), pytest.raises(compiled.CaptureError):
        store.capture(("sig",), tfn, [x])
    with pytest.raises(compiled.CaptureError):
        store.lookup(("sig",))  # refused: it never runs eagerly instead


def lambda_free_loop(x):
    while x.sum() < 4:
        x = x * 2
    return x


def test_the_cpu_path_counts_host_reading_runs_as_uncaptured():
    f = paddle.jit.to_static(lambda_free_loop)
    for _ in range(2):
        _same(f(paddle.to_tensor(np.array([1.0], np.float32))), np.float32([4.0]))
    assert (f.store.misses, f.store.uncaptured, len(f.store)) == (0, 2, 0)


class _Refused:
    """A stand-in for a store's capture lock that no call may take."""

    def __enter__(self):
        raise AssertionError("the capture lock was taken for an uncaptured signature")

    def __exit__(self, *exc):
        return False


def _doubling(pd):
    class Doubling(pd.nn.Layer):
        def forward(self, x):
            while x.sum() < 10:
                x = x * 2
            return x + 1

    return Doubling()


@pytest.mark.parametrize("path", ["function", "layer"])
def test_an_uncaptured_signature_skips_the_capture_path(graphs, monkeypatch, path):
    """After the first run of a host-reading signature, each call runs the
    step eagerly: no capture lock, no first run on a side stream with its
    device synchronize, no copy of its inputs; ``uncaptured`` counts every
    run."""
    firsts = []
    real = port_jit._first_run
    monkeypatch.setattr(port_jit, "_first_run",
                        lambda device, fn: firsts.append(device) or real(device, fn))
    f = _doubling(paddle)
    f = paddle.jit.to_static(f) if path == "layer" else paddle.jit.to_static(lambda_free_loop)
    store = (lambda: f.forward.store) if path == "layer" else (lambda: f.store)
    xs = [np.array([1.0, 2.0], np.float32), np.array([0.5, 0.25], np.float32),
          np.array([3.0, 1.0], np.float32)]
    for i, x in enumerate(xs):
        got = f(paddle.to_tensor(x))
        if i == 0:
            store().capturing = _Refused()
        want = x
        while want.sum() < (10 if path == "layer" else 4):
            want = want * 2
        _same(got, want + 1 if path == "layer" else want)
    s = store()
    assert len(firsts) == 1 and not graphs
    assert (s.misses, s.hits, s.uncaptured, len(s)) == (1, 0, 3, 0)


def _scaled_sum(xs, scale, shift=None):
    out = xs[0] * scale + xs[1]["b"]
    if shift is not None:
        out = out + shift
    return out


@pytest.mark.parametrize("captured", [True, False])
def test_a_tensor_anywhere_in_the_arguments_is_an_input_and_constants_are_keyed(
        request, captured):
    """Every tensor in a ``to_static`` call's tuples, lists and dicts is an
    input of its graph, never a constant: two tensors of more than 1000
    elements that differ only in the middle (their ``repr``\\ s are equal)
    give their own answers from one graph. Numbers, strings and ``None``
    are keys of the signature, by type and value."""
    graphs = request.getfixturevalue("graphs") if captured else None
    f = paddle.jit.to_static(_scaled_sum)
    a = np.zeros(2000, np.float32)
    c = a.copy()
    c[1000] = 5.0
    assert repr(torch.from_numpy(a)) == repr(torch.from_numpy(c))
    b = np.arange(2000, dtype=np.float32)
    calls = [(a, 2.0, None), (c, 2.0, None), (a, 2.0, None), (c, 3.0, None), (c, 2, None),
             (a, 2.0, 1.5)]
    for v, scale, shift in calls:
        got = f([paddle.to_tensor(v), {"b": paddle.to_tensor(b)}], scale, shift=shift)
        _same(got, v * np.float32(scale) + b + np.float32(shift or 0.0))
    if captured:
        assert (f.store.misses, f.store.hits, len(graphs)) == (4, 2, 4)


def test_a_layer_forward_keys_its_constant_arguments(graphs):
    """A ``to_static`` layer's keyword arguments are part of each call's
    signature, not of the first call's graph."""
    paddle.seed(7)

    class Scaled(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = paddle.nn.Linear(4, 4)

        def forward(self, x, scale=1.0, extra=()):
            h = self.fc(x) * scale
            for e in extra:
                h = h + e
            return h

    net = Scaled()
    net.eval()
    x = np.random.RandomState(8).randn(2, 4).astype(np.float32)
    e = np.ones((2, 4), np.float32)
    calls = [{}, {"scale": 2.0}, {"scale": 2.0, "extra": [e]}, {"scale": 2.0, "extra": [-e]}, {}]
    want = [_np(net(paddle.to_tensor(x), **{k: [paddle.to_tensor(t) for t in v]
                                            if k == "extra" else v for k, v in kw.items()}))
            for kw in calls]
    net = paddle.jit.to_static(net)
    for kw, w in zip(calls, want):
        kw = {k: [paddle.to_tensor(t) for t in v] if k == "extra" else v for k, v in kw.items()}
        _same(net(paddle.to_tensor(x), **kw), w)
    store = net.forward.store
    assert (store.misses, store.hits, len(graphs)) == (3, 2, 3)


@pytest.mark.parametrize("leaf", ["layer", "object", "dict key"])
def test_a_to_static_function_refuses_arguments_it_cannot_key(leaf):
    """A layer (two of one architecture would share a ``repr``) or any
    other object in a ``to_static`` call has no value to key a graph by,
    and a graph would bake it in: refused, as a dict key that is not a
    number, string or None is."""
    @paddle.jit.to_static
    def apply(obj, x):
        return x * 2

    x = paddle.to_tensor(np.ones(2, np.float32))
    arg = {"layer": _net(paddle), "object": object(), "dict key": {(1, 2): 3}}[leaf]
    with pytest.raises(TypeError):
        apply(arg, x)
    assert (apply.store.misses, apply.store.uncaptured, len(apply.store)) == (0, 0, 0)


# -- the phase-12o paths at a small width against the JAX package -----------------------

B_VOCAB, B_HIDDEN, B_LAYERS, B_HEADS, B_FFN, B_SEQ = 100, 64, 2, 2, 128, 16
S_KW = dict(src_vocab=100, tgt_vocab=100, d_model=64, nhead=2, num_layers=2,
            dim_feedforward=128, dropout=0.0, max_len=64, bos_id=0, eos_id=1, pad_id=2)
S_B, S_SRC, S_LEN = 4, 16, 16


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """The sentence encoder over the same small BERT in both packages,
    each through its package's ``to_static``."""
    cfg = dict(vocab_size=B_VOCAB, hidden_size=B_HIDDEN, num_hidden_layers=B_LAYERS,
               num_attention_heads=B_HEADS, intermediate_size=B_FFN,
               max_position_embeddings=B_SEQ, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    jpaddle.seed(0)
    with jax.enable_x64(False):
        jbert = JBertModel(JBertConfig(**cfg))
    path = str(tmp_path_factory.mktemp("bert") / "bert.pdparams")
    jpaddle.save(jbert.state_dict(), path)
    pbert = convert.load_bert(path, BertConfig(**cfg))
    jenc = chip_smoke.paddle_sentence_encoder(jpaddle, jbert)
    penc = chip_smoke.paddle_sentence_encoder(paddle, pbert)
    eager = chip_smoke.paddle_sentence_encoder(paddle, pbert)  # no to_static
    for m in (jenc, penc, eager):
        m.eval()
    return jpaddle.jit.to_static(jenc), paddle.jit.to_static(penc), eager


def _ids(b, seed, padded):
    ids = np.random.RandomState(seed).randint(1, B_VOCAB, (b, B_SEQ)).astype(np.int64)
    if padded:
        ids[0, B_SEQ // 2:] = 0
        ids[-1, -3:] = 0
    return ids


@pytest.mark.parametrize("bucket", [1, 8])
def test_sentence_encoder_if_matches_jax_to_static(encoders, bucket):
    jenc, penc, eager = encoders
    for padded in (True, False, True):
        ids = _ids(bucket, bucket + 10 * padded, padded)
        with jax.enable_x64(False):
            want = _np(jenc(jpaddle.to_tensor(ids)))
        got = _np(penc(paddle.to_tensor(ids)))
        ref = _np(eager(paddle.to_tensor(ids)))  # the Python `if`, read on the host
        first = _np(eager.bert(paddle.to_tensor(ids))[0])[:, 0]
        assert got.shape == (bucket, B_HIDDEN)
        np.testing.assert_allclose(got, want, rtol=0, atol=PATH_ATOL)
        np.testing.assert_allclose(got, ref, rtol=0, atol=PATH_ATOL)
        # the branch the batch takes: the first token's row only when unpadded
        assert np.allclose(got, first, rtol=0, atol=PATH_ATOL) == (not padded)
    assert penc.forward.store.uncaptured == 0


@pytest.fixture(scope="module")
def seq2seqs(tmp_path_factory):
    jpaddle.seed(0)
    with jax.enable_x64(False):
        jm = JSeq2Seq(**S_KW)
    jm.eval()
    path = str(tmp_path_factory.mktemp("s2s") / "s2s.pdparams")
    jpaddle.save(jm.state_dict(), path)
    return jm, convert.load_seq2seq(path, **S_KW).eval()


def test_greedy_decode_script_breaks_on_eos_as_jax_and_greedy_decode(seq2seqs):
    jm, pm = seq2seqs
    eos_id = pm.eos_id
    src = np.random.RandomState(5).randint(3, 100, (S_B, S_SRC)).astype(np.int64)
    src[1, 10:] = 2  # a pad tail
    jdec = chip_smoke.paddle_greedy_decode(jpaddle, jm, S_LEN)
    pdec = chip_smoke.paddle_greedy_decode(paddle, pm, S_LEN)
    lengths = []
    eos = -1  # the first run: no row emits it, the loop runs to max_len - 1
    for run in range(2):
        with jax.enable_x64(False):
            jbuf, jn = jdec(jpaddle.to_tensor(src), jpaddle.to_tensor(np.asarray(eos, np.int64)))
        pbuf, pn = pdec(paddle.to_tensor(src), paddle.to_tensor(np.asarray(eos, np.int64)))
        n = int(_np(pn))
        np.testing.assert_array_equal(_np(pbuf), _np(jbuf))
        assert n == int(_np(jn))
        # the port's greedy_decode (held against the JAX one by
        # tests/test_torch_seq2seq.py) stops where the script's break does
        pm.eos_id = eos
        pys = _np(pm.greedy_decode(paddle.to_tensor(src), max_len=S_LEN, stop_at_eos=True))
        np.testing.assert_array_equal(_np(pbuf)[:, :n], pys)
        assert pys.shape[1] == n
        lengths.append(n)
        eos, rows, col = chip_smoke.eos_rows(_np(pbuf)[:, :n], S_LEN // 2)
        src = src[np.resize(rows, S_B)]  # a batch of the rows that emit it
    pm.eos_id = eos_id
    assert lengths[0] == S_LEN and lengths[1] <= S_LEN // 2 + 1  # the break fired
    assert pdec.store.uncaptured == 2
