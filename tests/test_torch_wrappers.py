"""Port parity: ExponentialMovingAverage, ModelAverage and Lookahead (``paddle_tpu/optimizer/wrappers.py``).

The JAX and port wrappers see the same parameter values, step by step
(seeded numpy arrays written into both), and are compared bit for bit:
their updates are elementwise and keep the JAX expression order, each op
rounded on its own on both sides. Lookahead through ``train_step(jit=True)``
on the CPU is held to the JAX train step run op by op (bit-equal) and
under ``jax.jit`` (4 ulps of each parameter's largest entry: XLA's CPU
fusion contracts ``s + alpha * (fast - s)``). ``apply()``/``restore()``
must keep every parameter's storage (``data_ptr()``), which the captured
graphs read.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jax_opt  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.framework.tensor import Parameter as JaxParameter  # noqa: E402
from paddle_tpu.framework.tensor import Tensor as JaxTensor  # noqa: E402

from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402
from paddle_tpu_torch.optimizer import wrappers as port_wrappers  # noqa: E402

torch.set_num_threads(1)

SHAPES = ((5, 7), (7,), (3, 4, 2))
JIT_ULPS = 4


def _values(steps, seed=0):
    """A parameter trajectory: ``steps`` lists of arrays."""
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype("f4") for s in SHAPES] for _ in range(steps)]


def _twins(first):
    jp = [JaxParameter.from_array(a, name=f"w{i}") for i, a in enumerate(first)]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in first]
    return jp, tp


def _set(jp, tp, arrays):
    for p, a in zip(jp, arrays):
        p._array = jnp.asarray(a)
    with torch.no_grad():
        for p, a in zip(tp, arrays):
            p.copy_(torch.from_numpy(a))


def _same(jp, tp):
    for i, (p, q) in enumerate(zip(jp, tp)):
        np.testing.assert_array_equal(q.detach().numpy(), np.asarray(p._array), err_msg=str(i))


# -- EMA --------------------------------------------------------------------------


@pytest.mark.parametrize("thres", [None, "int", "callable"])
def test_ema_matches_jax(thres):
    """Five updates (with ``thres_steps`` a number or a function of the
    step, the decay is ``min(decay, (1 + t) / (10 + t))``), then ``apply()``
    installs the bias-corrected averages and the exit restores the live
    weights; before any update ``apply()`` installs the live weights."""
    vals = _values(6)
    jp, tp = _twins(vals[0])
    counter = {"t": 0}
    ts = {None: None, "int": 3, "callable": lambda: counter["t"]}[thres]
    je = jax_opt.ExponentialMovingAverage(jp, decay=0.9, thres_steps=ts)
    te = port_opt.ExponentialMovingAverage(tp, decay=0.9, thres_steps=ts)
    with je.apply(), te.apply():
        _same(jp, tp)
        np.testing.assert_array_equal(tp[0].detach().numpy(), vals[0][0])
    for v in vals[1:]:
        _set(jp, tp, v)
        je.update()
        te.update()
        counter["t"] += 1
    for a, b in zip(te._ema, je._ema):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert te._decay_prod == je._decay_prod and te._step == je._step == 5
    with je.apply(), te.apply():
        _same(jp, tp)
        assert not np.array_equal(tp[0].detach().numpy(), vals[-1][0])
    np.testing.assert_array_equal(tp[0].detach().numpy(), vals[-1][0])
    _same(jp, tp)


def test_ema_apply_without_restore_and_nesting():
    vals = _values(3)
    jp, tp = _twins(vals[0])
    je = jax_opt.ExponentialMovingAverage(jp, decay=0.5)
    te = port_opt.ExponentialMovingAverage(tp, decay=0.5)
    for v in vals[1:]:
        _set(jp, tp, v)
        je.update()
        te.update()
    with je.apply(need_restore=False), te.apply(need_restore=False):
        pass
    _same(jp, tp)
    with pytest.raises(RuntimeError, match="already active"):
        with te.apply():
            pass
    te.restore()
    je.restore()
    _same(jp, tp)
    np.testing.assert_array_equal(tp[1].detach().numpy(), vals[-1][1])


# -- ModelAverage --------------------------------------------------------------------


@pytest.mark.parametrize("max_acc", [16384, 3], ids=["no_drain", "drain_every_3"])
def test_model_average_matches_jax_across_restarts(max_acc, monkeypatch):
    """Windows of 2 to 4 updates restart three times over 11 updates (and,
    with ``_MAX_NUM_ACCUMULATES`` patched to 3 on both sides, the drain of
    ``sum_1`` into ``sum_2`` fires between them); the counts, the three sums
    and the applied averages match after every update."""
    monkeypatch.setattr(jax_opt.ModelAverage, "_MAX_NUM_ACCUMULATES", max_acc)
    monkeypatch.setattr(port_wrappers.ModelAverage, "_MAX_NUM_ACCUMULATES", max_acc)
    vals = _values(12, seed=1)
    jp, tp = _twins(vals[0])
    ja = jax_opt.ModelAverage(0.3, jp, min_average_window=2, max_average_window=4)
    ta = port_opt.ModelAverage(0.3, tp, min_average_window=2, max_average_window=4)
    restarts = 0
    for v in vals[1:]:
        _set(jp, tp, v)
        ja.accumulate()
        ta.accumulate()
        assert (ta.num_updates, ta.num_accumulates, ta.old_num_accumulates) == (
            ja.num_updates, ja.num_accumulates, ja.old_num_accumulates)
        restarts += ta.num_accumulates == 0
        for name in ("_sum_1", "_sum_2", "_sum_3"):
            for a, b in zip(getattr(ta, name), getattr(ja, name)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        with ja.apply(), ta.apply():
            _same(jp, tp)
        np.testing.assert_array_equal(tp[2].detach().numpy(), v[2])
    assert restarts >= 3
    with pytest.raises(ValueError, match="min_average_window"):
        port_opt.ModelAverage(0.1, tp, min_average_window=5, max_average_window=4)


# -- storage ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ema", "model_average"])
def test_apply_and_restore_keep_the_parameters_storage(kind):
    """``apply()`` and ``restore()`` copy into the parameters: the
    addresses a captured graph reads stay, and the values change."""
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    ptrs = [p.data_ptr() for p in model.parameters()]
    wrap = (port_opt.ExponentialMovingAverage(model, decay=0.5) if kind == "ema"
            else port_opt.ModelAverage(0.5, model, min_average_window=1, max_average_window=3))
    before = [p.detach().clone() for p in model.parameters()]
    for k in range(3):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0 + k)
        wrap.update()
    live = [p.detach().clone() for p in model.parameters()]
    with wrap.apply():
        assert [p.data_ptr() for p in model.parameters()] == ptrs
        assert not all(torch.equal(p, q) for p, q in zip(model.parameters(), live))
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), live))
    assert not torch.equal(live[0], before[0])


def test_do_model_average_false_is_left_out():
    a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(3))
    b.do_model_average = False
    ma = port_opt.ModelAverage(0.5, [a, b])
    assert len(ma._parameters) == 1 and ma._parameters[0] is a


# -- state dicts -------------------------------------------------------------------------


def test_wrapper_state_dicts_round_trip():
    """EMA and ModelAverage state dicts round-trip port to port, and a JAX
    EMA's (numpy) loads into the port's and applies the same values."""
    vals = _values(4, seed=2)
    jp, tp = _twins(vals[0])
    je = jax_opt.ExponentialMovingAverage(jp, decay=0.8)
    te = port_opt.ExponentialMovingAverage(tp, decay=0.8)
    ta = port_opt.ModelAverage(0.5, tp, min_average_window=1, max_average_window=2)
    for v in vals[1:]:
        _set(jp, tp, v)
        je.update()
        te.update()
        ta.accumulate()
    tp2 = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in vals[-1]]
    te2 = port_opt.ExponentialMovingAverage(tp2, decay=0.8)
    te2.set_state_dict(je.state_dict())
    te3 = port_opt.ExponentialMovingAverage(tp2, decay=0.8)
    te3.set_state_dict(te.state_dict())
    for e in (te2, te3):
        for a, b in zip(e._ema, te._ema):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert e._step == 3 and e._decay_prod == te._decay_prod
    ta2 = port_opt.ModelAverage(0.5, tp2, min_average_window=1, max_average_window=2)
    ta2.set_state_dict(ta.state_dict())
    with ta.apply():
        want = [p.detach().clone() for p in tp]
    with ta2.apply():
        got = [p.detach().clone() for p in tp2]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (ta2.num_updates, ta2.num_accumulates, ta2.old_num_accumulates) == (
        ta.num_updates, ta.num_accumulates, ta.old_num_accumulates)


# -- Lookahead -------------------------------------------------------------------------------


def _grads(steps, seed=3):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype("f4") for s in SHAPES] for _ in range(steps)]


@pytest.mark.parametrize("inner", ["sgd", "momentum", "adam"])
def test_lookahead_eager_matches_jax_across_three_syncs(inner):
    """k = 3, alpha = 0.4, 9 steps: three syncs. The fast weights, the slow
    ones and the inner optimizer's accumulators match after every step; the
    state dict holds ``slow_{i}`` beside the inner's, with one step
    count."""
    def make(mod, params):
        opt = {"sgd": lambda: mod.SGD(0.1, parameters=params),
               "momentum": lambda: mod.Momentum(0.05, 0.9, parameters=params),
               "adam": lambda: mod.Adam(0.01, parameters=params)}[inner]()
        return mod.Lookahead(opt, alpha=0.4, k=3)

    vals, grads = _values(1, seed=4), _grads(9)
    jp, tp = _twins(vals[0])
    jo, to = make(jax_opt, jp), make(port_opt, tp)
    for t, g in enumerate(grads, start=1):
        for p, a in zip(jp, g):
            p.grad = JaxTensor._from_array(jnp.asarray(a))
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        jo.step()
        to.step()
        _same(jp, tp)
        for a, b in zip(to._accumulators["slow"], jo._accumulators["slow"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if t % 3 == 0:  # a sync: the fast weights are the slow ones
            np.testing.assert_array_equal(tp[0].detach().numpy(),
                                          to._accumulators["slow"][0].numpy())
    js, ts = jo.state_dict(), to.state_dict()
    assert sorted(js) == sorted(ts) and ts["global_step"] == 9
    assert to.inner_optimizer._global_step == 9
    # a JAX state dict carries into a fresh port Lookahead
    tp2 = [torch.nn.Parameter(p.detach().clone()) for p in tp]
    to2 = make(port_opt, tp2)
    to2.set_state_dict(convert.optimizer_state_from_numpy(js, to2))
    for k in js:
        if k != "global_step":
            np.testing.assert_array_equal(to2.state_dict()[k].numpy(), js[k], err_msg=k)
    assert to2._global_step == 9


def test_lookahead_argument_checks():
    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError):
        port_opt.Lookahead(None)
    with pytest.raises(ValueError):
        port_opt.Lookahead(port_opt.SGD(0.1, parameters=[p]), alpha=1.5)
    with pytest.raises(ValueError):
        port_opt.Lookahead(port_opt.SGD(0.1, parameters=[p]), k=0)
    assert port_opt.LookaheadOptimizer is port_opt.Lookahead


NAMES = ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")


def _mlp_arrays(seed=0):
    rng = np.random.RandomState(seed)
    shapes = ((6, 16), (16,), (16, 3), (3,))
    return {n: (rng.randn(*s) * 0.5).astype("f4") for n, s in zip(NAMES, shapes)}


class _JaxMLP(paddle.nn.Layer):
    def __init__(self, arrays):
        super().__init__()
        self.fc1 = paddle.nn.Linear(6, 16)
        self.fc2 = paddle.nn.Linear(16, 3)
        for n, p in self.named_parameters():
            p._array = jnp.asarray(arrays[n])


class _PortMLP(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.fc1 = pnn.Linear(6, 16)
        self.fc2 = pnn.Linear(16, 3)
        with torch.no_grad():
            for n, p in self.named_parameters():
                p.copy_(torch.from_numpy(arrays[n].copy()))


def _given_gradient_loss(m, *grads):
    return sum((p * g).sum() for p, g in zip(m.parameters(), grads))


def _lookahead(mod, params):
    return mod.Lookahead(mod.Momentum(0.05, 0.9, parameters=params), alpha=0.5, k=2)


def test_lookahead_compiled_matches_the_jax_train_step():
    """Lookahead(Momentum) with k = 2 through the port's
    ``train_step(jit=True)`` on the CPU (the sync a ``torch.where`` on the
    device step count) for 6 steps, three syncs: the JAX train step's
    update run op by op bit for bit, and under ``jax.jit`` within 4 ulps."""
    rng = np.random.RandomState(5)
    grads = [{n: rng.randn(*a.shape).astype("f4") for n, a in _mlp_arrays().items()}
             for _ in range(6)]
    want = {}
    with jax.enable_x64(False):
        for jit in (False, True):
            jm = _JaxMLP(_mlp_arrays())
            jo = _lookahead(jax_opt, jm.parameters())
            state = jax_jit.init_opt_state(jm, jo)

            def apply(state, grads, lr, jm=jm, jo=jo):
                return jax_jit._apply_optimizer(jm, jo, state, grads, lr)

            fn = jax.jit(apply) if jit else apply
            lr = jnp.asarray(jo.get_lr(), jnp.float32)
            for g in grads:
                new_params, opt_state = fn(state, {n: jnp.asarray(a) for n, a in g.items()}, lr)
                state = dict(state, params=new_params, opt=opt_state)
            want[jit] = {n: np.asarray(a) for n, a in state["params"].items()}
    tm = _PortMLP(_mlp_arrays())
    opt = _lookahead(port_opt, tm.parameters())
    step = train_step(tm, opt, _given_gradient_loss, jit=True, device="cpu")
    for g in grads:
        step(*[torch.from_numpy(g[n]) for n in NAMES])
    assert opt._global_step == int(opt._step_t) == 6
    for n, p in tm.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_array_equal(got, want[False][n], err_msg=n)
        ulp = float(np.spacing(np.float32(np.abs(want[True][n]).max())))
        np.testing.assert_allclose(got, want[True][n], rtol=0, atol=JIT_ULPS * ulp, err_msg=n)
