"""Port parity: the compiled step (``framework/jit.py`` ``train_step(jit=True)``, ``eval_step``; ``runtime/compiled.py``).

On the CPU the compiled step runs its capturable body eagerly, so these
tests hold what that body computes against the JAX package's steps, and
drive the store of captured steps and the capture path through a
stand-in graph (``torch.cuda.CUDAGraph`` and ``torch.cuda.graph``
monkeypatched): the CUDA graphs themselves run only on the card
(``chip_smoke.py``).

The models are a two-layer MLP built in both packages from the same
numpy weights, and the tiny BERT of ``tests/test_torch_train.py``. The JAX
steps run as its own tests run them on the CPU.
"""
import contextlib
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jax_opt  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402

from paddle_tpu_torch import amp as pamp  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.flags import set_flags  # noqa: E402
from paddle_tpu_torch.framework import jit as port_jit  # noqa: E402
from paddle_tpu_torch.framework import random as port_random  # noqa: E402
from paddle_tpu_torch.framework.jit import eval_step, train_step  # noqa: E402
from paddle_tpu_torch.models import (  # noqa: E402
    BertForPretraining,
    BertPretrainingCriterion,
    bert_tiny_config,
)
from paddle_tpu_torch.ops import cuda as port_kernels  # noqa: E402
from paddle_tpu_torch.runtime import compiled  # noqa: E402

torch.set_num_threads(1)

# AdamW's update on identical gradients, parameters of about 1e-3, against
# the JAX compiled step's: XLA's fusion on the CPU moves 35 of 163 entries
# by up to 4.7e-10; the host's float64 bias correction and lr * coeff, the
# fault, move all of them by up to 2.0e-8 (both read on the CPU)
ADAMW_ATOL = 1e-9
# an MLP step's forward and backward in another summation order
MLP_TOL = dict(atol=1e-6, rtol=1e-5)
NAMES = ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")


def _mlp_arrays(seed=0, scale=0.5):
    rng = np.random.RandomState(seed)
    shapes = ((6, 16), (16,), (16, 3), (3,))
    return {n: (rng.randn(*s) * scale).astype("f4") for n, s in zip(NAMES, shapes)}


class _JaxMLP(paddle.nn.Layer):
    def __init__(self, arrays):
        super().__init__()
        self.fc1 = paddle.nn.Linear(6, 16)
        self.fc2 = paddle.nn.Linear(16, 3)
        for n, p in self.named_parameters():
            p._array = jnp.asarray(arrays[n])

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


class _PortMLP(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.fc1 = pnn.Linear(6, 16)
        self.fc2 = pnn.Linear(16, 3)
        with torch.no_grad():
            for n, p in self.named_parameters():
                p.copy_(torch.from_numpy(arrays[n]))

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _mse(m, x, t):
    return ((m(x) - t) ** 2).mean()


def _mlp_batches(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 6).astype("f4"), rng.randn(8, 3).astype("f4")) for _ in range(n)]


def _grads(seed=2, steps=3):
    """Gradients for ``steps`` steps, each a decade smaller than the last
    (Adam's bias correction matters most on small ones)."""
    rng = np.random.RandomState(seed)
    shapes = [a.shape for a in _mlp_arrays().values()]
    return [{n: (rng.randn(*s) * 10.0 ** -k).astype("f4") for n, s in zip(NAMES, shapes)}
            for k in range(steps)]


def _given_gradient_loss(m, *grads):
    """A loss whose gradient in each parameter is exactly the given array."""
    return sum((p * g).sum() for p, g in zip(m.parameters(), grads))


def _port_params(m):
    return {n: p.detach().numpy().copy() for n, p in m.named_parameters()}


def _make_opt(pkg, kind, params):
    if kind == "AdamW":
        return pkg.AdamW(learning_rate=1e-3, weight_decay=0.01, parameters=params)
    return pkg.Momentum(learning_rate=0.1, momentum=0.9, weight_decay=1e-4, parameters=params)


def _jax_updates(kind, grads, jit, scale):
    """The JAX train step's update (``_apply_optimizer`` with its int32
    ``step`` and float32 ``lr`` arrays) applied to the MLP's weights for
    each gradient set, under ``jax.jit`` (the compiled step) or op by op,
    with 64-bit types off: the JAX package's own setting
    (``paddle_tpu/framework/dtype.py``, its TPU-first contract), which this
    test harness turns on (``tests/conftest.py``); with them on, the weak
    Python ``beta`` would raise ``beta**t`` to float64."""
    with jax.enable_x64(False):
        return _jax_updates_f32(kind, grads, jit, scale)


def _jax_updates_f32(kind, grads, jit, scale):
    jm = _JaxMLP(_mlp_arrays(scale=scale))
    jo = _make_opt(jax_opt, kind, jm.parameters())
    state = jax_jit.init_opt_state(jm, jo)

    def apply(state, grads, lr):
        return jax_jit._apply_optimizer(jm, jo, state, grads, lr)

    apply = jax.jit(apply) if jit else apply
    lr = jnp.asarray(jo.get_lr(), jnp.float32)
    for g in grads:
        new_params, opt_state = apply(state, {n: jnp.asarray(a) for n, a in g.items()}, lr)
        state = dict(state, params=new_params, opt=opt_state)
    return {n: np.asarray(a) for n, a in state["params"].items()}


def _port_updates(kind, grads, scale, jit):
    """The port's parameters after the train step (``jit=True``: the
    compiled step's device scalars) or, with ``jit=None``, the optimizer's
    own ``step()`` (host scalars) on each gradient set."""
    tm = _PortMLP(_mlp_arrays(scale=scale))
    opt = _make_opt(port_opt, kind, tm.parameters())
    if jit is None:
        for g in grads:
            for n, p in tm.named_parameters():
                p.grad = torch.from_numpy(g[n].copy())
            opt.step()
    else:
        step = train_step(tm, opt, _given_gradient_loss, jit=jit, device="cpu")
        for g in grads:
            step(*[torch.from_numpy(g[n]) for n in NAMES])
        assert opt._global_step == 3
        assert jit is False or int(opt._step_t) == 3
    return _port_params(tm)


# -- (a) the optimizers' scalars ---------------------------------------------------


def test_compiled_adamw_matches_the_jax_compiled_update():
    """Three AdamW steps (lr 1e-3, weight decay 0.01) on identical
    gradients through the port's ``train_step(jit=True)`` equal the JAX
    compiled step's update (``_apply_optimizer`` under ``jax.jit``) within
    :data:`ADAMW_ATOL`: the bias correction ``1 - beta**t`` and ``lr *
    coeff`` are float32 computations from the device step count and lr in
    both. The control is the parent's arithmetic: the same steps with host
    scalars (float64, the eager optimizer's and the ``jit=False`` step's)
    land beyond the limit."""
    grads, scale = _grads(), 1e-3
    want = _jax_updates("AdamW", grads, True, scale)
    for jit, sound in ((True, True), (False, False), (None, False)):
        got = _port_updates("AdamW", grads, scale, jit)
        err = max(float(np.abs(got[n] - want[n]).max()) for n in NAMES)
        assert (err <= ADAMW_ATOL) == sound, (jit, err)


def test_compiled_momentum_matches_the_jax_compiled_update():
    """Three Momentum steps (lr 0.1, L2 decay 1e-4, the fused update) on
    identical gradients: bit for bit the JAX train step's update run op by
    op, and within an ulp of each parameter's largest entry of it under
    ``jax.jit`` (XLA contracts ``param - lr * v`` on the CPU). A Python lr
    rounds to the same float32, so the host scalars agree too."""
    grads, scale = _grads(), 0.5
    op_by_op = _jax_updates("Momentum", grads, False, scale)
    jitted = _jax_updates("Momentum", grads, True, scale)
    for jit in (True, False, None):
        got = _port_updates("Momentum", grads, scale, jit)
        for n in NAMES:
            np.testing.assert_array_equal(got[n], op_by_op[n], err_msg=n)
            ulp = float(np.spacing(np.abs(jitted[n]).max()))
            np.testing.assert_allclose(got[n], jitted[n], atol=ulp, rtol=0, err_msg=n)


def test_device_bias_correction_is_the_jax_traced_value():
    """``1 - beta**t`` from a float32 ``beta`` and an int32 ``t`` in torch
    equals the JAX compiled step's value bit for bit, for t = 1..2000; the
    host float64 value rounds elsewhere at t = 1 (64-bit types off, the JAX
    package's setting)."""
    t = np.arange(1, 2001, dtype=np.int32)
    for beta in (0.9, 0.999):
        with jax.enable_x64(False):  # a scalar t, as the step traces it
            traced = jax.jit(lambda t: 1 - beta**t)
            want = np.array([traced(jnp.int32(i)) for i in t])
        b = torch.tensor(beta, dtype=torch.float32)  # and a 0-dim t, as the optimizer's
        got = np.array([(1 - b ** torch.tensor(i, dtype=torch.int32)).item() for i in t],
                       dtype=np.float32)
        np.testing.assert_array_equal(got, want)
    with jax.enable_x64(False):
        traced = np.asarray(jax.jit(lambda t: 1 - 0.999**t)(jnp.int32(1)))
    assert traced.dtype == np.float32 and np.float32(1 - 0.999**1) != traced


def test_direct_step_keeps_host_scalars_beside_a_compiled_train_step():
    """An optimizer a compiled train step drives still takes Python
    scalars in a direct ``step()`` (the JAX eager optimizer's float64 bias
    correction and ``lr * coeff``), and its device step count advances with
    it, so the train step's next call reads ``t`` right."""
    grads, scale = _grads(), 1e-3
    names_grads = [[torch.from_numpy(g[n]) for n in NAMES] for g in grads]
    host = _port_updates("AdamW", grads[:2], scale, None)
    tm = _PortMLP(_mlp_arrays(scale=scale))
    opt = _make_opt(port_opt, "AdamW", tm.parameters())
    step = train_step(tm, opt, _given_gradient_loss, jit=True, device="cpu")
    for g in grads[:2]:
        for n, p in tm.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        opt.step()
    got = _port_params(tm)
    for n in NAMES:
        np.testing.assert_array_equal(got[n], host[n], err_msg=n)
    assert opt._global_step == int(opt._step_t) == 2
    step(*names_grads[2])
    assert opt._global_step == int(opt._step_t) == 3


# -- (c) gradient merge and recompute against the JAX train step ----------------------


def _both_steps(jax_kw, port_kw, kind="Momentum"):
    jm, tm = _JaxMLP(_mlp_arrays()), _PortMLP(_mlp_arrays())
    jstep = jax_jit.train_step(jm, _make_opt(jax_opt, kind, jm.parameters()), _mse, **jax_kw)
    tstep = train_step(tm, _make_opt(port_opt, kind, tm.parameters()), _mse, device="cpu",
                       **port_kw)
    return jm, jstep, tm, tstep


@pytest.mark.parametrize("avg", [True, False])
def test_grad_accum_matches_the_jax_train_step(avg):
    """``grad_accum_steps=2``: the optimizer applies on every second call,
    to the sum of the two gradients (halved with ``grad_accum_avg``), as
    the JAX step's ``lax.cond`` does. Momentum, whose update scales with the
    gradient, so the two ``avg`` settings part."""
    kw = dict(grad_accum_steps=2, grad_accum_avg=avg)
    jm, jstep, tm, tstep = _both_steps(kw, dict(kw, jit=True))
    batches = _mlp_batches(6)
    want = [float(np.asarray(jstep(*b)["loss"])) for b in batches]
    got = [float(tstep(*b)["loss"]) for b in batches]
    np.testing.assert_allclose(got, want, **MLP_TOL)
    jstep.sync()
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(_port_params(tm)[n], np.asarray(p._array), err_msg=n,
                                   **MLP_TOL)
    assert tstep.optimizer._global_step == 3
    # the two settings give different weights, and the accumulator is empty
    other = _both_steps({}, dict(kw, grad_accum_avg=not avg))[3]
    for b in batches:
        other(*b)
    assert not np.allclose(_port_params(other.model)["fc1.weight"], _port_params(tm)["fc1.weight"])
    assert all(float(a.abs().max()) == 0.0 for a in tstep._acc)


def test_recompute_matches_the_jax_train_step():
    """``recompute=True`` (``torch.utils.checkpoint`` over the forward; the
    JAX step's ``jax.checkpoint``) gives the JAX recompute step's losses and
    weights, and its own non-recompute answer bit for bit."""
    jm, jstep, tm, tstep = _both_steps(dict(recompute=True), dict(recompute=True), "AdamW")
    pm = _PortMLP(_mlp_arrays())
    plain = train_step(pm, _make_opt(port_opt, "AdamW", pm.parameters()), _mse, device="cpu")
    batches = _mlp_batches(3, seed=4)
    want = [float(np.asarray(jstep(*b)["loss"])) for b in batches]
    got = [float(tstep(*b)["loss"]) for b in batches]
    ref = [float(plain(*b)["loss"]) for b in batches]
    np.testing.assert_allclose(got, want, **MLP_TOL)
    assert got == ref
    jstep.sync()
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(_port_params(tm)[n], np.asarray(p._array), err_msg=n,
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(_port_params(tm)[n], _port_params(plain.model)[n])


# -- (d) the lr is read at every call ---------------------------------------------------


def test_set_lr_between_calls_is_honoured():
    """The lr goes to the device tensor before every call: a step after
    ``set_lr(0)`` leaves the weights bit-identical, the next at another lr
    moves them, and the trajectory is the JAX step's under the same
    calls."""
    jm, jstep, tm, tstep = _both_steps({}, dict(jit=True))
    batches = _mlp_batches(3, seed=5)
    lrs = (0.1, 0.0, 0.05)
    for lr, b in zip(lrs, batches):
        jstep.optimizer.set_lr(lr)
        tstep.optimizer.set_lr(lr)
        before = _port_params(tm)
        jstep(*b)
        tstep(*b)
        after = _port_params(tm)
        same = all(np.array_equal(before[n], after[n]) for n in NAMES)
        assert same == (lr == 0.0), lr
        assert float(tstep.optimizer._lr_t) == np.float32(lr)
    jstep.sync()
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(_port_params(tm)[n], np.asarray(p._array), err_msg=n,
                                   **MLP_TOL)


# -- (e) recompute draws the first forward's masks --------------------------------------


def _tiny_bert(dropout):
    cfg = bert_tiny_config()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    cfg.use_flash_attention = True
    model = BertForPretraining(cfg, generator=torch.Generator().manual_seed(0))
    crit = BertPretrainingCriterion(cfg.vocab_size)

    def loss_fn(m, ids, types, pos, mlm, nsp):
        pred, rel = m(ids, types, masked_positions=pos)
        return crit(pred, rel, mlm, nsp)

    rng = np.random.RandomState(6)
    b, seq, n_pred = 2, 16, 3
    batch = [rng.randint(1, cfg.vocab_size, (b, seq)), rng.randint(0, 2, (b, seq)),
             np.stack([rng.choice(seq, n_pred, replace=False) + i * seq for i in range(b)]).ravel(),
             rng.randint(0, cfg.vocab_size, (b * n_pred,)), rng.randint(0, 2, (b, 1))]
    return model, loss_fn, [torch.from_numpy(a.astype("int64")) for a in batch]


def test_recompute_draws_the_first_forwards_dropout_masks(monkeypatch):
    """With dropout 0.1 (hidden dropout and the attention's), a
    ``recompute=True`` step gives the same loss and gradients, bit for bit,
    as a ``recompute=False`` step from the same generator state, and leaves
    the generator where it leaves it: the recomputed forward takes back the
    first forward's draws instead of drawing anew."""
    from paddle_tpu_torch.nn import transformer as port_tf

    monkeypatch.setattr(port_tf, "FLASH_ATTENTION_MIN_SEQ", 1)
    model, loss_fn, batch = _tiny_bert(0.1)
    answers = []
    for recompute in (False, True):
        m = copy.deepcopy(model)
        step = train_step(m, port_opt.AdamW(learning_rate=1e-3, parameters=m.parameters()),
                          loss_fn, recompute=recompute, device="cpu")
        port_random.seed(11)
        loss = step(*batch)["loss"]
        nxt = torch.rand(4, generator=port_random.default_generator("cpu"))
        answers.append((loss, {n: p.grad.clone() for n, p in m.named_parameters()}, nxt))
    (l0, g0, n0), (l1, g1, n1) = answers
    assert torch.equal(l0, l1) and torch.equal(n0, n1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    # the masks are random: another seed gives another loss
    m = copy.deepcopy(model)
    port_random.seed(12)
    other = train_step(m, port_opt.AdamW(parameters=m.parameters()), loss_fn, recompute=True,
                       device="cpu")(*batch)["loss"]
    assert not torch.equal(other, l0)


def test_recompute_leaves_batch_norm_statistics_as_one_forward():
    """The recomputed forward would blend the batch statistics into the
    running buffers a second time; the step restores them after it, as the
    JAX step keeps only the first forward's buffers."""
    def build():
        torch.manual_seed(0)
        return torch.nn.Sequential(pnn.Conv2D(3, 4, 3, padding=1), pnn.BatchNorm2D(4),
                                   torch.nn.ReLU())

    x = torch.from_numpy(np.random.RandomState(7).randn(2, 3, 6, 6).astype("f4"))
    bufs = []
    for recompute in (False, True):
        m = build()
        train_step(m, port_opt.Momentum(learning_rate=0.1, parameters=m.parameters()),
                   lambda m, x: m(x).mean(), recompute=recompute, device="cpu")(x)
        bufs.append([b.clone() for b in m.buffers()])
    assert all(torch.equal(a, b) for a, b in zip(*bufs))
    assert not torch.equal(bufs[0][0], torch.zeros(4))


def test_tape_refuses_a_recompute_that_draws_more():
    tape = port_random.Tape()
    with port_random.taped(tape):
        a = port_random.draw("cpu", None, lambda g: torch.rand(3, generator=g))
    with port_random.taped(tape):
        assert port_random.draw("cpu", None, lambda g: torch.rand(3, generator=g)) is a
        with pytest.raises(RuntimeError, match="draws more"):
            port_random.draw("cpu", None, lambda g: torch.rand(3, generator=g))


# -- (f), (g) the store and the capture path, with a stand-in graph --------------------


class _StandInGraph:
    """``torch.cuda.CUDAGraph``'s surface: records registrations and
    replays (a replay runs nothing)."""

    made = []

    def __init__(self):
        self.generators, self.replays = [], 0
        _StandInGraph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """CUDA graphs replaced by :class:`_StandInGraph`; a capture runs its
    body eagerly once (as a real capture records it once)."""
    _StandInGraph.made = []
    captures = []

    @contextlib.contextmanager
    def graph(g, **kw):
        captures.append(g)
        yield g

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(port_jit, "_first_run", lambda device, fn: fn())
    port_kernels.reset_launch_counts()
    yield captures
    port_kernels.reset_launch_counts()


def _counting_body(n=2):
    calls = []

    def fn(*xs):
        calls.append(len(xs))
        port_kernels.add_counts({"layernorm_residual_fwd": n, "optimizer_update.TENSORS": 3})
        return xs[0] * 2

    return fn, calls


def test_store_bound_keys_and_counts(stand_in_graphs):
    """LRU order, the flag's bound read at insert time, hits, misses and
    evictions, ``<label>#<hex>`` keys stable for a signature."""
    store = compiled.GraphStore("train_step")
    fn, _ = _counting_body()
    x = torch.ones(2)
    set_flags({"compiled_cache_capacity": 2})
    try:
        for sig in ("a", "b"):
            assert store.lookup(sig) is None
            store.capture(sig, fn, [x])
        assert store.lookup("a") is not None  # a is now the most recent
        store.capture("c", fn, [x])  # evicts b
        assert list(store.entries()) == ["a", "c"]
        assert (store.hits, store.misses, store.evictions) == (1, 2, 1)
        set_flags({"compiled_cache_capacity": 1})
        store.capture("d", fn, [x])
        assert list(store.entries()) == ["d"] and store.evictions == 3
    finally:
        set_flags({"compiled_cache_capacity": 128})
    key = store.key_of(("sig", 1))
    assert key.startswith("train_step#") and len(key) == len("train_step#") + 10
    assert key == compiled.GraphStore("train_step").key_of(("sig", 1)) != store.key_of(("sig", 2))


def test_store_takes_back_capture_counts_and_adds_them_per_replay(stand_in_graphs):
    store = compiled.GraphStore("eval_step")
    fn, calls = _counting_body(2)
    gen = torch.Generator()
    entry = store.capture("s", fn, [torch.ones(3)], generators=[gen])
    assert entry.graph.generators == [gen] and calls == [1]
    assert entry.counts == {"layernorm_residual_fwd": 2, "optimizer_update.TENSORS": 3}
    assert port_kernels.counts()["layernorm_residual_fwd"] == 0  # the capture launched nothing
    for i in range(1, 4):
        out = store.replay(entry, torch.full((3,), float(i)))
        assert out is entry.outputs and entry.graph.replays == i
        assert torch.equal(entry.inputs[0], torch.full((3,), float(i)))
        assert port_kernels.launch_counts()["layernorm_residual_fwd"] == 2 * i
        assert port_kernels.counts()["optimizer_update.TENSORS"] == 3 * i
    assert calls == [1]  # replays never run the body
    with pytest.raises(ValueError, match="inputs"):
        store.replay(entry)


def test_compiled_train_step_counts_launches_per_executed_step(stand_in_graphs):
    """The first call of a signature runs the step (its launches count)
    and captures it (taken back); each later call replays it, counting its
    launches again and advancing the host's step count."""
    calls = []

    def loss_fn(m, x, t):
        calls.append(1)
        port_kernels.add_counts({"momentum_update": 1})
        return _mse(m, x, t)

    tm = _PortMLP(_mlp_arrays())
    step = train_step(tm, _make_opt(port_opt, "Momentum", tm.parameters()), loss_fn,
                      device="cpu")
    b = [torch.from_numpy(a) for a in _mlp_batches(1)[0]]
    loss = step._compiled("step", b)
    assert len(calls) == 2 and len(stand_in_graphs) == 1
    assert port_kernels.launch_counts()["momentum_update"] == 1
    assert step.optimizer._global_step == 1
    entry = next(iter(step.store.entries().values()))
    assert entry.cache_key.startswith("train_step#")
    replayed = step._compiled("step", b)
    assert len(calls) == 2 and entry.graph.replays == 1
    assert port_kernels.launch_counts()["momentum_update"] == 2
    assert step.optimizer._global_step == 2
    assert replayed is not entry.outputs and torch.equal(replayed, entry.outputs)
    assert (step.store.hits, step.store.misses) == (1, 1) and torch.isfinite(loss)


def test_a_failed_capture_raises_and_does_not_run_eagerly(stand_in_graphs, monkeypatch):
    """The capture fails (here: the stand-in refuses it): the step raises
    ``CaptureError`` after its first, real step, runs no eager step in its
    place, stores nothing, and the host's step count is that one step. The
    next call of the signature raises before it runs anything."""
    @contextlib.contextmanager
    def refusing(g, **kw):
        raise RuntimeError("operation not permitted when stream is capturing")
        yield  # pragma: no cover

    monkeypatch.setattr(torch.cuda, "graph", refusing)
    calls = []
    tm = _PortMLP(_mlp_arrays())
    step = train_step(tm, _make_opt(port_opt, "AdamW", tm.parameters()),
                      lambda m, x, t: calls.append(1) or _mse(m, x, t), device="cpu")
    b = [torch.from_numpy(a) for a in _mlp_batches(1)[0]]
    with pytest.raises(compiled.CaptureError, match="not run eagerly"):
        step._compiled("step", b)
    assert len(calls) == 1 and len(step.store) == 0
    assert step.optimizer._global_step == 1 and int(step.optimizer._step_t) == 1
    before = _port_params(tm)
    with pytest.raises(compiled.CaptureError, match="failed before"):
        step._compiled("step", b)
    assert len(calls) == 1 and len(_StandInGraph.made) == 1
    assert step.optimizer._global_step == 1 and int(step.optimizer._step_t) == 1
    assert all(np.array_equal(before[n], a) for n, a in _port_params(tm).items())


def test_compiled_eval_step_replays_copies(stand_in_graphs):
    model = _PortMLP(_mlp_arrays()).train()
    step = eval_step(model, fn=lambda m, x: {"y": m(x)}, device="cpu")
    x = torch.from_numpy(_mlp_batches(1)[0][0])
    first = step._run([x])
    # the capture path, driven as the card takes it
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_jit, "_captures", lambda device: True)
        out = step(x)
        again = step(x)
    assert torch.equal(out["y"], first["y"]) and torch.equal(again["y"], first["y"])
    entry = next(iter(step.store.entries().values()))
    assert again["y"] is not entry.outputs["y"] and entry.graph.replays == 1
    assert model.training


# -- eval_step, GradScaler, accumulators --------------------------------------------


@pytest.mark.parametrize("jit", [True, False])
def test_eval_step_matches_the_jax_eval_step(jit):
    jm, tm = _JaxMLP(_mlp_arrays()), _PortMLP(_mlp_arrays()).train()
    x = _mlp_batches(1)[0][0]
    want = np.asarray(jax_jit.eval_step(jm, jit=jit)(x))
    got = eval_step(tm, jit=jit, device="cpu")(x)
    np.testing.assert_allclose(got.numpy(), want, **MLP_TOL)
    assert tm.training and not got.requires_grad


def test_grad_scaler_raises_under_jit():
    """``GradScaler``'s found-inf decision is a host ``bool``: inside a
    compiled step it raises (as a ``bool`` of a tracer does in the JAX
    step) and never falls back; with ``jit=False`` it runs."""
    scaler = pamp.GradScaler()

    def loss_fn(m, x, t):
        loss = _mse(m, x, t)
        scaler.unscale_(opt)
        return scaler.scale(loss)

    b = _mlp_batches(1)[0]
    tm = _PortMLP(_mlp_arrays())
    opt = _make_opt(port_opt, "Momentum", tm.parameters())
    with pytest.raises(RuntimeError, match="compiled step"):
        train_step(tm, opt, loss_fn, jit=True, device="cpu")(*b)
    assert torch.isfinite(train_step(tm, opt, loss_fn, jit=False, device="cpu")(*b)["loss"])


@pytest.mark.parametrize("kind", ["AdamW", "Momentum", "Momentum_unfused"])
def test_accumulators_keep_their_storage(kind):
    """Accumulators are updated in place: a captured graph keeps reading
    and writing the same tensors."""
    tm = _PortMLP(_mlp_arrays())
    opt = _make_opt(port_opt, kind.split("_")[0], tm.parameters())
    set_flags({"use_fused_optimizer": kind != "Momentum_unfused"})
    try:
        step = train_step(tm, opt, _mse, device="cpu")
        batches = _mlp_batches(3, seed=8)
        step(*batches[0])
        ptrs = {k: [a.data_ptr() for a in v] for k, v in opt._accumulators.items()}
        for b in batches[1:]:
            step(*b)
        assert {k: [a.data_ptr() for a in v] for k, v in opt._accumulators.items()} == ptrs
        state = opt.state_dict()
        opt.set_state_dict(state)
        assert {k: [a.data_ptr() for a in v] for k, v in opt._accumulators.items()} == ptrs
        assert state["global_step"] == 3 and isinstance(state["global_step"], int)
    finally:
        set_flags({"use_fused_optimizer": True})
