"""Port parity: Adagrad, Adadelta, RMSProp, Adamax and Lamb, and per-parameter regularizers.

- Each optimizer, with each option the port keeps (Adagrad's initial
  accumulator, RMSProp's centered form and momentum, Lamb's exclude
  function, a weight decay, a clip), over 3 eager steps on the same
  gradients as the JAX optimizer: the expression order is the JAX one,
  every op rounded on its own on both sides, so the entries agree bit for
  bit but where torch's CPU float32 ``sqrt`` misrounds (about 1 input in
  160, by 1 ulp) and where a sum runs in another order (Lamb's two norms,
  the clips): every entry within :data:`SQRT_RTOL` of itself plus
  :data:`SQRT_RTOL` of the array's largest entry (entries near 0 after
  cancellation).
- The same optimizers through ``train_step(jit=True)`` on the CPU (the
  device step count and lr) against the JAX train step's update
  (``_apply_optimizer`` with its int32 step and float32 lr, 64-bit types
  off): as the eager step to it run op by op, and within 4 ulps of each
  parameter's largest entry of it under ``jax.jit`` (XLA contracts and
  reorders elementwise ops on the CPU).
- Per-parameter regularizers under SGD, Momentum (the fused kernel's plain
  version and the op-by-op update), AdamW and Lamb: as the eager step.
- The one gap: the JAX train step starts Adagrad's accumulator at 0
  (``init_opt_state`` fills zeros), its eager step and the port at
  ``initial_accumulator_value`` (ROADMAP.md Queue C).
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
from paddle_tpu_torch import flags  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402

torch.set_num_threads(1)

NAMES = ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")
# the JAX update under jax.jit against the port's: XLA's CPU fusion
# contracts and reorders elementwise ops; in ulps of each parameter's
# largest entry
JIT_ULPS = 4
# torch's CPU float32 sqrt is not correctly rounded for about 1 input in
# 160 (1 ulp), and torch and XLA sum a norm in other orders (an ulp of the
# norm moves Lamb's whole step); downstream an entry moves by a few ulps
SQRT_RTOL = 1e-6


def _held(got, want, msg):
    np.testing.assert_allclose(got, want, rtol=SQRT_RTOL,
                               atol=SQRT_RTOL * float(np.abs(want).max()), err_msg=msg)


def _excl(p):
    return p.name.endswith("bias") or p.name.endswith("1")


# name -> (constructor over (package, parameters), whether the JAX train
# step starts it as the eager step does)
CASES = {
    "adagrad": lambda m, p: m.Adagrad(0.1, parameters=p),
    "adagrad_init": lambda m, p: m.Adagrad(0.1, parameters=p, initial_accumulator_value=0.3,
                                           epsilon=1e-5),
    "adagrad_l2_clip": lambda m, p: m.Adagrad(0.1, parameters=p, weight_decay=m.L2Decay(0.01),
                                              grad_clip=m.ClipGradByGlobalNorm(1.0)),
    "adadelta": lambda m, p: m.Adadelta(0.5, parameters=p),
    "adadelta_rho": lambda m, p: m.Adadelta(1.0, epsilon=1e-5, rho=0.9, parameters=p,
                                            weight_decay=m.L1Decay(0.01)),
    "rmsprop": lambda m, p: m.RMSProp(0.01, parameters=p),
    "rmsprop_centered_momentum": lambda m, p: m.RMSProp(0.01, rho=0.9, momentum=0.9,
                                                        centered=True, parameters=p),
    "rmsprop_clip_value": lambda m, p: m.RMSProp(0.01, parameters=p,
                                                 grad_clip=m.ClipGradByValue(0.5)),
    "adamax": lambda m, p: m.Adamax(0.01, parameters=p),
    "adamax_betas_l2": lambda m, p: m.Adamax(0.02, beta1=0.8, beta2=0.99, epsilon=1e-6,
                                             parameters=p, weight_decay=0.01),
    "lamb": lambda m, p: m.Lamb(0.01, parameters=p),
    "lamb_exclude": lambda m, p: m.Lamb(0.01, lamb_weight_decay=0.1, parameters=p,
                                        exclude_from_weight_decay_fn=_excl),
    "lamb_betas_clip": lambda m, p: m.Lamb(0.02, beta1=0.8, beta2=0.95, epsilon=1e-5,
                                           parameters=p, grad_clip=m.ClipGradByNorm(0.5)),
}


def _arrays(seed=0, scale=0.5):
    rng = np.random.RandomState(seed)
    shapes = ((6, 16), (16,), (16, 3), (3,))
    out = {n: (rng.randn(*s) * scale).astype("f4") for n, s in zip(NAMES, shapes)}
    out["fc2.bias"][0] = 0.0  # a zero entry: L1's sign(0), Adamax's |g| ties
    return out


def _grads(seed=2, steps=3):
    rng = np.random.RandomState(seed)
    shapes = [a.shape for a in _arrays().values()]
    return [{n: (rng.randn(*s) * 10.0 ** -k).astype("f4") for n, s in zip(NAMES, shapes)}
            for k in range(steps)]


def _jax_params(arrays):
    # names the JAX exclude function sees: fc1.weight -> "...weight0" etc.
    return [JaxParameter.from_array(arrays[n], name=n.replace(".", "_") + str(i % 2))
            for i, n in enumerate(NAMES)]


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


class _JaxMLP(paddle.nn.Layer):
    def __init__(self, arrays):
        super().__init__()
        self.fc1 = paddle.nn.Linear(6, 16)
        self.fc2 = paddle.nn.Linear(16, 3)
        for i, (n, p) in enumerate(self.named_parameters()):
            p._array = jnp.asarray(arrays[n])
            p.name = n.replace(".", "_") + str(i % 2)


def _given_gradient_loss(m, *grads):
    return sum((p * g).sum() for p, g in zip(m.parameters(), grads))


def _port_named(model_or_params):
    return [(f"{n.replace('.', '_')}{i % 2}", p)
            for i, (n, p) in enumerate(model_or_params.named_parameters())]


# -- eager ----------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_eager_step_matches_jax(case):
    arrays, grads = _arrays(), _grads()
    jp = _jax_params(arrays)
    tm = _PortMLP(arrays)
    jo, to = CASES[case](jax_opt, jp), CASES[case](port_opt, _port_named(tm))
    for g in grads:
        for p, n in zip(jp, NAMES):
            p.grad = JaxTensor._from_array(jnp.asarray(g[n]))
        for n, p in tm.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        jo.step()
        to.step()
    for p, (n, q) in zip(jp, tm.named_parameters()):
        _held(q.detach().numpy(), np.asarray(p._array), n)
    js, ts = jo.state_dict(), to.state_dict()
    assert sorted(js) == sorted(ts) and js["global_step"] == ts["global_step"] == 3
    for k in js:
        if k != "global_step":
            _held(ts[k].numpy(), js[k], k)
    # the weights moved
    assert not np.array_equal(tm.fc1.weight.detach().numpy(), arrays["fc1.weight"])


def test_lamb_exclude_function_sees_the_named_parameter():
    seen = []
    tm = _PortMLP(_arrays())
    opt = port_opt.Lamb(0.01, parameters=tm.named_parameters(),
                        exclude_from_weight_decay_fn=lambda p: seen.append(
                            (p.name, tuple(p.shape))) or "bias" in p.name)
    for p in tm.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert seen == [(n, tuple(p.shape)) for n, p in tm.named_parameters()]


def test_lamb_trust_ratio_is_one_where_a_norm_is_zero():
    """A zero parameter with a zero update (a zero gradient): the trust
    ratio is 1 and nothing moves, with no NaN made on the way."""
    p = torch.nn.Parameter(torch.zeros(4))
    opt = port_opt.Lamb(0.1, parameters=[p])
    p.grad = torch.zeros(4)
    opt.step()
    assert torch.equal(p.detach(), torch.zeros(4))


# -- through the compiled train step ---------------------------------------------------


def _jax_step_updates(case, grads, jit):
    with jax.enable_x64(False):
        jm = _JaxMLP(_arrays())
        jo = CASES[case](jax_opt, jm.parameters())
        state = jax_jit.init_opt_state(jm, jo)

        def apply(state, grads, lr):
            return jax_jit._apply_optimizer(jm, jo, state, grads, lr)

        apply = jax.jit(apply) if jit else apply
        lr = jnp.asarray(jo.get_lr(), jnp.float32)
        for g in grads:
            new_params, opt_state = apply(state, {n: jnp.asarray(a) for n, a in g.items()}, lr)
            state = dict(state, params=new_params, opt=opt_state)
        return {n: np.asarray(a) for n, a in state["params"].items()}


def _port_step_updates(case, grads):
    tm = _PortMLP(_arrays())
    opt = CASES[case](port_opt, _port_named(tm))
    step = train_step(tm, opt, _given_gradient_loss, jit=True, device="cpu")
    for g in grads:
        step(*[torch.from_numpy(g[n]) for n in NAMES])
    assert opt._global_step == int(opt._step_t) == len(grads)
    return {n: p.detach().numpy().copy() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "adagrad_init"))
def test_compiled_step_matches_the_jax_train_step(case):
    grads = _grads()
    got = _port_step_updates(case, grads)
    op_by_op = _jax_step_updates(case, grads, jit=False)
    jitted = _jax_step_updates(case, grads, jit=True)
    for n in NAMES:
        _held(got[n], op_by_op[n], n)
        ulp = float(np.spacing(np.float32(np.abs(jitted[n]).max())))
        np.testing.assert_allclose(got[n], jitted[n], rtol=0, atol=JIT_ULPS * ulp, err_msg=n)


def test_adagrad_gap_the_jax_train_step_starts_at_zero():
    """``Linear(4, 2)``, ``Adagrad(0.1, initial_accumulator_value=1.0)``, one
    step on an all-ones batch: the JAX eager step and the port (eager and
    compiled) leave ``moment`` at 1 + g^2; the JAX train step, whose
    ``init_opt_state`` fills zeros, at g^2 (here 10 against 9)."""
    w = np.full((4, 2), 0.75, "f4")
    x, t = np.ones((1, 4), "f4"), np.zeros((1, 2), "f4")  # y = 3, so every g = 3

    def loss(m, x, t):
        return ((m(x) - t) ** 2).sum() / 2.0

    jm = paddle.nn.Linear(4, 2)
    jm.weight._array, jm.bias._array = jnp.asarray(w), jnp.zeros(2, jnp.float32)
    jstep = jax_jit.train_step(jm, jax_opt.Adagrad(0.1, parameters=jm.parameters(),
                                                   initial_accumulator_value=1.0), loss)
    jstep(x, t)
    jax_moment = np.asarray(jstep.state["opt"]["accums"]["moment"][0])

    jm2 = paddle.nn.Linear(4, 2)
    jm2.weight._array, jm2.bias._array = jnp.asarray(w), jnp.zeros(2, jnp.float32)
    jo2 = jax_opt.Adagrad(0.1, parameters=jm2.parameters(), initial_accumulator_value=1.0)
    out = loss(jm2, paddle.to_tensor(x), paddle.to_tensor(t))
    out.backward()
    jo2.step()
    eager_moment = np.asarray(jo2._accumulators["moment"][0])

    for jit in (True, False):
        tm = pnn.Linear(4, 2)
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(w))
            tm.bias.zero_()
        opt = port_opt.Adagrad(0.1, parameters=tm.parameters(), initial_accumulator_value=1.0)
        train_step(tm, opt, loss, jit=jit, device="cpu")(x, t)
        port_moment = opt._accumulators["moment"][0].numpy()
        np.testing.assert_array_equal(port_moment, eager_moment)
    np.testing.assert_allclose(eager_moment, 10.0)
    np.testing.assert_allclose(jax_moment, 9.0)


# -- per-parameter regularizers -----------------------------------------------------------


REG_CASES = {
    "sgd": lambda m, p: m.SGD(0.1, parameters=p, weight_decay=m.L2Decay(0.05)),
    "momentum": lambda m, p: m.Momentum(0.1, 0.9, parameters=p, weight_decay=m.L2Decay(0.05)),
    "adamw": lambda m, p: m.AdamW(0.01, parameters=p, weight_decay=0.05),
    "lamb": lambda m, p: m.Lamb(0.01, parameters=p),
}


@pytest.mark.parametrize("case,fused", [("sgd", False), ("momentum", True), ("momentum", False),
                                        ("adamw", False), ("lamb", False)])
def test_per_parameter_regularizer_matches_jax(case, fused, monkeypatch):
    """Parameter 0 carries ``L1Decay(0.2)`` and parameter 2 ``L2Decay(0.3)``
    (the slot the JAX ``Parameter`` keeps): they replace the global decay,
    apply under AdamW and Lamb too, and Momentum's fused kernel leaves their
    decay out."""
    monkeypatch.setattr(flags._REGISTRY["use_fused_optimizer"], "value", fused)
    arrays, grads = _arrays(), _grads()
    jp = _jax_params(arrays)
    tm = _PortMLP(arrays)
    tp = list(tm.parameters())
    for ps, mod in ((jp, jax_opt), (tp, port_opt)):
        ps[0].regularizer = mod.L1Decay(0.2)
        ps[2].regularizer = mod.L2Decay(0.3)
    jo, to = REG_CASES[case](jax_opt, jp), REG_CASES[case](port_opt, tp)
    for g in grads:
        for p, n in zip(jp, NAMES):
            p.grad = JaxTensor._from_array(jnp.asarray(g[n]))
        for p, n in zip(tp, NAMES):
            p.grad = torch.from_numpy(g[n].copy())
        jo.step()
        to.step()
    for p, q, n in zip(jp, tp, NAMES):
        _held(q.detach().numpy(), np.asarray(p._array), n)
    # against no regularizer at all, parameter 0 moved
    plain = _PortMLP(arrays)
    po = REG_CASES[case](port_opt, list(plain.parameters()))
    for g in grads:
        for p, n in zip(plain.parameters(), NAMES):
            p.grad = torch.from_numpy(g[n].copy())
        po.step()
    assert not np.array_equal(plain.fc1.weight.detach().numpy(), tp[0].detach().numpy())


# -- the state dicts carry across --------------------------------------------------------


@pytest.mark.parametrize("case", ["adadelta", "rmsprop_centered_momentum", "adamax", "lamb"])
def test_jax_state_dict_loads_into_the_port(case):
    """A JAX optimizer's ``state_dict`` after 2 steps, through
    ``convert.optimizer_state_from_numpy``, continues as the JAX one for a
    3rd."""
    arrays, grads = _arrays(), _grads()
    jp = _jax_params(arrays)
    jo = CASES[case](jax_opt, jp)
    for g in grads[:2]:
        for p, n in zip(jp, NAMES):
            p.grad = JaxTensor._from_array(jnp.asarray(g[n]))
        jo.step()
    tm = _PortMLP({n: np.asarray(p._array) for n, p in zip(NAMES, jp)})
    to = CASES[case](port_opt, _port_named(tm))
    to.set_state_dict(convert.optimizer_state_from_numpy(jo.state_dict(), to))
    assert to._global_step == 2
    for p, n in zip(jp, NAMES):
        p.grad = JaxTensor._from_array(jnp.asarray(grads[2][n]))
    for n, p in tm.named_parameters():
        p.grad = torch.from_numpy(grads[2][n].copy())
    jo.step()
    to.step()
    for p, (n, q) in zip(jp, tm.named_parameters()):
        _held(q.detach().numpy(), np.asarray(p._array), n)
