"""Port parity: the lr schedules, the gradient clips, the decays and the dygraph steps that use them.

- Each of the 12 schedules of ``paddle_tpu/optimizer/lr.py`` against the
  JAX one over 60 steps: the same Python float at every step (rel 1e-12)
  and the same ``state_dict``.
- Each clip and ``L1Decay`` against the JAX one on seeded gradients (atol
  1e-7), the clip active or not.
- One SGD step, one AdamW step with ``ClipGradByGlobalNorm``, and one
  Momentum step with ``L2Decay`` and ``ClipGradByGlobalNorm`` against the
  JAX step on identical gradients (the last one failed while Momentum
  folded its decay into the kernel after the clip).
- ``train_step(jit=True)`` under ``NoamDecay`` for 5 Momentum steps
  against the eager step: the lr it writes before each step is the JAX
  schedule's float32, and the parameters agree to 1e-6.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu.optimizer as jax_opt  # noqa: E402
from paddle_tpu.framework.tensor import Parameter as JaxParameter  # noqa: E402
from paddle_tpu.framework.tensor import Tensor as JaxTensor  # noqa: E402

from paddle_tpu_torch import flags  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402

torch.set_num_threads(1)

STEPS = 60


def _schedules(lr_mod):
    """name -> a fresh schedule of ``lr_mod`` (either package's)."""
    return {
        "noam": lambda: lr_mod.NoamDecay(d_model=512, warmup_steps=20, learning_rate=1.0),
        "step": lambda: lr_mod.StepDecay(0.1, step_size=7, gamma=0.5),
        "multistep": lambda: lr_mod.MultiStepDecay(0.1, milestones=[5, 17, 40], gamma=0.3),
        "exponential": lambda: lr_mod.ExponentialDecay(0.1, gamma=0.93),
        "natural_exp": lambda: lr_mod.NaturalExpDecay(0.1, gamma=0.05),
        "inverse_time": lambda: lr_mod.InverseTimeDecay(0.1, gamma=0.2),
        "polynomial": lambda: lr_mod.PolynomialDecay(0.1, decay_steps=25, end_lr=0.001,
                                                     power=2.0),
        "polynomial_cycle": lambda: lr_mod.PolynomialDecay(0.1, decay_steps=25, end_lr=0.001,
                                                           power=1.5, cycle=True),
        "cosine": lambda: lr_mod.CosineAnnealingDecay(0.1, T_max=45, eta_min=0.002),
        "linear_warmup": lambda: lr_mod.LinearWarmup(0.1, warmup_steps=10, start_lr=0.0,
                                                     end_lr=0.1),
        "linear_warmup_noam": lambda: lr_mod.LinearWarmup(
            lr_mod.NoamDecay(d_model=64, warmup_steps=30), warmup_steps=10, start_lr=1e-4,
            end_lr=0.02),
        "piecewise": lambda: lr_mod.PiecewiseDecay([10, 30, 45], [0.1, 0.05, 0.01, 0.001]),
        "lambda": lambda: lr_mod.LambdaDecay(0.1, lambda e: 0.95 ** e + 0.01 * (e % 3)),
        "plateau": lambda: lr_mod.ReduceOnPlateau(0.1, mode="min", factor=0.5, patience=3,
                                                  threshold=1e-3, cooldown=2, min_lr=0.004),
    }


def _metrics():
    """A loss that falls, stalls, then falls again (ReduceOnPlateau's input)."""
    rng = np.random.RandomState(3)
    return [1.0 / (1 + min(i, 12) + max(0, i - 35)) + 1e-4 * rng.rand() for i in range(STEPS)]


def _trace(sched, plateau):
    out = []
    for i in range(STEPS):
        out.append((sched(), sched.state_dict()))
        if plateau:
            sched.step(_metrics()[i])
        else:
            sched.step()
    return out


@pytest.mark.parametrize("name", sorted(_schedules(port_opt.lr)))
def test_schedule_matches_jax(name):
    plateau = name == "plateau"
    got = _trace(_schedules(port_opt.lr)[name](), plateau)
    want = _trace(_schedules(jax_opt.lr)[name](), plateau)
    for i, ((g, gs), (w, ws)) in enumerate(zip(got, want)):
        assert math.isclose(g, w, rel_tol=1e-12, abs_tol=0.0), (name, i, g, w)
        assert gs.keys() == ws.keys() and gs["last_epoch"] == ws["last_epoch"], (name, i)
        assert math.isclose(gs["last_lr"], ws["last_lr"], rel_tol=1e-12), (name, i)
    # the values really move (a schedule that stood still would pass above)
    assert len({round(g, 15) for g, _ in got}) > 2, name


def test_schedule_state_dict_round_trip():
    a = port_opt.lr.NoamDecay(d_model=512, warmup_steps=20)
    for _ in range(7):
        a.step()
    b = port_opt.lr.NoamDecay(d_model=512, warmup_steps=20)
    b.set_state_dict(a.state_dict())
    a.step()
    b.step()
    assert a() == b() and a.last_epoch == b.last_epoch == 8


# -- clips and decays -----------------------------------------------------------------


def _grads(seed, scale):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype("f4") for s in ((6, 5), (5,), (2, 3, 4))]


def _jax_clip(clip, grads):
    return [np.asarray(g) for _, g in clip([(i, jnp.asarray(g)) for i, g in enumerate(grads)])]


def _port_clip(clip, grads):
    return [g.numpy() for _, g in clip([(i, torch.from_numpy(g.copy())) for i, g in
                                        enumerate(grads)])]


@pytest.mark.parametrize("kind,args", [("ClipGradByValue", (0.3,)),
                                       ("ClipGradByValue", (0.5, -0.2)),
                                       ("ClipGradByNorm", (0.7,)),
                                       ("ClipGradByGlobalNorm", (0.9,))])
@pytest.mark.parametrize("scale", [0.02, 1.0], ids=["inactive", "active"])
def test_clip_matches_jax(kind, args, scale):
    grads = _grads(1, scale)
    got = _port_clip(getattr(port_opt, kind)(*args), grads)
    want = _jax_clip(getattr(jax_opt, kind)(*args), grads)
    for g, w, raw in zip(got, want, grads):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
    changed = any(not np.array_equal(g, raw) for g, raw in zip(got, grads))
    assert changed == (scale == 1.0)


def test_global_norm_clip_is_one_factor_from_device_tensors():
    """The factor is a tensor (no host decision), the norm summed in float32
    over every gradient: the clipped gradients' joint norm is the clip."""
    grads = [torch.from_numpy(g) for g in _grads(2, 1.0)]
    out = port_opt.ClipGradByGlobalNorm(0.5)([(i, g) for i, g in enumerate(grads)])
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for _, g in out))
    assert abs(norm - 0.5) < 1e-6
    ratios = {round(float((c / g).mean()), 6) for (_, c), g in zip(out, grads)}
    assert len(ratios) == 1


@pytest.mark.parametrize("decay", ["L1Decay", "L2Decay"])
def test_decay_matches_jax(decay):
    rng = np.random.RandomState(4)
    p, g = rng.randn(7, 3).astype("f4"), rng.randn(7, 3).astype("f4")
    p[0, 0] = 0.0  # sign(0) = 0 in both
    got = getattr(port_opt, decay)(0.03)(torch.from_numpy(p), torch.from_numpy(g)).numpy()
    want = np.asarray(getattr(jax_opt, decay)(0.03)(jnp.asarray(p), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


# -- dygraph steps ----------------------------------------------------------------------


def _twins(seed=0, shapes=((5, 7), (7,), (3, 4, 2))):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*s).astype("f4") for s in shapes]
    grads = [rng.randn(*s).astype("f4") for s in shapes]
    jp = [JaxParameter.from_array(a, name=f"param_{i}") for i, a in enumerate(arrays)]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]
    return jp, tp, grads


def _one_step(jo, to, jp, tp, grads):
    for p, g in zip(jp, grads):
        p.grad = JaxTensor._from_array(jnp.asarray(g))
    for p, g in zip(tp, grads):
        p.grad = torch.from_numpy(g.copy())
    jo.step()
    to.step()
    return [np.asarray(p._array) for p in jp], [p.detach().numpy().copy() for p in tp]


@pytest.mark.parametrize("kind,kw", [
    ("SGD", {}),
    ("SGD", {"weight_decay": port_opt.L2Decay(0.01)}),
    ("SGD", {"weight_decay": "L1", "grad_clip": "norm"}),
    ("AdamW", {"grad_clip": "global"}),
    ("Adam", {"grad_clip": "value"}),
], ids=["sgd", "sgd_l2", "sgd_l1_clip_norm", "adamw_clip_global", "adam_clip_value"])
def test_dygraph_step_matches_jax(kind, kw):
    def build(mod, params):
        args = dict(learning_rate=0.05, parameters=params)
        wd = kw.get("weight_decay")
        if wd == "L1":
            args["weight_decay"] = mod.L1Decay(0.02)
        elif wd is not None:
            args["weight_decay"] = mod.L2Decay(0.01)
        clip = kw.get("grad_clip")
        if clip is not None:
            args["grad_clip"] = {"norm": lambda: mod.ClipGradByNorm(0.8),
                                 "global": lambda: mod.ClipGradByGlobalNorm(1.0),
                                 "value": lambda: mod.ClipGradByValue(0.4)}[clip]()
        return getattr(mod, kind)(**args)

    jp, tp, grads = _twins()
    want, got = _one_step(build(jax_opt, jp), build(port_opt, tp), jp, tp, grads)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)


@pytest.mark.parametrize("fused", [True, False])
def test_momentum_with_clip_decays_before_the_clip(fused, monkeypatch):
    """Momentum + ``L2Decay(1e-4)`` + ``ClipGradByGlobalNorm``: the clip sees
    the decayed gradient, so the fused kernel must not fold the decay in
    after it (``paddle_tpu/optimizer/__init__.py:245-255``). Large
    parameters make the misplaced decay visible: folded into the kernel
    after the clip it moved a parameter by 1.2e-2 here (the limit is
    2e-6)."""
    monkeypatch.setattr(flags._REGISTRY["use_fused_optimizer"], "value", fused)
    jp, tp, grads = _twins(seed=5)
    for p in jp:
        p._array = p._array * 100.0
    with torch.no_grad():
        for p in tp:
            p.mul_(100.0)

    def build(mod, params):
        return mod.Momentum(learning_rate=0.5, momentum=0.9, parameters=params,
                            weight_decay=mod.L2Decay(1e-4),
                            grad_clip=mod.ClipGradByGlobalNorm(0.5))

    jo, to = build(jax_opt, jp), build(port_opt, tp)
    assert to._fused_decay_coeff() is None
    want, got = _one_step(jo, to, jp, tp, grads)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6)
    for g, w in zip(to._accumulators["velocity"], jo._accumulators["velocity"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)


def _noam_run(jit, steps=5):
    """A small MLP trained ``steps`` steps by Momentum under NoamDecay +
    ClipGradByGlobalNorm; returns (the lr the step used each time,
    parameters after). (Adam's bias correction is float32 under
    ``jit=True`` and float64 eagerly, by design; Momentum reads only the
    lr.)"""
    g = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(), torch.nn.Linear(8, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    sched = port_opt.lr.NoamDecay(d_model=64, warmup_steps=3, learning_rate=2.0)
    opt = port_opt.Momentum(learning_rate=sched, parameters=model.parameters(),
                            grad_clip=port_opt.ClipGradByGlobalNorm(1.0))
    step = train_step(model, opt, lambda m, x, y: ((m(x) - y) ** 2).mean(), jit=jit,
                      device="cpu")
    rng = np.random.RandomState(1)
    x, y = rng.randn(4, 6).astype("f4"), rng.randn(4, 3).astype("f4")
    lrs = []
    for _ in range(steps):
        step(x, y)
        lrs.append(float(opt._lr_t) if jit else opt.get_lr())
        sched.step()
    return lrs, [p.detach().numpy().copy() for p in model.parameters()]


def test_compiled_step_follows_noam_as_eager():
    """Under ``jit=True`` (eager on the CPU, with the device scalars) the lr
    written before each step is the JAX schedule's value in float32, a new
    one every step, and the parameters equal the eager run's."""
    jit_lrs, jit_params = _noam_run(True)
    eager_lrs, eager_params = _noam_run(False)
    jsched = jax_opt.lr.NoamDecay(d_model=64, warmup_steps=3, learning_rate=2.0)
    want = []
    for _ in range(5):
        want.append(jsched())
        jsched.step()
    assert jit_lrs == [float(np.float32(w)) for w in want]
    assert eager_lrs == want and len(set(want)) == 4  # steps 0 and 1 share Noam's step 1
    for a, b in zip(jit_params, eager_params):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
