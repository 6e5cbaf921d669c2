"""Port parity: ResNet training under AMP (``paddle_tpu_torch`` ResNet slice in bf16).

A bottleneck ResNet of depth [1, 1, 1, 1], 10 classes, at batch 2 x 64 x 64,
built in the JAX package; its weights cross through ``paddle_tpu.save`` and
``convert.load_resnet``. The JAX side runs its TPU kernels where the TPU
runs them, in interpret mode on the CPU (routed here by ``monkeypatch``,
nothing in the package edited): the fused conv + bn + relu through
``conv_bn_relu._fused(..., interpret=True, force=True)`` and, with
``FLAGS_use_pallas_pool_bwd`` on in both packages, the stem's max-pool
backward through ``pool_backward.max_pool2d_backward(..., interpret=True)``.
The port's CPU path runs its plain versions: the kernels' arithmetic.

- O1 (``auto_cast``): the loss and every gradient of one step against the
  JAX package's (``jax.value_and_grad`` of the step's own construction, op
  by op: jitted on the CPU, XLA keeps float32 between fused bf16 ops). Each
  limit sits between the sound reading and the f32 answer's (the port
  without ``auto_cast``), which must fail it.
- O2 (``decorate``: bf16 parameters): the gradients of one O2 step through
  two Momentum steps, the JAX train step's update against the port's
  optimizer: the parameters and velocities equal bit for bit, as the port
  rounds the update's scalars where the JAX step does.
"""
import sys
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
import paddle_tpu.optimizer as jax_opt  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu import flags as jax_flags  # noqa: E402
from paddle_tpu.framework import autograd as jax_autograd  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.framework.tensor import Tensor as JaxTensor  # noqa: E402
from paddle_tpu.models import resnet as jax_resnet  # noqa: E402
from paddle_tpu.ops.pallas import conv_bn_relu as _  # noqa: E402,F401
from paddle_tpu.ops.pallas import pool_backward as jpb  # noqa: E402

from paddle_tpu_torch import amp as pamp  # noqa: E402
from paddle_tpu_torch import convert, flags  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402
from paddle_tpu_torch.models import resnet as port_resnet  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops.cuda import conv_bn_relu as tcbr  # noqa: E402
from paddle_tpu_torch.ops.cuda import pool_backward as tpb  # noqa: E402

jcbr = sys.modules["paddle_tpu.ops.pallas.conv_bn_relu"]
torch.set_num_threads(1)

B, HW, CLASSES = 2, 64, 10
TRIPLES = 1 + 2 * 4  # the stem, conv1/bn1 and conv2/bn2 of each of the 4 blocks


def _jax_model():
    return jax_resnet.ResNet(jax_resnet.BottleneckBlock, [1, 1, 1, 1], num_classes=CLASSES)


def _port_model(path):
    return convert.load_resnet(
        path, lambda **kw: port_resnet.ResNet(port_resnet.BottleneckBlock, [1, 1, 1, 1], **kw),
        num_classes=CLASSES)


@pytest.fixture()
def saved(tmp_path):
    paddle.seed(0)
    jm = _jax_model()
    path = str(tmp_path / "resnet.pdparams")
    paddle.save(jm.state_dict(), path)
    return jm, path


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, 3, HW, HW).astype("f4"), rng.randint(0, CLASSES, (B,)).astype("int64")]


@pytest.fixture()
def kernels(monkeypatch):
    """Both packages' pool-backward flag on; the JAX fused conv and pool
    backward routed to their Pallas kernels in interpret mode; the calls
    into each counted."""
    calls = {"jax_fused": 0, "jax_pool": 0, "port_pool": 0}
    fused = jcbr._fused

    def jax_fused(*a, **k):
        calls["jax_fused"] += 1
        return fused(*a, **{**k, "interpret": True, "force": True})

    pool_bwd = jpb.max_pool2d_backward

    def jax_pool(*a, **k):
        calls["jax_pool"] += 1
        return pool_bwd(*a, **{**k, "interpret": True})

    supported = jpb.max_pool_backward_supported
    monkeypatch.setattr(jcbr, "_fused", jax_fused)
    monkeypatch.setattr(jpb, "max_pool2d_backward", jax_pool)
    # the JAX gate less its TPU test (the port's gate is the same)
    monkeypatch.setattr(jpb, "on_tpu_platform", lambda: True)
    monkeypatch.setattr(jpb, "max_pool_backward_supported",
                        lambda *a: supported(*a))
    monkeypatch.setattr(jax_flags._REGISTRY["use_pallas_pool_bwd"], "value", True)
    monkeypatch.setattr(flags._REGISTRY["use_pallas_pool_bwd"], "value", True)
    port_pool = tpb.max_pool2d_backward

    def counted_pool(*a, **k):
        calls["port_pool"] += 1
        return port_pool(*a, **k)

    monkeypatch.setattr(tpb, "max_pool2d_backward", counted_pool)
    return calls


# -- O1: one step's loss and gradients ----------------------------------------------

# Each limit about the geometric mean of the sound reading and the f32
# answer's (the port without auto_cast), read on the CPU (bf16 / f32): the
# loss (bit-equal, for which an f32 ulp of the loss, ~2.4e-7, stands / 2.9e-3),
# the gradient's relative L2 error over every parameter (6.1e-3 / 0.34) and
# each gradient entry over the largest entry of its layer (1.8e-2 / 0.57:
# bf16 keeps 8 bits, and a relu gate or a sum of rows can round on either
# side of a bf16 step).
O1_LOSS_ATOL = 3e-5
O1_GRAD_REL_L2 = 4.5e-2
O1_GRAD_OF_LAYER_MAX = 0.1


def _jax_o1_loss_and_grads(jm, batch):
    params = OrderedDict((n, p._array) for n, p in jm.named_parameters())
    buffers = OrderedDict((n, b._array) for n, b in jm.named_buffers())

    def loss_of(params):
        state = {"params": params, "frozen": OrderedDict(), "buffers": buffers}
        with jax_jit._swapped_model(jm, state), jax_autograd.no_grad():
            x, y = (JaxTensor._from_array(jnp.asarray(a)) for a in batch)
            with jamp.auto_cast():
                loss = jF.cross_entropy(jm(x), y).mean()
        return loss._array

    jm.train()
    loss, grads = jax.value_and_grad(loss_of)(params)
    return float(loss), {n: np.asarray(g, dtype="f4") for n, g in grads.items()}


def _errors(loss, grads, want_loss, want):
    scale = {}
    for name, g in want.items():
        layer = name.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(np.abs(g).max()))
    num = sum(float(np.square(grads[n].astype("f8") - g).sum()) for n, g in want.items())
    den = sum(float(np.square(g.astype("f8")).sum()) for g in want.values())
    worst = max(float(np.abs(grads[n] - g).max()) / scale[n.rpartition(".")[0]]
                for n, g in want.items())
    return abs(loss - want_loss), (num / den) ** 0.5, worst


def test_o1_step_loss_and_gradients_match_the_jax_kernels(saved, kernels, monkeypatch):
    jm, path = saved
    batch = _batch(5)
    want_loss, want = _jax_o1_loss_and_grads(jm, batch)
    assert kernels["jax_fused"] == TRIPLES and kernels["jax_pool"] == 1

    def port(amp_on):
        tm = _port_model(path).train()
        x, y = map(torch.from_numpy, batch)
        if amp_on:
            with pamp.auto_cast():
                loss = F.cross_entropy(tm(x), y)
        else:
            loss = F.cross_entropy(tm(x), y)
        loss.backward()
        return float(loss.detach()), {n: p.grad.numpy() for n, p in tm.named_parameters()}

    core_dtypes = []
    real_core = tcbr._TrainCore.apply

    def spy(p2, *rest):
        core_dtypes.append(p2.dtype)
        return real_core(p2, *rest)

    monkeypatch.setattr(tcbr._TrainCore, "apply", spy)
    sound = _errors(*port(True), want_loss, want)
    assert core_dtypes == [torch.bfloat16] * TRIPLES and kernels["port_pool"] == 1
    control = _errors(*port(False), want_loss, want)
    limits = (O1_LOSS_ATOL, O1_GRAD_REL_L2, O1_GRAD_OF_LAYER_MAX)
    assert all(e <= lim for e, lim in zip(sound, limits)), (sound, limits)
    assert all(e > lim for e, lim in zip(control, limits)), (control, limits)


# -- O2: one Momentum step on bf16 parameters ------------------------------------------


@pytest.mark.parametrize("weight_decay", [None, 1e-4])
def test_o2_momentum_steps_match_the_jax_train_steps_update_bit_for_bit(saved, weight_decay):
    """``decorate(level="O2")`` makes the parameters bf16 (the batch norms'
    running buffers stay f32). The gradients of the JAX model's O2 step
    (bf16) go through two Momentum steps (lr 0.1, momentum 0.9, with and
    without L2 decay) in the JAX train step's own update
    (``_apply_optimizer`` with its float32 ``lr`` array, ``jit.py:441``) and
    in the port's optimizer: every parameter and velocity after them equal
    bit for bit. The JAX step's ``mu`` and ``wd`` are weak Python scalars,
    rounded to bf16 before they multiply, and its ``lr`` a float32 array,
    so ``param - lr * v`` is float32 rounded once to bf16; the port's plain
    update rounds at the same points (a Python ``mu`` in torch multiplies in
    float32, which moved 21% of the velocities)."""
    jm, path = saved
    batch = _batch(3)
    jamp.decorate(jm, level="O2")
    params = OrderedDict((n, p._array) for n, p in jm.named_parameters())
    buffers = OrderedDict((n, b._array) for n, b in jm.named_buffers())

    def loss_of(params):
        state = {"params": params, "frozen": OrderedDict(), "buffers": buffers}
        with jax_jit._swapped_model(jm, state), jax_autograd.no_grad():
            x, y = (JaxTensor._from_array(jnp.asarray(a)) for a in batch)
            with jamp.auto_cast(level="O2"):
                return jF.cross_entropy(jm(x), y).mean()._array

    jm.train()
    grads = jax.grad(loss_of)(params)
    assert all(g.dtype == jnp.bfloat16 for g in grads.values())
    jopt = jax_opt.Momentum(learning_rate=0.1, momentum=0.9, weight_decay=weight_decay,
                            parameters=jm.parameters())
    state = jax_jit.init_opt_state(jm, jopt)
    lr = jnp.asarray(jopt.get_lr(), jnp.float32)
    for _ in range(2):
        new_params, opt_state = jax_jit._apply_optimizer(jm, jopt, state, grads, lr)
        state = dict(state, params=new_params, opt=opt_state)

    tm = pamp.decorate(_port_model(path), level="O2")
    popt = port_opt.Momentum(learning_rate=0.1, momentum=0.9, weight_decay=weight_decay,
                             parameters=tm.parameters())
    for _ in range(2):
        for name, p in tm.named_parameters():
            p.grad = torch.from_numpy(np.asarray(grads[name].astype(jnp.float32))).bfloat16()
        popt.step()
    for name, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      np.asarray(state["params"][name].astype(jnp.float32)),
                                      err_msg=name)
    jvel = state["opt"]["accums"]["velocity"]
    pvel = popt._accumulators["velocity"]
    assert len(pvel) == len(jvel) == len(params)
    for v, jv in zip(pvel, jvel):
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(v.float().numpy(), np.asarray(jv.astype(jnp.float32)))
