"""Port parity: the max-pool2d backward (``paddle_tpu_torch.ops.cuda.pool_backward``).

The plain version is held against the JAX package's Pallas kernel in
interpret mode and against ``jax.vjp`` of ``reduce_window`` (XLA's
``select_and_scatter``) at the five geometries of
``tests/test_pool_backward_pallas.py``, on inputs with ties (integers from a
small range, and a relu'd input whose zeros tie). ``dy`` holds multiples of
1/8 in [-4, 4): sums of up to nine of them are exact in float32 in any
order, so the comparison is bit for bit; one case with a normal ``dy`` is
held to 4 ulps of the largest sum (the references add their taps in another
order). Then the flag: ``max_pool2d`` with ``FLAGS_use_pallas_pool_bwd`` on
gives torch's own gradient, and one ResNet-18 training step with the flag
on equals the step with it off and the JAX package's step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
import paddle_tpu.optimizer as jax_opt  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.models import resnet as jax_resnet  # noqa: E402
from paddle_tpu.ops.pallas.pool_backward import max_pool2d_backward as jax_pool_bwd  # noqa: E402

from paddle_tpu_torch import convert, flags  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402
from paddle_tpu_torch.models import resnet as port_resnet  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops.cuda import pool_backward as tpb  # noqa: E402

torch.set_num_threads(1)

GEOMS = [
    ((2, 3, 8, 8), (2, 2), (2, 2), (0, 0)),
    ((2, 2, 9, 9), (3, 3), (2, 2), (1, 1)),
    ((1, 4, 12, 16), (3, 3), (1, 1), (1, 1)),
    ((2, 2, 14, 14), (3, 3), (2, 2), (1, 1)),
    ((1, 1, 8, 8), (3, 2), (2, 3), (1, 0)),
]
INPUTS = ["integers", "relu", "normal"]


def _x(kind, shape, rng):
    if kind == "integers":  # most windows hold their maximum several times
        return rng.randint(0, 3, shape).astype(np.float32)
    x = rng.randn(*shape).astype(np.float32)
    # shifted, so that whole windows of the relu'd input are zeros and tie
    return np.maximum(x - 1.0, 0.0) if kind == "relu" else x


def _out_shape(shape, ks, st, p):
    return shape[:2] + tuple((shape[2 + i] + 2 * p[i] - ks[i]) // st[i] + 1 for i in range(2))


def _exact_dy(shape, rng):
    return (rng.randint(-32, 32, shape) / 8.0).astype(np.float32)


def _xla_pool_vjp(x, dy, ks, st, p):
    pads = ((0, 0), (0, 0), (p[0], p[0]), (p[1], p[1]))

    def pool(v):
        return lax.reduce_window(v, -jnp.inf, lax.max, (1, 1) + ks, (1, 1) + st, pads)

    y, vjp = jax.vjp(pool, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("shape,ks,st,p", GEOMS)
def test_plain_version_equals_the_jax_kernel_and_xla_bit_for_bit(shape, ks, st, p, kind):
    rng = np.random.RandomState(0)
    x = _x(kind, shape, rng)
    dy = _exact_dy(_out_shape(shape, ks, st, p), rng)
    y, want_xla = _xla_pool_vjp(x, dy, ks, st, p)
    want_kernel = np.asarray(jax_pool_bwd(jnp.asarray(x), jnp.asarray(y), jnp.asarray(dy),
                                          kernel=ks, stride=st, padding=p, interpret=True))
    ty = F.max_pool2d(torch.from_numpy(x), ks, st, p)
    np.testing.assert_array_equal(ty.numpy(), y)
    got = tpb.max_pool2d_backward(torch.from_numpy(x), ty, torch.from_numpy(dy), ks, st, p)
    np.testing.assert_array_equal(got.numpy(), want_kernel)
    np.testing.assert_array_equal(got.numpy(), want_xla)
    if kind != "normal":  # the inputs really tie: some window holds its maximum twice
        xp = torch.nn.functional.pad(torch.from_numpy(x), (p[1], p[1], p[0], p[0]),
                                     value=float("nan"))
        taps = xp.unfold(2, ks[0], st[0]).unfold(3, ks[1], st[1])
        assert ((taps == ty[..., None, None]).sum((-1, -2)) > 1).any()


@pytest.mark.parametrize("shape,ks,st,p", GEOMS)
def test_plain_version_with_a_normal_dy_within_summation_order(shape, ks, st, p):
    """A gradient element sums at most ceil(kh/sh)*ceil(kw/sw) <= 9 taps; the
    references add them in another order: 4 ulps of the largest |dx|."""
    rng = np.random.RandomState(1)
    x = _x("integers", shape, rng)
    dy = rng.randn(*_out_shape(shape, ks, st, p)).astype(np.float32)
    y, want = _xla_pool_vjp(x, dy, ks, st, p)
    got = tpb.max_pool2d_backward(torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(dy), ks, st, p).numpy()
    assert np.abs(got - want).max() <= 4 * np.spacing(np.float32(np.abs(want).max()))


def test_first_maximum_in_row_major_order_takes_the_gradient():
    x = torch.zeros(1, 1, 2, 2)
    y = torch.zeros(1, 1, 1, 1)
    dx = tpb.max_pool2d_backward(x, y, torch.full((1, 1, 1, 1), 3.0), (2, 2), (2, 2), (0, 0))
    assert dx.flatten().tolist() == [3.0, 0.0, 0.0, 0.0]
    x = torch.tensor([[[[0.0, 1.0], [1.0, 1.0]]]])
    dx = tpb.max_pool2d_backward(x, torch.ones(1, 1, 1, 1), torch.full((1, 1, 1, 1), 3.0),
                                 (2, 2), (2, 2), (0, 0))
    assert dx.flatten().tolist() == [0.0, 3.0, 0.0, 0.0]


def test_padding_never_takes_the_gradient_even_at_minus_infinity():
    """A window whose values are all -inf ties with torch's -inf padding;
    the gradient still lands on a real element."""
    x = torch.full((1, 1, 2, 2), float("-inf"))
    y = F.max_pool2d(x, 3, 2, 1)
    dx = tpb.max_pool2d_backward(x, y, torch.ones_like(y), (3, 3), (2, 2), (1, 1))
    assert dx.sum().item() == y.numel() and dx.flatten()[0].item() == 1.0


@pytest.mark.parametrize("kind", ["integers", "relu"])
@pytest.mark.parametrize("shape,ks,st,p", GEOMS)
def test_flag_routes_max_pool2d_backward_through_the_entry(shape, ks, st, p, kind, monkeypatch):
    """Flag on: ``max_pool2d``'s gradient comes from ``max_pool2d_backward``
    (one call) and equals torch's own backward, which keeps the first
    maximum too, bit for bit on an exactly summable ``dy``; the forward is
    unchanged."""
    rng = np.random.RandomState(2)
    x = _x(kind, shape, rng)
    dy = torch.from_numpy(_exact_dy(_out_shape(shape, ks, st, p), rng))
    ref = torch.from_numpy(x).requires_grad_()
    y_ref = F.max_pool2d(ref, ks, st, p)
    y_ref.backward(dy)
    calls = []
    real = tpb.max_pool2d_backward
    monkeypatch.setattr(tpb, "max_pool2d_backward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(flags._REGISTRY["use_pallas_pool_bwd"], "value", True)
    t = torch.from_numpy(x).requires_grad_()
    y = F.max_pool2d(t, ks, st, p)
    y.backward(dy)
    assert len(calls) == 1
    assert torch.equal(y, y_ref) and torch.equal(t.grad, ref.grad)


def test_gate_follows_the_jax_gate(monkeypatch):
    ok = tpb.max_pool_backward_supported
    assert ok((2, 3, 8, 8), torch.float32, (0, 0), "NCHW")
    assert ok((2, 3, 8, 8), torch.bfloat16, [0, 0], "NCHW")
    assert not ok((2, 3, 8, 8), torch.float32, (0, 0), "NHWC")
    assert not ok((2, 3, 8, 8), torch.float32, (1, 0), "NCHW")  # a ceil_mode tail
    assert not ok((2, 3, 8, 8), torch.int32, (0, 0), "NCHW")
    assert not ok((3, 8, 8), torch.float32, (0, 0), "NCHW")
    assert not ok((0, 3, 8, 8), torch.float32, (0, 0), "NCHW")
    # a refused pool takes torch's backward with the flag on
    monkeypatch.setattr(flags._REGISTRY["use_pallas_pool_bwd"], "value", True)
    monkeypatch.setattr(tpb, "max_pool2d_backward", lambda *a, **k: pytest.fail("entered"))
    x = torch.randn(1, 2, 7, 7, generator=torch.Generator().manual_seed(0)).requires_grad_()
    F.max_pool2d(x, 2, 2, 0, ceil_mode=True).sum().backward()
    assert x.grad.sum().item() == 2 * 4 * 4
    with torch.no_grad():  # nothing to differentiate: the pooling as ever
        F.max_pool2d(x, 2, 2, 0)


def test_flag_default_is_off_and_named_as_in_the_jax_package():
    from paddle_tpu import flags as jax_flags

    assert flags.flag("use_pallas_pool_bwd") is False
    assert jax_flags.flag("use_pallas_pool_bwd") is False


def test_non_cpu_tensor_reaches_the_kernel_entry_and_empty_launches_nothing():
    meta = dict(device="meta")
    x, y = torch.empty(2, 3, 8, 8, **meta), torch.empty(2, 3, 4, 4, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        tpb.max_pool2d_backward(x, y, y, (2, 2), (2, 2), (0, 0))
    before = tpb.LAUNCHES
    empty = tpb.max_pool2d_backward(torch.empty(0, 3, 8, 8, **meta),
                                    torch.empty(0, 3, 4, 4, **meta),
                                    torch.empty(0, 3, 4, 4, **meta), (2, 2), (2, 2), (0, 0))
    assert empty.shape == (0, 3, 8, 8) and tpb.LAUNCHES == before
    tpb.max_pool2d_backward(torch.zeros(1, 1, 2, 2), torch.zeros(1, 1, 1, 1),
                            torch.zeros(1, 1, 1, 1), (2, 2), (2, 2), (0, 0))
    assert tpb.LAUNCHES == before  # the plain version counts nothing


def test_bad_geometry_raises():
    x, y = torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 3, 3)
    with pytest.raises(ValueError, match="output extent"):
        tpb.max_pool2d_backward(x, y, y, (2, 2), (2, 2), (0, 0))
    with pytest.raises(ValueError, match="two entries"):
        tpb.max_pool2d_backward(x, y, y, (2,), (2, 2), (0, 0))
    with pytest.raises(ValueError, match=r"\[N, C, OH, OW\]"):
        tpb.max_pool2d_backward(x, y, torch.zeros(1, 1, 4, 4), (2, 2), (2, 2), (0, 0))


# -- ResNet-18, one training step ------------------------------------------------

B, HW, CLASSES = 2, 64, 10


def _loss_fn(model, x, y):
    return F.cross_entropy(model(x), y)


def _jax_loss_fn(model, x, y):
    return jF.cross_entropy(model(x), y).mean()


def _momentum(params):
    return dict(learning_rate=0.01, momentum=0.9, weight_decay=1e-4, parameters=params)


def test_resnet18_step_with_the_flag_on_equals_flag_off_and_the_jax_step(tmp_path, monkeypatch):
    """One Momentum step of ResNet-18 at 2 x 64 x 64. The stem's pool sees a
    relu output, so its windows tie at 0 all the time; both tie rules are
    the first maximum, so no gradient moves to another element. torch's CPU
    backward adds an element's up to four taps in another order than the
    port's, so the pool's gradient differs in the last bits: the first
    step's loss (before any update) is equal to the last bit, the second
    step's within 2e-5 (f32 rounding through 18 layers, the loss limit of
    ``test_torch_resnet.py``; 2.4e-6 read), the parameters within 1e-5 of
    their tensor's largest entry. Against the JAX package's steps (its flag
    off) the losses agree to 5e-5, the limit of that file's steps."""
    paddle.seed(0)
    jm = jax_resnet.resnet18(num_classes=CLASSES)
    path = str(tmp_path / "resnet18.pdparams")
    paddle.save(jm.state_dict(), path)
    rng = np.random.RandomState(3)
    batch = [rng.randn(B, 3, HW, HW).astype("f4"), rng.randint(0, CLASSES, (B,)).astype("int64")]
    jstep = jax_jit.train_step(jm, jax_opt.Momentum(**_momentum(jm.parameters())), _jax_loss_fn)
    want = [float(np.asarray(jstep(*batch)["loss"])) for _ in range(2)]

    calls = []
    real = tpb.max_pool2d_backward
    monkeypatch.setattr(tpb, "max_pool2d_backward",
                        lambda *a, **k: calls.append(tuple(a[0].shape)) or real(*a, **k))
    runs = {}
    for on in (False, True):
        monkeypatch.setattr(flags._REGISTRY["use_pallas_pool_bwd"], "value", on)
        tm = convert.load_resnet(path, port_resnet.resnet18, num_classes=CLASSES)
        step = train_step(tm, port_opt.Momentum(**_momentum(tm.parameters())), _loss_fn,
                          device="cpu")
        losses = [float(step(*batch)["loss"]) for _ in range(2)]
        runs[on] = (losses, {n: p.detach().clone() for n, p in tm.named_parameters()})
    assert calls == [(B, 64, HW // 2, HW // 2)] * 2  # the stem's pool, once a step, flag on only
    assert runs[True][0][0] == runs[False][0][0]
    np.testing.assert_allclose(runs[True][0][1], runs[False][0][1], rtol=2e-5)
    for name, p in runs[True][1].items():
        q = runs[False][1][name]
        assert (p - q).abs().max() <= 1e-5 * q.abs().max(), name
    np.testing.assert_allclose(runs[True][0], want, rtol=5e-5, atol=5e-5)
