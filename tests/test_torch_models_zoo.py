"""The rest of the model zoo against the JAX package's (``tests/test_models.py``'s zoo tests).

VGG11 (cfg A, 32 x 32 input, dropout 0), MobileNetV1 and V2 (scale 0.25,
32 x 32), SE-ResNeXt with one block a stage (32 x 32, batch 16) and
Word2Vec: each JAX model's weights cross through ``paddle_tpu.save`` and the
port's ``convert.*_state_from_numpy``; the forward and one loss's every
gradient must match ``jax.value_and_grad`` of the JAX model, the logits
within 1e-5 of the largest and the gradients within 1e-5 of the largest
entry of their layer (as ``tests/test_torch_resnet.py`` holds them).

The MobileNets are held so in eval mode (running statistics). In train mode
at 32 x 32 their last maps are 1 x 1 and 2 x 2, and a batch norm over a few
values a channel amplifies f32 rounding: both packages' train-mode logits
sit 2.7e-5 to 1.1e-4 of the largest from a float64 forward of the same
weights (batch 8), so they cannot agree to 1e-5, and relu6 gates flip. There
the test holds each package's logits to the float64 forward instead.

Repair (ROADMAP.md Queue C): ``relu6`` and ``clip`` took ``torch.clamp``'s
gradient at a bound (1); the JAX package's ``jnp.clip`` gives 0.5 there, as
``jnp.maximum``/``jnp.minimum`` split a tie, and a depthwise conv over a
window of zeros puts exact zeros into MobileNetV2's relu6. With
``FLAGS_use_pallas_pool_bwd`` on, VGG's five max pools reach the kernel
wrapper in the backward, which raises off the card.
"""
import copy
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.models as jmodels  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402
from paddle_tpu.framework import autograd as jax_autograd  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.framework.tensor import Tensor as JaxTensor  # noqa: E402

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch import convert, flags, models  # noqa: E402
from paddle_tpu_torch.framework import place as _place  # noqa: E402
from paddle_tpu_torch.framework.serialization import load  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops.cuda import pool_backward as tpb  # noqa: E402

torch.set_num_threads(1)
OUT_RTOL = 1e-5  # of the largest |logit|
GRAD_RTOL = 1e-5  # of the largest gradient entry of the parameter's layer
F64_RTOL = 2e-4  # a MobileNet's train-mode logits against a float64 forward
CLASSES = 10

# name: (constructor, convert function, input kind, batch, train mode)
CASES = {
    "vgg11": (lambda pkg: pkg.vgg11(num_classes=CLASSES, dropout=0.0),
              convert.vgg_state_from_numpy, "image", 4, True),
    "mobilenet_v1": (lambda pkg: pkg.mobilenet_v1(num_classes=CLASSES, scale=0.25),
                     convert.mobilenet_state_from_numpy, "image", 8, False),
    "mobilenet_v2": (lambda pkg: pkg.mobilenet_v2(num_classes=CLASSES, scale=0.25),
                     convert.mobilenet_state_from_numpy, "image", 8, False),
    "se_resnext": (lambda pkg: pkg.SEResNeXt(layers=(1, 1, 1, 1), num_classes=CLASSES),
                   convert.se_resnext_state_from_numpy, "image", 16, True),
    "word2vec": (lambda pkg: pkg.Word2Vec(vocab_size=50, embed_dim=16),
                 convert.word2vec_state_from_numpy, "ids", 8, True),
}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    prev = _place._expected_place
    paddle.set_device("cpu")
    yield
    _place._expected_place = prev


def _batch(kind, b, seed=3):
    rng = np.random.RandomState(seed)
    if kind == "ids":
        return rng.randint(0, 50, (b, 4)).astype(np.int64), rng.randint(0, 50, b).astype(
            np.int64)
    return (rng.randn(b, 3, 32, 32).astype(np.float32),
            rng.randint(0, CLASSES, b).astype(np.int64))


def _pair(name, tmp_path):
    make, to_port = CASES[name][:2]
    jp.seed(7)
    jm = make(jmodels)
    path = str(tmp_path / f"{name}.pdparams")
    jp.save(jm.state_dict(), path)
    tm = make(models)
    tm.load_state_dict(to_port(load(path, return_numpy=True), tm))
    return jm, tm


def _jax_loss_and_grads(jm, batch, train=True):
    params = OrderedDict((n, p._array) for n, p in jm.named_parameters())
    buffers = OrderedDict((n, b._array) for n, b in jm.named_buffers())

    def loss_of(params):
        state = {"params": params, "frozen": OrderedDict(), "buffers": buffers}
        with jax_jit._swapped_model(jm, state), jax_autograd.no_grad():
            x, y = (JaxTensor._from_array(jnp.asarray(a)) for a in batch)
            out = jm(x)
            loss = jF.cross_entropy(out, y).mean()
        return loss._array, out._array

    jm.train() if train else jm.eval()
    (loss, out), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
    return float(loss), np.asarray(out), {n: np.asarray(g) for n, g in grads.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_gradients_match_jax(name, tmp_path):
    _, _, kind, b, train = CASES[name]
    jm, tm = _pair(name, tmp_path)
    batch = _batch(kind, b)
    want_loss, want_out, want_grads = _jax_loss_and_grads(jm, batch, train)
    tm.train(train)
    x, y = (torch.from_numpy(a) for a in batch)
    out = tm(x)
    loss = F.cross_entropy(out, y).mean()
    loss.backward()
    scale = np.abs(want_out).max()
    assert np.abs(out.detach().numpy() - want_out).max() <= OUT_RTOL * scale
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5, atol=1e-6)
    layer_max = {}
    for n, g in want_grads.items():
        layer = n.rpartition(".")[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0), float(np.abs(g).max()))
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(want_grads)
    for n, p in named.items():
        err = float(np.abs(p.grad.numpy() - want_grads[n]).max())
        assert err <= GRAD_RTOL * max(layer_max[n.rpartition(".")[0]], 1e-30), (n, err)


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_names_are_the_jax_models(name):
    make = CASES[name][0]
    jp.seed(0)
    jstate = make(jmodels).state_dict()
    state = make(models).state_dict()
    assert sorted(state) == sorted(jstate)
    assert all(tuple(state[k].shape) == tuple(jstate[k].shape) for k in state)


@pytest.mark.parametrize("name", ["mobilenet_v1", "mobilenet_v2"])
def test_mobilenet_train_forward_within_f64_envelope(name, tmp_path):
    """Train mode (batch statistics): each package's logits against a
    float64 forward of the port's model on the same weights."""
    jm, tm = _pair(name, tmp_path)
    x, _ = _batch("image", CASES[name][3])
    ref = copy.deepcopy(tm).double().train()
    jm.train()
    tm.train()
    want = ref(torch.from_numpy(x).double()).detach().numpy()
    got = tm(torch.from_numpy(x)).detach().numpy()
    jgot = jm(jp.to_tensor(x)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= F64_RTOL * scale
    assert np.abs(jgot - want).max() <= F64_RTOL * scale


def test_relu6_and_clip_gradients_at_the_bounds_equal_jax():
    """The repair: 0.5 at a bound, as ``jnp.clip``; values unchanged."""
    import paddle_tpu.nn.functional as jF_

    x = np.array([-1.0, 0.0, 2.5, 6.0, 7.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jF_.relu6(JaxTensor._from_array(v))._array.sum())(
        jnp.asarray(x)))
    np.testing.assert_array_equal(want, [0.0, 0.5, 1.0, 0.5, 0.0])
    for fn in (F.relu6, lambda t: paddle.clip(t, 0.0, 6.0)):
        t = torch.from_numpy(x).requires_grad_()
        y = fn(t)
        np.testing.assert_array_equal(y.detach().numpy(), np.clip(x, 0.0, 6.0))
        y.sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), want)


def test_vgg_pool_backward_reaches_the_kernel_wrapper(monkeypatch):
    """VGG's five 2x2 pools take the kernel's route in the backward with the
    flag on: on ``meta`` tensors (the card's stand-in) the wrapper is
    called once a pool, at VGG's shapes, and the real wrapper raises
    rather than giving way to its plain version."""
    monkeypatch.setattr(flags._REGISTRY["use_pallas_pool_bwd"], "value", True)
    net = models.vgg11(num_classes=CLASSES, dropout=0.0).to("meta")
    x = torch.empty(2, 3, 64, 64, device="meta", requires_grad=True)
    with pytest.raises(Exception):
        net(x).sum().backward()
    seen = []
    real = tpb.max_pool2d_backward

    def entry(x, y, dy, *geometry):
        seen.append(tuple(x.shape))
        return torch.empty_like(x)

    monkeypatch.setattr(tpb, "max_pool2d_backward", entry)
    net(x).sum().backward()
    assert seen == [(2, 512, 4, 4), (2, 512, 8, 8), (2, 256, 16, 16), (2, 128, 32, 32),
                    (2, 64, 64, 64)]
    assert real is not entry
