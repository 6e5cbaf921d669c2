"""Port parity: ResNet and Momentum (``paddle_tpu_torch`` ResNet slice).

A bottleneck ResNet of depth [1, 1, 1, 1] and ``resnet18``, 10 classes, at
batch 2 x 64 x 64, built once per module in the JAX package; their weights
cross through ``paddle_tpu.save`` and ``convert.load_resnet``, Momentum's
state through ``convert.momentum_state_from_numpy``, inputs are the same
numpy arrays. In the JAX package off the TPU the fused conv + bn + relu
runs as its unfused op sequence, which is the reference here; the port's
CPU path runs the fused op on its plain versions. Momentum, not Adam,
carries the multi-step comparisons: it does not turn rounding-level
gradient differences into lr-sized steps.

Why 64 x 64 and not 32 x 32: at 32 x 32 and batch 2, layer4 runs at 1 x 1,
so its batch norms normalize over 2 values a channel, and a channel whose
two values nearly agree amplifies f32 rounding by up to 1/sqrt(eps). There
both packages' train-mode logits sit 2-3e-3 (relative) from a float64
forward of the same weights; at 64 x 64 (4 values a channel) both sit
within 4e-6 of it.

ReLU gates: a pre-activation within f32 rounding of 0 can land on
opposite sides of the gate in the two packages, and then a whole
downstream gradient moves (by ~1e-2 of its layer's largest entry, in every
layer before the flip). At this size that happens for about half the
batches drawn; the batches below (seeds 5 for the gradients, 3 for the
steps) have none, as the scan over seeds 1-6 found.
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
from paddle_tpu.framework import autograd as jax_autograd  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.framework.tensor import Parameter as JaxParameter  # noqa: E402
from paddle_tpu.framework.tensor import Tensor as JaxTensor  # noqa: E402
from paddle_tpu.models import resnet as jax_resnet  # noqa: E402
from paddle_tpu.ops.pallas import optimizer_update as _  # noqa: E402,F401

from paddle_tpu_torch import convert, flags  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402
from paddle_tpu_torch.models import resnet as port_resnet  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops.cuda import conv_bn_relu as tcbr  # noqa: E402
from paddle_tpu_torch.ops.cuda import optimizer_update as tou  # noqa: E402

ou = sys.modules["paddle_tpu.ops.pallas.optimizer_update"]
torch.set_num_threads(1)

B, HW, CLASSES = 2, 64, 10
# f32 forward through up to 18 layers, sums in other orders; relative to
# the largest entry of the compared tensor
FWD_RTOL = 1e-4
GRAD_ATOL_OF_MAX = 1e-4  # of the largest gradient entry of the parameter's layer
ARCHS = {
    "bottleneck_1111": (lambda **kw: jax_resnet.ResNet(jax_resnet.BottleneckBlock, [1, 1, 1, 1],
                                                       **kw),
                        lambda **kw: port_resnet.ResNet(port_resnet.BottleneckBlock,
                                                        [1, 1, 1, 1], **kw)),
    "resnet18": (jax_resnet.resnet18, port_resnet.resnet18),
}
# fused conv + bn + relu triples: the stem, conv1/bn1 of every block and
# conv2/bn2 of every bottleneck
TRIPLES = {"bottleneck_1111": 1 + 2 * 4, "resnet18": 1 + 8}


@pytest.fixture(scope="module", params=list(ARCHS))
def saved(request, tmp_path_factory):
    """(arch, JAX model, path of its saved state): built once per module;
    tests that change the JAX model reset it from the file first."""
    paddle.seed(0)
    jm = ARCHS[request.param][0](num_classes=CLASSES)
    path = str(tmp_path_factory.mktemp(request.param) / "resnet.pdparams")
    paddle.save(jm.state_dict(), path)
    return request.param, jm, path


def _reset(jm, path):
    jm.set_state_dict(paddle.load(path))
    return jm


def _port(arch, path):
    return convert.load_resnet(path, ARCHS[arch][1], num_classes=CLASSES)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, 3, HW, HW).astype("f4"), rng.randint(0, CLASSES, (B,)).astype("int64")]


def _close(got, want, rtol=FWD_RTOL, what=""):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def test_state_dict_matches_jax_names_shapes_and_order(saved):
    arch, jm, path = saved
    tm = _port(arch, path)
    want = {n: tuple(np.shape(v)) for n, v in jm.state_dict().items()}
    assert {n: tuple(v.shape) for n, v in tm.state_dict().items()} == want
    # parameter order decides the optimizer's accumulator indices
    assert [n for n, _ in tm.named_parameters()] == [n for n, _ in jm.named_parameters()]


def test_resnet50_has_the_jax_state_dict():
    """ResNet-50's 267 entries: 161 parameters and 106 running buffers."""
    names = set(jax_resnet.resnet50().state_dict())
    tm = port_resnet.resnet50()
    assert set(tm.state_dict()) == names and len(names) == 267
    assert len(list(tm.parameters())) == 161
    assert "layer1.0.downsample.1._mean" in names


def test_convert_rejects_missing_extra_and_misshapen(saved):
    arch, jm, path = saved
    tm = ARCHS[arch][1](num_classes=CLASSES)
    state = {n: np.asarray(v) for n, v in jm.state_dict().items()}
    with pytest.raises(KeyError, match="bn1._variance"):
        convert.resnet_state_from_numpy({k: v for k, v in state.items() if k != "bn1._variance"},
                                        tm)
    with pytest.raises(KeyError, match="extra"):
        convert.resnet_state_from_numpy(dict(state, extra=np.zeros(1, "f4")), tm)
    with pytest.raises(ValueError, match="conv1.weight"):
        convert.resnet_state_from_numpy(dict(state, **{"conv1.weight": np.zeros((64, 3, 3, 3),
                                                                                "f4")}), tm)


def test_train_and_eval_forwards_and_running_stats_match_jax(saved):
    """A train-mode forward (batch statistics; every running buffer
    blended), then an eval forward on those buffers."""
    arch, jm, path = saved
    jm = _reset(jm, path)
    tm = _port(arch, path)
    x, _ = _batch()
    jm.train()
    tm.train()
    _close(tm(torch.from_numpy(x)).detach().numpy(), jm(paddle.to_tensor(x)).numpy(),
           what="train logits")
    jbufs = dict(jm.named_buffers())
    for name, b in tm.named_buffers():
        _close(b.numpy(), jbufs[name].numpy(), rtol=1e-5, what=name)
    jm.eval()
    tm.eval()
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, jm(paddle.to_tensor(x)).numpy(), what="eval logits")


def _jax_loss_and_grads(jm, batch):
    """Loss and gradient by parameter name of the JAX model in train mode."""
    params = OrderedDict((n, p._array) for n, p in jm.named_parameters())
    buffers = OrderedDict((n, b._array) for n, b in jm.named_buffers())

    def loss_of(params):
        state = {"params": params, "frozen": OrderedDict(), "buffers": buffers}
        with jax_jit._swapped_model(jm, state), jax_autograd.no_grad():
            x, y = (JaxTensor._from_array(jnp.asarray(a)) for a in batch)
            loss = jF.cross_entropy(jm(x), y).mean()
        return loss._array

    jm.train()
    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    return float(loss), {n: np.asarray(g) for n, g in grads.items()}


def _loss_fn(m, x, y):
    return F.cross_entropy(m(x), y)


def _jax_loss_fn(m, x, y):
    return jF.cross_entropy(m(x), y).mean()


def test_loss_and_every_gradient_match_jax(saved):
    arch, jm, path = saved
    batch = _batch(5)
    want_loss, want_grads = _jax_loss_and_grads(_reset(jm, path), batch)
    tm = _port(arch, path).train()
    loss = _loss_fn(tm, *map(torch.from_numpy, batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=2e-5, atol=2e-5)
    scale = {}
    for name, g in want_grads.items():
        layer = name.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(np.abs(g).max()))
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        err = np.abs(p.grad.numpy() - want_grads[name]).max()
        assert err <= GRAD_ATOL_OF_MAX * scale[name.rpartition(".")[0]], (name, err)


def _momentum(params, **kw):
    return dict(learning_rate=0.01, momentum=0.9, weight_decay=1e-4, parameters=params, **kw)


def test_three_momentum_steps_match_jax_train_step(saved):
    """Three steps through both packages' ``train_step``: the losses agree to
    f32 rounding. The parameters after them are not compared: a gate flip
    in step 2 or 3 moves single weights by up to ~2e-3 of their layer's
    largest entry while the losses still agree to 1e-6 (the gradients of
    one step are compared in full above)."""
    arch, jm, path = saved
    jm = _reset(jm, path)
    batch = _batch(3)
    jstep = jax_jit.train_step(jm, jax_opt.Momentum(**_momentum(jm.parameters())), _jax_loss_fn)
    want = [float(np.asarray(jstep(*batch)["loss"])) for _ in range(3)]
    tm = _port(arch, path)
    tstep = train_step(tm, port_opt.Momentum(**_momentum(tm.parameters())), _loss_fn,
                       device="cpu")
    got = [float(tstep(*batch)["loss"]) for _ in range(3)]
    assert got[2] < got[0]
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_jax_momentum_state_continues_the_same_trajectory(saved, tmp_path):
    """Two JAX steps, then its weights and velocities carried into the
    port: the port's next steps give the JAX package's next losses."""
    arch, jm, path = saved
    jm = _reset(jm, path)
    batch = _batch(3)
    jo = jax_opt.Momentum(**_momentum(jm.parameters()))
    jstep = jax_jit.train_step(jm, jo, _jax_loss_fn)
    for _ in range(2):
        jstep(*batch)
    jstep.sync()
    after = str(tmp_path / "after_two.pdparams")
    paddle.save(jm.state_dict(), after)
    opt_state = jo.state_dict()
    want = [float(np.asarray(jstep(*batch)["loss"])) for _ in range(2)]

    tm = _port(arch, after)
    to = port_opt.Momentum(**_momentum(tm.parameters()))
    to.set_state_dict(convert.momentum_state_from_numpy(opt_state, to))
    assert to._global_step == 2
    assert len(to._accumulators["velocity"]) == len(list(tm.parameters()))
    tstep = train_step(tm, to, _loss_fn, device="cpu")
    got = [float(tstep(*batch)["loss"]) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_momentum_state_shape_mismatch_raises(saved):
    arch, _, path = saved
    tm = _port(arch, path)
    to = port_opt.Momentum(parameters=tm.parameters())
    params = list(tm.parameters())
    state = {"global_step": 1}
    state.update({f"velocity_{i}": np.zeros(tuple(p.shape), "f4") for i, p in enumerate(params)})
    state["velocity_0"] = np.zeros((3,), "f4")
    with pytest.raises(ValueError, match="velocity_0"):
        convert.momentum_state_from_numpy(state, to)
    state["velocity_0"] = np.zeros(tuple(params[0].shape), "f4")
    del state[f"velocity_{len(params) - 1}"]
    with pytest.raises(KeyError, match="velocity"):
        convert.momentum_state_from_numpy(state, to)


# -- the momentum update ---------------------------------------------------------


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_plain_momentum_update_matches_interpret_kernel(nesterov, wd):
    """The port's plain update against the JAX kernel in interpret mode
    (1000 x 130 needs the TPU kernel's lane padding), and against the JAX
    package's own fallback ``_jnp_update``. Found: the fallback is equal
    bit for bit; the interpreted kernel is not, because XLA:CPU contracts
    its compiled expression into FMAs (about 1 element in 5 differs), and
    stays within 2 ulps of the largest magnitude among each element's
    inputs and results. In place on
    the CPU, the entry writes the plain result over its inputs."""
    rng = np.random.RandomState(0)
    p, g, v = (rng.randn(1000, 130).astype("f4") for _ in range(3))
    want_p, want_v = ou._pallas_update(*map(jnp.asarray, (p, g, v)), 0.1, 0.9, wd, nesterov,
                                       interpret=True)
    tp, tg, tv = (torch.from_numpy(a.copy()) for a in (p, g, v))
    plain_p, plain_v = tou._plain_update(tp, tg, tv, 0.1, 0.9, wd, nesterov)
    # ulps of the largest magnitude among each element's inputs and results
    scale = np.maximum.reduce([np.abs(a) for a in (p, g, v, np.asarray(want_p),
                                                   np.asarray(want_v))])
    for got, want in ((plain_p, want_p), (plain_v, want_v)):
        assert (np.abs(got.numpy() - np.asarray(want)) / np.spacing(scale)).max() <= 2.0
    jp, jv = ou._jnp_update(*map(jnp.asarray, (p, g, v)), 0.1, 0.9, wd, nesterov)
    assert np.array_equal(plain_p.numpy(), np.asarray(jp))
    before = tou.LAUNCHES
    out_p, out_v = tou.fused_momentum_update(tp, tg, tv, 0.1, 0.9, wd, nesterov)
    assert out_p is tp and out_v is tv and tou.LAUNCHES == before
    assert torch.equal(tp, plain_p) and torch.equal(tv, plain_v)


def _twin_params(seed=0, shapes=((5, 7), (7,), (3, 4, 2), (1,))):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*s).astype("f4") for s in shapes]
    grads = [[rng.randn(*s).astype("f4") * 10.0 ** -k for s in shapes] for k in range(3)]
    jp = [JaxParameter.from_array(a, name=f"param_{i}") for i, a in enumerate(arrays)]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays]
    return jp, tp, grads


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.02}, {"use_nesterov": True},
                                {"weight_decay": 0.02, "use_nesterov": True}],
                         ids=["plain", "wd", "nesterov", "wd_nesterov"])
def test_momentum_matches_jax_on_identical_gradients(kw, fused, monkeypatch):
    """The same gradients into both packages' Momentum give the same
    parameters bit for bit, step after step, with the fused update and
    without it (the JAX package's flag on, its CPU fallback)."""
    monkeypatch.setattr(flags._REGISTRY["use_fused_optimizer"], "value", fused)
    jp, tp, grads = _twin_params()
    jo = jax_opt.Momentum(learning_rate=0.05, momentum=0.9, parameters=jp, **kw)
    to = port_opt.Momentum(learning_rate=0.05, momentum=0.9, parameters=tp, **kw)
    for step_grads in grads:
        for p, g in zip(jp, step_grads):
            p.grad = JaxTensor._from_array(jnp.asarray(g))
        for p, g in zip(tp, step_grads):
            p.grad = torch.from_numpy(g.copy())
        jo.step()
        to.step()
        for a, b in zip(jp, tp):
            assert np.array_equal(b.detach().numpy(), np.asarray(a._array))
    state = to.state_dict()
    assert state["global_step"] == 3 and set(state) == {"global_step"} | {
        f"velocity_{i}" for i in range(4)}


def test_momentum_folds_decay_only_into_the_fused_update(monkeypatch):
    to = port_opt.Momentum(parameters=[torch.nn.Parameter(torch.zeros(3))], weight_decay=0.1)
    assert to._fused_decay_coeff() == 0.1
    monkeypatch.setattr(flags._REGISTRY["use_fused_optimizer"], "value", False)
    assert to._fused_decay_coeff() is None
    assert port_opt.Adam(parameters=[torch.nn.Parameter(torch.zeros(3))],
                         weight_decay=0.1)._fused_decay_coeff() is None


def test_momentum_entry_on_another_device_raises():
    t = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tou.fused_momentum_update(t, t, t, 0.1)
    with pytest.raises(ValueError, match="differ"):
        tou.fused_momentum_update(torch.zeros(4), torch.zeros(3), torch.zeros(4), 0.1)


# -- the kernel routes -------------------------------------------------------------


def _counting(calls, monkeypatch):
    """Every new kernel entry replaced by a counter around itself (on the
    CPU the entries run their plain versions), as the card would see them."""
    for name in ("mm_affine_relu", "mm_stats", "centered_sumsq", "bn_relu", "bn_bwd_partials",
                 "bn_bwd_dco"):
        fn = getattr(tcbr, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(tcbr, name, counted)
    fn = tou.fused_momentum_update_multi

    def momentum(params, *a, **k):
        params = list(params)
        calls["momentum_update"] = calls.get("momentum_update", 0) + 1
        calls["momentum_tensors"] = calls.get("momentum_tensors", []) + [params]
        return fn(params, *a, **k)
    monkeypatch.setattr(tou, "fused_momentum_update_multi", momentum)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_training_and_eval_launch_every_new_kernel_entry(arch, monkeypatch):
    """A Momentum training step runs each training entry once per fused
    triple and the multi-tensor update once, over every parameter in
    order; an eval forward runs the eval entry once per triple and nothing
    else."""
    calls = {}
    _counting(calls, monkeypatch)
    tm = ARCHS[arch][1](num_classes=CLASSES, generator=torch.Generator().manual_seed(0))
    step = train_step(tm, port_opt.Momentum(**_momentum(tm.parameters())), _loss_fn,
                      device="cpu")
    loss = float(step(*_batch())["loss"])
    n = TRIPLES[arch]
    assert np.isfinite(loss)
    (updated,) = calls.pop("momentum_tensors")
    assert [id(p) for p in updated] == [id(p) for p in tm.parameters()]
    assert calls == {"mm_stats": n, "centered_sumsq": n, "bn_relu": n, "bn_bwd_partials": n,
                     "bn_bwd_dco": n, "momentum_update": 1}
    assert all(p.grad is not None for p in tm.parameters())
    calls.clear()
    tm.eval()
    with torch.inference_mode():
        tm(torch.from_numpy(_batch()[0]))
    assert calls == {"mm_affine_relu": n}


def test_fused_flag_off_runs_the_same_resnet_op_by_op(monkeypatch):
    """``FLAGS_use_fused_conv_bn`` off: conv2d, batch_norm and relu op by
    op give the fused path's logits and running statistics to f32
    rounding."""
    tm = port_resnet.resnet18(num_classes=CLASSES, generator=torch.Generator().manual_seed(1))
    ref = port_resnet.resnet18(num_classes=CLASSES)
    ref.load_state_dict(tm.state_dict())
    x = torch.from_numpy(_batch()[0])
    out = tm.train()(x).detach().numpy()
    monkeypatch.setattr(flags._REGISTRY["use_fused_conv_bn"], "value", False)
    _close(ref.train()(x).detach().numpy(), out, rtol=1e-5, what="logits")
    for (name, a), (_, b) in zip(tm.named_buffers(), ref.named_buffers()):
        _close(b.numpy(), a.numpy(), rtol=1e-5, what=name)


def test_resnet_served_over_http_matches_its_forward(saved):
    """Float32 image inputs through ``Predictor`` -> ``InferenceServer``:
    padded to a bucket, concurrent requests batched together, every answer
    equal to the eval forward of the same images within f32 rounding
    (batch norm in eval mode makes a row's answer independent of the other
    rows, so the bucket's padding never shows)."""
    import json
    import threading
    import urllib.request

    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.jit_api import InputSpec
    from paddle_tpu_torch.serving import InferenceServer

    arch, _, path = saved
    tm = _port(arch, path)
    pred = Predictor(tm, [InputSpec([None, 3, HW, HW], "float32", "image")], ["logits"],
                     device="cpu")
    rng = np.random.RandomState(7)
    images = [np.round(rng.randn(rows, 3, HW, HW), 3) for rows in (1, 3, 2)]
    srv = InferenceServer(pred, port=0, buckets=(1, 2, 4), batch_timeout_ms=20.0).start()
    answers = [None] * len(images)

    def post(i):
        body = json.dumps({"inputs": {"image": images[i].tolist()}}).encode()
        req = urllib.request.Request(srv.url + "/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answers[i] = (r.status, json.loads(r.read()))

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        srv.stop(drain=True)
    assert not srv.pool.alive
    with torch.inference_mode():
        for img, ans in zip(images, answers):
            assert ans is not None and ans[0] == 200
            got = np.asarray(ans[1]["outputs"]["logits"], np.float32)
            want = tm(torch.from_numpy(img.astype(np.float32))).numpy()
            assert got.shape == (len(img), CLASSES)
            _close(got, want, rtol=1e-5, what="served logits")
