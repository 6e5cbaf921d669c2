"""Port parity: static-graph training of the MNIST LeNet (``BASELINE.json``'s first config).

The LeNet-5 program (conv 6 @ 3x3 + pool, conv 16 @ 5x5 + pool through
``nets.simple_img_conv_pool``, fc 120, 84, 10, ``softmax_with_cross_entropy``,
``mean``, ``accuracy``) is built in both packages by one function; the JAX
package's startup draws the weights and ``convert.scope_from_numpy``
carries its scope into the port's, so both executors start from the same
values. On 1 x 28 x 28 synthetic MNIST (``vision.datasets.MNIST``, the same
bytes in both) at batch 8:

- ``append_backward`` and each optimizer's ``minimize`` append the same
  program (``Program.to_dict()`` equal: op types, names, attributes);
- ``gradients()`` of every parameter equal the JAX executor's within 1e-5
  of the largest entry of the parameter's layer, the max-pool kernel's
  route on and off;
- 5 steps of SGD, Momentum and Adam (and SGD with the global-norm clip):
  fetched losses within atol 1e-5 and the parameters, velocities and
  moments after them within 1e-5 of each layer's largest entry (Adam's
  parameters within 1% of its lr, see the test);
- the static LeNet equals the dygraph ``models.LeNet`` with the same
  weights (loss and gradients), and the dygraph LeNet the JAX one;
- max-pool ties go to the first maximum in row-major order, through the
  executor's ``grad::pool2d``, as ``jax.vjp`` of the JAX ``pool2d`` routes
  them; with ``FLAGS_use_pallas_pool_bwd`` on, ``grad::pool2d`` takes the
  kernel's route (shown on ``meta`` tensors, where the kernel raises);
- ``set_lr`` and ``sync_lr`` write the lr in place: the scope's
  generation and tensor stay, a graph would read the new value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu.static as jstatic  # noqa: E402
from paddle_tpu import flags as jflags  # noqa: E402
from paddle_tpu import nets as jnets  # noqa: E402
from paddle_tpu import ops as jops  # noqa: E402
from paddle_tpu.framework.tensor import Tensor as JaxTensor  # noqa: E402
from paddle_tpu.models.lenet import LeNet as JaxLeNet  # noqa: E402
from paddle_tpu.ops import kernels as jkernels  # noqa: E402
from paddle_tpu.ops.registry import kernel as jkernel  # noqa: E402
from paddle_tpu.optimizer import ClipGradByGlobalNorm as JaxClipGlobal  # noqa: E402
from paddle_tpu.vision.datasets import MNIST as JaxMNIST  # noqa: E402

from paddle_tpu_torch import convert, nets, ops, static  # noqa: E402
from paddle_tpu_torch import flags  # noqa: E402
from paddle_tpu_torch.models import LeNet  # noqa: E402
from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm  # noqa: E402
from paddle_tpu_torch.ops.registry import kernel  # noqa: E402
from paddle_tpu_torch.static.executor import run_grad_op  # noqa: E402
from paddle_tpu_torch.vision.datasets import MNIST  # noqa: E402

torch.set_num_threads(1)

BATCH, STEPS = 8, 5
LOSS_ATOL = 1e-5
LAYER_RTOL = 1e-5  # of the largest entry of the parameter's layer
ADAM_LR = 2e-3
# parameter names of the program: conv1 w/b, conv2 w/b, fc1 w/b, fc2 w/b, fc3 w/b
LAYERS = [("param_0", "param_1"), ("param_2", "param_3"), ("param_4", "param_5"),
          ("param_6", "param_7"), ("param_8", "param_9")]
DYGRAPH = ["features.0", "features.3", "fc.1", "fc.3", "fc.5"]


def lenet(st, op_mod, nets_mod):
    """The MNIST book model as a static program, in either package."""
    img = st.data("img", [None, 1, 28, 28], "float32")
    label = st.data("label", [None, 1], "int64")
    h = nets_mod.simple_img_conv_pool(img, 6, 3, 2, 2, conv_padding=1, act="relu")
    h = nets_mod.simple_img_conv_pool(h, 16, 5, 2, 2, act="relu")
    h = st.nn.fc(h, 120, activation="relu")
    h = st.nn.fc(h, 84, activation="relu")
    logits = st.nn.fc(h, 10)
    loss = op_mod.mean(op_mod.softmax_with_cross_entropy(logits, label))
    acc = op_mod.accuracy(op_mod.softmax(logits), label)
    return logits, loss, acc


def _batches(n=STEPS, batch=BATCH):
    data = MNIST(mode="train")
    return [{"img": data.images[i * batch:(i + 1) * batch],
             "label": data.labels[i * batch:(i + 1) * batch].reshape(-1, 1)} for i in range(n)]


@pytest.fixture
def both_static():
    for st in (jstatic, static):
        st.enable_static()
        st.reset_default_programs()
        st.global_scope().clear()
    yield
    for st in (jstatic, static):
        st.disable_static()
        st.reset_default_programs()
        st.global_scope().clear()


@pytest.fixture(params=[False, True], ids=["pool_plain", "pool_kernel_route"])
def pool_flag(request, monkeypatch):
    monkeypatch.setattr(flags._REGISTRY["use_pallas_pool_bwd"], "value", request.param)
    jflags.set_flags({"use_pallas_pool_bwd": request.param})
    yield request.param
    jflags.set_flags({"use_pallas_pool_bwd": False})


def _build(train=None):
    """(JAX fetches, port fetches, JAX executor, port executor): the LeNet
    program in both packages, ``train(st, loss)`` appending its training ops
    (returns extra fetches), the port's scope a copy of the JAX startup's."""
    out = []
    for st, op_mod, nets_mod in ((jstatic, jops, jnets), (static, ops, nets)):
        logits, loss, acc = lenet(st, op_mod, nets_mod)
        extra = train(st, loss) if train else []
        out.append([logits, loss, acc] + list(extra))
    jexe = jstatic.Executor()
    jexe.run_startup()
    jscope = jstatic.global_scope()
    convert.scope_from_numpy({n: np.asarray(jscope.get(n)) for n in jscope.var_names()},
                             scope=static.global_scope(), device="cpu")
    return out[0], out[1], jexe, static.Executor("cpu")


def _layer_scale(values, name):
    """The largest entry of ``name``'s layer among ``values`` (``param_3``
    and ``param_3@moment1`` are scaled by their layer's ``param_2`` and
    ``param_3``, or ``@moment1``s)."""
    base, at, suffix = name.partition("@")
    for layer in LAYERS:
        if base in layer:
            return max(float(np.abs(values[n + at + suffix]).max()) for n in layer)
    raise KeyError(name)


def _assert_close_by_layer(got, want, rtol=LAYER_RTOL, what=""):
    """Each entry of ``got`` within ``rtol`` of the largest entry of its
    layer's tensors in ``want`` (names like ``param_3`` or ``param_3@moment1``)."""
    for name in want:
        scale = _layer_scale(want, name)
        err = float(np.abs(np.asarray(got[name]) - np.asarray(want[name])).max())
        assert err <= rtol * max(scale, 1e-30), (what, name, err, scale)


# -- the program ----------------------------------------------------------------------


def test_lenet_program_matches_jax(both_static):
    _build()
    assert static.default_main_program().to_dict() == jstatic.default_main_program().to_dict()


def test_append_backward_matches_jax(both_static):
    pairs = []
    for st, op_mod, nets_mod in ((jstatic, jops, jnets), (static, ops, nets)):
        _, loss, _ = lenet(st, op_mod, nets_mod)
        pairs.append([(p.name, g.name) for p, g in st.append_backward(loss)])
    jprog, pprog = jstatic.default_main_program(), static.default_main_program()
    jops_list = [(o.type, o.inputs, o.outputs) for o in jprog.global_block().ops]
    assert [(o.type, o.inputs, o.outputs) for o in pprog.global_block().ops] == jops_list
    assert pairs[0] == pairs[1] == [(f"param_{i}", f"param_{i}@GRAD") for i in range(10)]
    grad_types = [t for t, _, _ in jops_list if t.startswith("grad::")]
    assert grad_types.count("grad::pool2d") == 2 and jops_list[len(jops_list) -
                                                               len(grad_types) - 1][0] \
        == "fill_any_like"
    assert pprog.to_dict() == jprog.to_dict()


def test_backward_refuses_a_loss_without_parameters(both_static):
    x = static.data("x", [None, 3], "float32")
    with pytest.raises(RuntimeError, match="does not depend on any trainable"):
        static.append_backward(ops.mean(ops.square(x)))


def test_backward_refuses_a_loss_through_while(both_static):
    """The taint check raises as the JAX one does, though the port has no
    ``while`` to run."""
    x = static.data("x", [None, 3], "float32")
    y = static.nn.fc(x, 3)
    block = static.default_main_program().global_block()
    out = block.create_var(name="w_out", shape=[-1, 3], dtype="float32", stop_gradient=False)
    block.append_op("while", {"X": [y.name]}, {"Out": [out.name]}, {})
    with pytest.raises(RuntimeError, match="while op"):
        static.append_backward(ops.mean(out))


def test_gradients_match_jax(both_static, pool_flag):
    def grads_of(st, loss):
        params = [v for v in st.default_main_program().global_block().vars.values()
                  if v.is_parameter]
        return st.gradients(loss, params)

    jf, pf, jexe, pexe = _build(grads_of)
    feed = _batches(1)[0]
    want = jexe.run(feed=feed, fetch_list=jf[1:2] + jf[3:])
    got = pexe.run(feed=feed, fetch_list=pf[1:2] + pf[3:])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=LOSS_ATOL)
    names = [f"param_{i}" for i in range(10)]
    assert [g.name for g in pf[3:]] == [f"{n}@GRAD" for n in names]
    _assert_close_by_layer(dict(zip(names, got[1:])), dict(zip(names, want[1:])),
                           what="gradients")
    assert all(np.abs(g).max() > 0 for g in got[1:])


def _minimize(kind, clip=False):
    def train(st, loss):
        kw = {"grad_clip": (JaxClipGlobal if st is jstatic else ClipGradByGlobalNorm)(0.5)} \
            if clip else {}
        if kind == "SGD":
            opt = st.optimizer.SGD(learning_rate=0.1, **kw)
        elif kind == "Momentum":
            opt = st.optimizer.Momentum(learning_rate=0.05, momentum=0.9, **kw)
        else:
            opt = st.optimizer.Adam(learning_rate=ADAM_LR, **kw)
        opt.minimize(loss)
        return []
    return train


@pytest.mark.parametrize("kind,clip", [("SGD", False), ("Momentum", False), ("Adam", False),
                                       ("SGD", True)],
                         ids=["sgd", "momentum", "adam", "sgd_global_clip"])
def test_training_steps_match_jax(both_static, kind, clip):
    jf, pf, jexe, pexe = _build(_minimize(kind, clip))
    if not clip:  # the clip's constants carry each package's own counter
        assert static.default_main_program().to_dict() == jstatic.default_main_program().to_dict()
    jlosses, plosses = [], []
    for feed in _batches():
        jlosses.append(float(jexe.run(feed=feed, fetch_list=[jf[1]])[0]))
        plosses.append(float(pexe.run(feed=feed, fetch_list=[pf[1]])[0]))
    np.testing.assert_allclose(plosses, jlosses, rtol=0, atol=LOSS_ATOL)
    assert plosses[-1] < plosses[0]
    jscope, pscope = jstatic.global_scope(), static.global_scope()
    state = [n for n in jscope.var_names() if n.startswith("param_")]
    assert len(state) == {"SGD": 10, "Momentum": 20, "Adam": 30}[kind]
    got = {n: pscope.numpy(n) for n in state}
    want = {n: np.asarray(jscope.get(n)) for n in state}
    if kind == "Adam":
        # Adam's step is lr * g / (|g| + eps): on a gradient entry near eps
        # a rounding-level difference of g moves it by a share of lr (7e-6
        # = 0.35% of lr read at the first step, the gradients equal to
        # 1e-7 of their layer's largest entry), so the parameters are held
        # to 1% of one step, the moments as the other state
        for n in [n for n in state if "@" not in n]:
            np.testing.assert_allclose(got.pop(n), want.pop(n), rtol=0, atol=0.01 * ADAM_LR)
    _assert_close_by_layer(got, want, what=kind)
    if kind == "Adam":
        assert float(pscope.numpy("adam_step_0")) == float(np.asarray(jscope.get("adam_step_0")))
        assert float(pscope.numpy("adam_step_0")) == STEPS


def test_clip_program_matches_jax(both_static):
    """The global-norm clip appends the same ops as the JAX one (the
    constants' names carry each package's own counter, so types and
    attributes are compared)."""
    _build(_minimize("SGD", clip=True))
    jo = jstatic.default_main_program().global_block().ops
    po = static.default_main_program().global_block().ops
    assert [(o.type, o.attrs) for o in po] == [(o.type, o.attrs) for o in jo]
    types = [o.type for o in po]
    assert types.count("square") == types.count("reduce_sum") == 10
    assert types.count("elementwise_mul") == 10 and "elementwise_min" in types


# -- dygraph against static ---------------------------------------------------------------


def test_static_lenet_matches_dygraph_lenet(both_static):
    """The port's static program and its ``models.LeNet`` with the same
    weights: the same loss and gradients."""
    _, pf, _, pexe = _build(lambda st, loss: st.gradients(
        loss, [st.default_main_program().global_block().var(f"param_{i}") for i in range(10)]))
    feed = _batches(1)[0]
    got = pexe.run(feed=feed, fetch_list=[pf[1]] + pf[3:])
    scope = static.global_scope()
    model = LeNet()
    state = {}
    for (w, b), name in zip(LAYERS, DYGRAPH):
        state[f"{name}.weight"] = scope.get(w).clone()
        state[f"{name}.bias"] = scope.get(b).clone()
    model.load_state_dict(state)
    logits = model(torch.from_numpy(feed["img"]))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(feed["label"][:, 0]))
    loss.backward()
    np.testing.assert_allclose(float(loss), got[0], rtol=0, atol=LOSS_ATOL)
    want = {}
    for (w, b), name in zip(LAYERS, DYGRAPH):
        mod = dict(model.named_modules())[name]
        want[w], want[b] = mod.weight.grad.numpy(), mod.bias.grad.numpy()
    _assert_close_by_layer(dict(zip([f"param_{i}" for i in range(10)], got[1:])), want,
                           what="static vs dygraph")


def test_dygraph_lenet_matches_jax():
    jm = JaxLeNet()
    sd = {k: np.asarray(v._array) for k, v in jm.state_dict().items()}
    tm = LeNet()
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    x = MNIST(mode="test").images[:4]
    want = np.asarray(jm(JaxTensor._from_array(jnp.asarray(x)))._array)
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_mnist_is_the_jax_packages_bytes():
    for mode in ("train", "test"):
        a, b = MNIST(mode=mode), JaxMNIST(mode=mode)
        assert a.synthetic and b.synthetic and len(a) == len(b) == (2048 if mode == "train"
                                                                  else 512)
        assert np.array_equal(a.images, b.images) and np.array_equal(a.labels, b.labels)
        img, label = a[3]
        assert img.shape == (1, 28, 28) and img.dtype == np.float32 and label.dtype == np.int64


# -- the max-pool backward through the executor -----------------------------------------


def _tie_input():
    """[2, 3, 6, 6]: all-equal 2x2 windows (a relu'd zero block, a constant
    block), windows with the maximum twice at other taps, and distinct
    values."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 6, 6).astype("f4")
    x[0, 0] = 0.0
    x[0, 1, :4, :4] = 1.5
    x[1, 2, 0:2, 0:2] = [[0.3, 0.9], [0.9, 0.1]]
    x[1, 2, 2:4, 2:4] = [[0.2, 0.1], [0.7, 0.7]]
    return x


@pytest.mark.parametrize("geometry", [(2, 2, 0), (3, 2, 1), (2, 1, 0)])
def test_pool_ties_follow_the_first_maximum(geometry, pool_flag):
    """``grad::pool2d`` evaluated by the executor (:func:`run_grad_op`) on
    constructed ties, against ``jax.vjp`` of the JAX ``pool2d`` kernel on
    the CPU (``reduce_window``'s VJP: the Pallas route is TPU-only): the same
    elements take the gradient, bit for bit where windows do not overlap."""
    k, s, p = geometry
    x = _tie_input()
    attrs = dict(kernel_size=k, stride=s, padding=p, pooling_type="max", ceil_mode=False,
                 data_format="NCHW")
    y, vjp = jax.vjp(lambda a: jkernels.pool2d(a, **attrs), jnp.asarray(x))
    dy = np.random.RandomState(8).randn(*y.shape).astype("f4")
    (want,) = vjp(jnp.asarray(dy))
    (got,) = run_grad_op("pool2d", attrs, [torch.from_numpy(x)], [torch.from_numpy(dy)], [True])
    want = np.asarray(want)
    if s >= k:
        assert np.array_equal(got.numpy(), want)
    else:  # overlapping windows: an element adds the dy of each window it won, in
        # tap order on the kernel's route, in window order in XLA's
        ulp = np.finfo(np.float32).eps * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=k * k * ulp)
        assert np.array_equal(got.numpy() != 0, want != 0)
    if k == 2 and s == 2:  # an all-equal window gives its whole dy to its first tap
        assert got[0, 0, 0, 0] == dy[0, 0, 0, 0] and not got[0, 0, 0, 1] and \
            not got[0, 0, 1, 0] and not got[0, 0, 1, 1]


def test_grad_pool2d_takes_the_kernel_route_with_the_flag(monkeypatch):
    """On ``meta`` tensors (not the CPU's), ``grad::pool2d`` with the flag
    on reaches the kernel's wrapper, which raises off the card; with the
    flag off torch's own backward runs."""
    attrs = dict(kernel_size=2, stride=2, padding=0, pooling_type="max", ceil_mode=False,
                 data_format="NCHW")
    x = torch.empty(64, 6, 28, 28, device="meta")
    dy = torch.empty(64, 6, 14, 14, device="meta")
    monkeypatch.setattr(flags._REGISTRY["use_pallas_pool_bwd"], "value", True)
    with pytest.raises(ValueError, match="one CUDA device"):
        run_grad_op("pool2d", attrs, [x], [dy], [True])
    monkeypatch.setattr(flags._REGISTRY["use_pallas_pool_bwd"], "value", False)
    (dx,) = run_grad_op("pool2d", attrs, [x], [dy], [True])
    assert dx.shape == x.shape and dx.device.type == "meta"


def test_grad_op_gives_integer_inputs_no_gradient():
    logits = torch.from_numpy(np.random.RandomState(2).randn(4, 10).astype("f4"))
    label = torch.tensor([[1], [9], [0], [3]])
    dl, dlabel = run_grad_op("softmax_with_cross_entropy", {}, [logits, label],
                             [torch.ones(4, 1)], [True, True])
    assert dlabel is None
    want = torch.softmax(logits, -1) - torch.nn.functional.one_hot(label[:, 0], 10)
    np.testing.assert_allclose(dl.numpy(), want.numpy(), atol=1e-6)
    # a missing out-gradient is zeros, and an input no output depends on gets zeros
    (dz,) = run_grad_op("softmax", {}, [logits], [None], [True])
    assert torch.equal(dz, torch.zeros_like(logits))


# -- the ops a training program appends ------------------------------------------------


@pytest.mark.parametrize("op,attrs,shapes", [
    ("pool2d", dict(kernel_size=3, stride=2, padding=1, pooling_type="avg", exclusive=True),
     [(2, 3, 7, 7)]),
    ("pool2d", dict(kernel_size=2, stride=2, padding=0, pooling_type="avg", exclusive=False,
                    ceil_mode=True), [(2, 3, 7, 7)]),
    ("pool2d", dict(kernel_size=3, stride=2, padding=1, pooling_type="max", ceil_mode=True),
     [(2, 3, 7, 7)]),
    ("softmax", dict(axis=-1), [(4, 10)]),
    ("reduce_sum", dict(dim=[0, 2], keep_dim=True), [(3, 4, 5)]),
    ("reduce_mean", dict(dim=None, keep_dim=False), [(3, 4, 5)]),
    ("elementwise_div", {}, [(3, 4), (4,)]),
    ("elementwise_max", {}, [(3, 4), (3, 4)]),
    ("sqrt", {}, [(3, 4)]),
])
def test_op_kernels_match_jax(op, attrs, shapes):
    rng = np.random.RandomState(11)
    arrays = [np.abs(rng.randn(*s)).astype("f4") + 0.1 for s in shapes]

    got = kernel(op)(*[torch.from_numpy(a) for a in arrays], **attrs).numpy()
    want = np.asarray(jkernel(op)(*[jnp.asarray(a) for a in arrays], **attrs))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


def test_top_k_and_accuracy_order_ties_as_lax_top_k():
    x = np.array([[0.5, 0.9, 0.9, 0.1], [0.2, 0.2, 0.2, 0.2], [0.0, 1.0, 0.5, 1.0]], "f4")

    for k in (1, 2, 3):
        tv, ti = kernel("top_k")(torch.from_numpy(x), k=k)
        jv, ji = jkernel("top_k")(jnp.asarray(x), k=k)
        assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.array_equal(tv, np.asarray(jv))
    label = np.array([[2], [0], [3]], "int64")
    _, idx = kernel("top_k")(torch.from_numpy(x), k=1)
    acc = kernel("accuracy")(idx, torch.from_numpy(label))
    assert acc.dtype == torch.float32 and float(acc) == pytest.approx(1 / 3)


def test_adam_update_matches_jax_over_steps():
    """The static ``adam_update`` (float32 step, the CPU's float32 power)
    against the JAX op, 50 steps: the moments bit for bit, the parameters
    within 2 ulps (torch's CPU float32 ``sqrt`` is not correctly rounded:
    1 input in 160 is an ulp off numpy's, which XLA's equals; one parameter
    entry of 40 moves an ulp at step 41)."""

    rng = np.random.RandomState(5)
    p = rng.randn(40).astype("f4")
    m = v = np.zeros(40, "f4")
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    lr = np.float32(1e-2)
    with jax.enable_x64(False):
        for t in range(1, 51):
            g = rng.randn(40).astype("f4")
            step = np.float32(t)
            p, m, v = (np.asarray(a) for a in jkernel("adam_update")(
                jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
                jnp.asarray(lr), jnp.asarray(step)))
            tp, tm, tv = kernel("adam_update")(tp, torch.from_numpy(g), tm, tv,
                                               torch.tensor(lr), torch.tensor(step))
    for a, b in ((tm, m), (tv, v)):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(tp.numpy(), p, rtol=2 * np.finfo(np.float32).eps, atol=0)


# -- the lr in place ------------------------------------------------------------------


def test_set_lr_and_sync_lr_write_in_place(both_static):
    """The lr is filled into the scope's tensor: same tensor, same scope
    generation (so a captured graph reads the new value), and the next
    step uses it."""
    _, loss, _ = lenet(static, ops, nets)
    sched = [0.1]
    opt = static.optimizer.SGD(learning_rate=lambda: sched[0])
    opt.minimize(loss)
    exe = static.Executor("cpu")
    exe.run_startup()
    scope = static.global_scope()
    feed = _batches(1)[0]
    exe.run(feed=feed, fetch_list=[loss])
    lr_t, gen = scope.get("learning_rate_0"), scope._generation
    assert float(lr_t) == pytest.approx(0.1)
    opt.set_lr(0.25)
    assert scope.get("learning_rate_0") is lr_t and float(lr_t) == 0.25
    sched[0] = 0.0375
    opt._lr = lambda: sched[0]
    opt.sync_lr()
    assert scope.get("learning_rate_0") is lr_t and float(lr_t) == np.float32(0.0375)
    assert scope._generation == gen
    # a step at lr 0 moves nothing; parameters stay the scope's tensors
    sched[0] = 0.0
    opt.sync_lr()
    before = {n: scope.get(n) for n in (f"param_{i}" for i in range(10))}
    copies = {n: t.clone() for n, t in before.items()}
    exe.run(feed=feed, fetch_list=[loss])
    for n, t in before.items():
        assert scope.get(n) is t and torch.equal(t, copies[n])
    assert scope._generation == gen
