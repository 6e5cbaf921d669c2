"""``nn.Layer``, the layers of ``nn`` and ``nn.functional`` against the JAX
package's (``tests/test_nn_layers.py``'s counterpart).

Every ``nn.functional`` name is one case and every layer class is one
case: the same inputs, made from a numpy seed, through the JAX package's
and the port's, a layer's weights carried from the JAX layer by
``set_state_dict``; results agree within RTOL/ATOL in float32, exactly
for integer and bool results."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
import paddle_tpu_torch.nn as nn  # noqa: E402
import paddle_tpu_torch.nn.functional as F  # noqa: E402
from paddle_tpu_torch.framework import place as _place  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6  # float32 results


@pytest.fixture(autouse=True)
def _on_the_cpu():
    prev = _place._expected_place
    pt.set_device("cpu")
    yield
    _place._expected_place = prev


def f32(*shape, lo=-2.0, hi=2.0, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def i64(*shape, hi=5, seed=0):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(np.int64)


def prob(*shape, seed=0):
    return f32(*shape, lo=0.05, hi=0.95, seed=seed)


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v.numpy())


def assert_same(got, want, what, rtol=RTOL, atol=ATOL):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            assert_same(g, w, what, rtol, atol)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, f"{what}: {g.shape} vs {w.shape}"
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


def _args(pkg, args):
    return [pkg.to_tensor(a) if isinstance(a, np.ndarray) else a for a in args]


X4 = f32(2, 6, 5, 5)
FUNCTIONAL = {
    "accuracy": ([f32(6, 5), i64(6, 1)], {"k": 2}),
    "adaptive_avg_pool2d": ([f32(2, 3, 7, 5)], {"output_size": (3, 2)}),
    "adaptive_max_pool2d": ([f32(2, 3, 6, 4)], {"output_size": 2}),
    "avg_pool2d": ([X4], {"kernel_size": 3, "stride": 2, "padding": 1}),
    "batch_norm": ([X4, f32(6, seed=1), prob(6, seed=2), f32(6, seed=3), f32(6, seed=4)],
                   {"training": False}),
    "binary_cross_entropy": ([prob(4, 3), prob(4, 3, seed=1)], {}),
    "binary_cross_entropy_with_logits": ([f32(4, 3), prob(4, 3, seed=1)], {"reduction": "sum"}),
    "celu": ([f32(3, 4)], {"alpha": 0.7}),
    "conv1d": ([f32(2, 4, 9), f32(6, 2, 3, seed=1), f32(6, seed=2)],
               {"stride": 2, "padding": 1, "groups": 2}),
    "conv2d": ([X4, f32(4, 6, 3, 3, seed=1), f32(4, seed=2)], {"padding": 1, "stride": 2}),
    "conv2d_transpose": ([f32(2, 4, 4, 4), f32(4, 3, 3, 3, seed=1), f32(3, seed=2)],
                         {"stride": 2, "padding": 1, "output_padding": 1}),
    "cosine_similarity": ([f32(4, 5), f32(4, 5, seed=1)], {"axis": 1}),
    "cross_entropy": ([f32(6, 5), i64(6)], {}),
    "dropout": ([f32(3, 4)], {"p": 0.3, "training": False}),
    "elu": ([f32(3, 4)], {"alpha": 0.5}),
    "embedding": ([i64(3, 4, hi=7), f32(7, 5)], {"padding_idx": 2}),
    "gelu": ([f32(3, 4)], {"approximate": True}),
    "group_norm": ([X4], {"num_groups": 3}),
    "hardshrink": ([f32(3, 4)], {"threshold": 0.7}),
    "hardsigmoid": ([f32(3, 4) * 4], {}),
    "hardswish": ([f32(3, 4) * 4], {}),
    "hardtanh": ([f32(3, 4)], {"min": -0.5, "max": 0.8}),
    "instance_norm": ([X4, f32(6, seed=1), f32(6, seed=2)], {}),
    "interpolate": ([f32(1, 2, 3, 4)], {"scale_factor": 2, "mode": "nearest"}),
    "kl_div": ([f32(4, 3), prob(4, 3, seed=1)], {"reduction": "batchmean"}),
    "l1_loss": ([f32(4, 3), f32(4, 3, seed=1)], {}),
    "layer_norm": ([f32(3, 4, 5), [4, 5], f32(4, 5, seed=1), f32(4, 5, seed=2)], {}),
    "leaky_relu": ([f32(3, 4)], {"negative_slope": 0.2}),
    "linear": ([f32(3, 4), f32(4, 5, seed=1), f32(5, seed=2)], {}),
    "log_loss": ([prob(4, 1), prob(4, 1, seed=1)], {}),
    "log_sigmoid": ([f32(3, 4)], {}),
    "log_softmax": ([f32(3, 4)], {"axis": 0}),
    "margin_ranking_loss": ([f32(5), f32(5, seed=1), np.sign(f32(5, seed=2))], {"margin": 0.1}),
    "max_pool2d": ([X4], {"kernel_size": 3, "stride": 2, "padding": 1, "ceil_mode": True}),
    "maxout": ([X4], {"groups": 2}),
    "mish": ([f32(3, 4)], {}),
    "mse_loss": ([f32(4, 3), f32(4, 3, seed=1)], {"reduction": "none"}),
    "nll_loss": ([np.log(prob(6, 4)), i64(6, hi=4)], {}),
    "one_hot": ([i64(5, hi=4)], {"num_classes": 4}),
    "pad": ([f32(1, 2, 3, 3)], {"paddings": [0, 0, 0, 0, 1, 2, 2, 1], "value": 0.5}),
    "pixel_shuffle": ([f32(1, 8, 2, 3)], {"upscale_factor": 2}),
    "prelu": ([f32(3, 4), np.array([0.25], np.float32)], {}),
    "relu": ([f32(3, 4)], {}),
    "relu6": ([f32(3, 4) * 5], {}),
    "selu": ([f32(3, 4)], {}),
    "sigmoid": ([f32(3, 4)], {}),
    "silu": ([f32(3, 4)], {}),
    "smooth_l1_loss": ([f32(4, 3), f32(4, 3, seed=1)], {"delta": 0.5}),
    "softmax": ([f32(3, 4)], {"axis": -1}),
    "softmax_with_cross_entropy": ([f32(6, 5), i64(6, 1)], {}),
    "softplus": ([f32(3, 4) * 10], {"beta": 2.0, "threshold": 5.0}),
    "softshrink": ([f32(3, 4)], {"threshold": 0.4}),
    "softsign": ([f32(3, 4)], {}),
    "square_error_cost": ([f32(4, 3), f32(4, 3, seed=1)], {}),
    "swish": ([f32(3, 4)], {}),
    "tanh": ([f32(3, 4)], {}),
    "tanh_shrink": ([f32(3, 4)], {}),
    "unfold": ([f32(2, 3, 5, 6)], {"kernel_sizes": [2, 3], "strides": 1, "paddings": 1}),
    "upsample": ([f32(1, 2, 3, 4)], {"size": [6, 8], "mode": "bilinear"}),
}


def test_every_functional_name_has_a_case():
    names = {n for n in dir(jF) if not n.startswith("_") and callable(getattr(jF, n))}
    assert names == set(FUNCTIONAL)


@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_matches_jax(name):
    args, kwargs = FUNCTIONAL[name]
    want = getattr(jF, name)(*_args(jp, args), **kwargs)
    got = getattr(F, name)(*_args(pt, args), **kwargs)
    assert_same(got, want, name)


# class -> (constructor args, constructor kwargs, forward inputs)
LAYERS = {
    "AdaptiveAvgPool2D": ([(2, 3)], {}, [X4]),
    "AdaptiveMaxPool2D": ([2], {}, [X4]),
    "AvgPool2D": ([2], {"stride": 1}, [X4]),
    "BCELoss": ([], {}, [prob(4, 3), prob(4, 3, seed=1)]),
    "BCEWithLogitsLoss": ([], {}, [f32(4, 3), prob(4, 3, seed=1)]),
    "BatchNorm": ([6], {}, [X4]),
    "BatchNorm1D": ([6], {}, [f32(4, 6, 3)]),
    "BatchNorm2D": ([6], {}, [X4]),
    "BatchNorm3D": ([6], {}, [f32(2, 6, 2, 3, 3)]),
    "Bilinear": ([4, 3, 5], {}, [f32(2, 4), f32(2, 3, seed=1)]),
    "CELU": ([], {"alpha": 0.5}, [f32(3, 4)]),
    "Conv1D": ([4, 6, 3], {"padding": 1}, [f32(2, 4, 7)]),
    "Conv2D": ([6, 4, 3], {"stride": 2, "padding": 1}, [X4]),
    "Conv2DTranspose": ([6, 3, 3], {"stride": 2}, [X4]),
    "CosineSimilarity": ([], {"axis": 1}, [f32(4, 5), f32(4, 5, seed=1)]),
    "CrossEntropyLoss": ([], {}, [f32(6, 5), i64(6)]),
    "Dropout": ([0.4], {}, [f32(3, 4)]),
    "ELU": ([], {}, [f32(3, 4)]),
    "Embedding": ([7, 5], {"padding_idx": 0}, [i64(3, 4, hi=7)]),
    "Flatten": ([], {}, [X4]),
    "Fold": ([[4, 5], [2, 2]], {}, [f32(2, 12, 12)]),
    "GELU": ([], {}, [f32(3, 4)]),
    "GroupNorm": ([3, 6], {}, [X4]),
    "Hardshrink": ([], {}, [f32(3, 4)]),
    "Hardsigmoid": ([], {}, [f32(3, 4) * 4]),
    "Hardswish": ([], {}, [f32(3, 4) * 4]),
    "Hardtanh": ([], {}, [f32(3, 4)]),
    "InstanceNorm2D": ([6], {}, [X4]),
    "KLDivLoss": ([], {}, [f32(4, 3), prob(4, 3, seed=1)]),
    "L1Loss": ([], {}, [f32(4, 3), f32(4, 3, seed=1)]),
    "LayerNorm": ([5], {}, [f32(3, 4, 5)]),
    "LeakyReLU": ([], {}, [f32(3, 4)]),
    "Linear": ([4, 5], {}, [f32(3, 4)]),
    "LogSigmoid": ([], {}, [f32(3, 4)]),
    "LogSoftmax": ([], {}, [f32(3, 4)]),
    "MSELoss": ([], {}, [f32(4, 3), f32(4, 3, seed=1)]),
    "MarginRankingLoss": ([0.2], {}, [f32(5), f32(5, seed=1), np.sign(f32(5, seed=2))]),
    "MaxPool2D": ([3], {"stride": 2, "padding": 1}, [X4]),
    "Mish": ([], {}, [f32(3, 4)]),
    "NLLLoss": ([], {}, [np.log(prob(6, 4)), i64(6, hi=4)]),
    "PReLU": ([6], {"init": 0.1}, [X4]),
    "Pad2D": ([[1, 2, 0, 1]], {"value": 1.0}, [X4]),
    "PairwiseDistance": ([], {}, [f32(4, 5), f32(4, 5, seed=1)]),
    "PixelShuffle": ([2], {}, [f32(1, 8, 2, 3)]),
    "ReLU": ([], {}, [f32(3, 4)]),
    "ReLU6": ([], {}, [f32(3, 4) * 5]),
    "SELU": ([], {}, [f32(3, 4)]),
    "Sigmoid": ([], {}, [f32(3, 4)]),
    "Silu": ([], {}, [f32(3, 4)]),
    "SmoothL1Loss": ([], {}, [f32(4, 3), f32(4, 3, seed=1)]),
    "Softmax": ([], {}, [f32(3, 4)]),
    "Softplus": ([], {}, [f32(3, 4)]),
    "Softshrink": ([], {}, [f32(3, 4)]),
    "Softsign": ([], {}, [f32(3, 4)]),
    "SpectralNorm": ([[6, 4]], {"power_iters": 3}, [f32(6, 4)]),
    "Swish": ([], {}, [f32(3, 4)]),
    "SyncBatchNorm": ([6], {}, [X4]),
    "Tanh": ([], {}, [f32(3, 4)]),
    "Tanhshrink": ([], {}, [f32(3, 4)]),
    "Unfold": ([[2, 2]], {"strides": 2}, [f32(2, 3, 4, 6)]),
    "Upsample": ([], {"scale_factor": 2}, [f32(1, 2, 3, 4)]),
}


def _carry(jlayer, layer):
    missing, unexpected = layer.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()})
    assert not missing and not unexpected


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_layer_matches_jax(name, mode):
    args, kwargs, inputs = LAYERS[name]
    jlayer, layer = getattr(jnn, name)(*args, **kwargs), getattr(nn, name)(*args, **kwargs)
    assert isinstance(layer, nn.Layer)
    assert sorted(layer.state_dict()) == sorted(jlayer.state_dict())
    _carry(jlayer, layer)
    getattr(jlayer, mode)()
    getattr(layer, mode)()
    if name == "Dropout" and mode == "train":
        out = _np(layer(*_args(pt, inputs)))
        x = inputs[0]
        assert np.all((out == 0) | np.isclose(out, x / 0.6))
        return
    assert_same(layer(*_args(pt, inputs)), jlayer(*_args(jp, inputs)), f"{name} {mode}")
    for k, v in jlayer.state_dict().items():  # the batch norms' running statistics
        assert_same(layer.state_dict()[k], v, f"{name} {mode} {k}")


def test_every_layer_class_has_a_case():
    classes = {n for n in dir(jnn) if not n.startswith("_") and isinstance(getattr(jnn, n), type)
               and issubclass(getattr(jnn, n), jnn.Layer) and n != "Layer"}
    containers = {"LayerList", "ParameterList", "Sequential"}
    transformer = {"MultiHeadAttention", "Transformer", "TransformerDecoder",
                   "TransformerDecoderLayer", "TransformerEncoder", "TransformerEncoderLayer"}
    rnn = {"LSTM", "GRU", "SimpleRNN", "LSTMCell", "GRUCell"}  # tests/test_torch_rnn_layers.py
    assert classes - containers - transformer - rnn == set(LAYERS)


def test_linear_matches_numpy():
    layer = nn.Linear(4, 3)
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    out = layer(pt.to_tensor(x))
    expected = x @ layer.weight.numpy() + layer.bias.numpy()
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-5, atol=1e-5)


class _Net(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(4, 8)
        self.fc2 = nn.Linear(8, 2)
        self.act = nn.ReLU()

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def test_layer_registration_and_state_dict():
    net = _Net()
    assert set(dict(net.named_parameters())) == {"fc1.weight", "fc1.bias", "fc2.weight",
                                                 "fc2.bias"}
    assert isinstance(net.parameters(), list) and len(net.parameters()) == 4
    assert [n for n, _ in net.named_parameters(include_sublayers=False)] == []
    net2 = _Net()
    net2.set_state_dict({k: v.numpy() for k, v in net.state_dict().items()})
    x = pt.to_tensor(np.random.RandomState(1).randn(3, 4).astype(np.float32))
    np.testing.assert_allclose(net(x).numpy(), net2(x).numpy(), rtol=1e-6)
    assert isinstance(net.fc1.weight, pt.Parameter) and net.full_name().startswith("_net_")
    assert [type(s).__name__ for s in net.sublayers()] == ["Linear", "Linear", "ReLU"]


def test_dropout_train_eval():
    d = nn.Dropout(0.5)
    x = pt.ones([100, 100])
    d.train()
    frac = float((d(x).numpy() == 0).mean())
    assert 0.4 < frac < 0.6
    d.eval()
    np.testing.assert_array_equal(d(x).numpy(), x.numpy())


def test_batchnorm_running_stats_update():
    bn = nn.BatchNorm2D(3, momentum=0.9)
    x = pt.to_tensor(np.random.RandomState(2).randn(4, 3, 5, 5).astype(np.float32) + 2.0)
    bn.train()
    bn(x)
    assert np.all(bn._mean.numpy() > 0.1)
    assert sorted(bn.state_dict()) == ["_mean", "_variance", "bias", "weight"]


def test_embedding_padding_idx():
    e = nn.Embedding(10, 4, padding_idx=0)
    out = e(pt.to_tensor(np.array([0, 3], np.int64)))
    np.testing.assert_array_equal(out.numpy()[0], np.zeros(4))


def test_sequential_and_layerlist():
    seq = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    assert len(seq) == 3 and isinstance(seq[0], nn.Linear)
    assert seq(pt.ones([3, 4])).shape == (3, 2)
    ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
    ll.append(nn.Linear(2, 2))
    assert len(ll) == 4 and len(ll.parameters()) == 8
    named = nn.Sequential(("a", nn.Linear(2, 3)), ("b", nn.ReLU()))
    assert [n for n, _ in named.named_parameters()] == ["a.weight", "a.bias"]
    pl = nn.ParameterList([pt.Parameter(np.ones(2, np.float32)) for _ in range(2)])
    assert len(pl) == 2 and len(pl.parameters()) == 2


def test_train_eval_propagates():
    net = nn.Sequential(nn.Linear(2, 2), nn.Dropout(0.5))
    net.eval()
    assert not net[1].training
    net.train()
    assert net[1].training


def test_hooks():
    net = nn.Linear(2, 2)
    calls = []
    pre = net.register_forward_pre_hook(lambda layer, inputs: calls.append("pre"))
    post = net.register_forward_post_hook(lambda layer, inputs, out: calls.append("post"))
    net(pt.ones([1, 2]))
    pre.remove()
    post.remove()
    net(pt.ones([1, 2]))
    assert calls == ["pre", "post"]


def test_create_parameter_takes_attrs_and_initializers():
    layer = nn.Layer()
    w = layer.create_parameter([3, 2], attr=nn.ParamAttr(
        name="w0", initializer=nn.initializer.Constant(0.5), trainable=False))
    assert w.name == "w0" and w.stop_gradient and np.all(w.numpy() == 0.5)
    b = layer.create_parameter([4], is_bias=True)
    np.testing.assert_array_equal(b.numpy(), np.zeros(4))
    for init in (nn.initializer.Normal(0.0, 0.1), nn.initializer.TruncatedNormal(0.0, 0.1),
                 nn.initializer.Uniform(-0.1, 0.1), nn.initializer.XavierNormal(),
                 nn.initializer.KaimingNormal(), nn.initializer.Assign(np.ones((3, 2)))):
        p = layer.create_parameter([3, 2], attr=init)
        assert p.shape == (3, 2) and np.all(np.isfinite(p.numpy()))
    layer.add_parameter("w", w)
    layer.register_buffer("stat", pt.zeros([2]), persistable=False)
    assert "w" in layer.state_dict() and "stat" not in layer.state_dict()


def test_conv_pool_shapes_and_groups():
    conv = nn.Conv2D(3, 8, 3, stride=2, padding=1)
    assert conv(pt.ones([2, 3, 16, 16])).shape == (2, 8, 8, 8)
    assert nn.MaxPool2D(2, 2)(pt.ones([2, 8, 8, 8])).shape == (2, 8, 4, 4)
    assert nn.Conv2D(4, 8, 3, groups=2).weight.shape == (8, 2, 3, 3)


def test_layer_forward_appends_ops_in_static_mode():
    from paddle_tpu_torch import static

    net = _Net()
    prog = static.Program()
    static.enable_static()
    try:
        with static.program_guard(prog):
            out = net(static.data("x", [-1, 4], "float32"))
    finally:
        static.disable_static()
    assert [op.type for op in prog.global_block().ops] == ["linear", "relu", "linear"]
    assert out.shape == [-1, 2]


def test_missing_registry_kernel_raises_on_a_variable():
    from paddle_tpu_torch import ops, static
    from paddle_tpu_torch.errors import UnimplementedError

    with pytest.raises(UnimplementedError, match="no_such_op"):
        ops._run("no_such_op", pt.ones([2]))
    static.enable_static()
    try:
        with static.program_guard(static.Program()):
            x = static.data("x", [2], "float32")
            with pytest.raises(Exception, match="no_such_op"):
                ops._run("no_such_op", x)
    finally:
        static.disable_static()
