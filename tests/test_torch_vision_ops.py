"""Port parity: the vision functional ops of the ResNet slice (``paddle_tpu_torch.nn.functional``).

``conv2d`` with every Paddle padding form in both layouts, ``max_pool2d``
with -inf padding and ``ceil_mode``, ``adaptive_avg_pool2d``, ``flatten``
and ``batch_norm`` (output and the running-statistics blend) against the
JAX package's ops on the same numpy inputs, and the layers' initializers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402

from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.nn import layers  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums of up to ~100 terms in other orders


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("f4")


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("padding,stride", [
    (1, 1), (0, 2), ([1, 2], 1), ([0, 1, 1, 0], 2), ([[1, 0], [0, 1]], 1), ("SAME", 2),
    ("VALID", 1)], ids=["int", "none_s2", "pair", "four", "pairs", "same_s2", "valid"])
def test_conv2d_matches_jax(padding, stride, df):
    x = _x((2, 3, 9, 9) if df == "NCHW" else (2, 9, 9, 3))
    w = _x((4, 3, 3, 3), seed=1) * 0.3
    b = _x((4,), seed=2)
    want = jF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w), paddle.to_tensor(b),
                     stride=stride, padding=padding, data_format=df).numpy()
    got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride=stride,
                   padding=padding, data_format=df).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_max_pool2d_matches_jax(ceil_mode, df):
    """ResNet's 3x3 stride-2 pad-1 pool on an odd size, where ``ceil_mode``
    adds a window; all-negative inputs show the padding never wins."""
    x = -np.abs(_x((2, 3, 11, 11) if df == "NCHW" else (2, 11, 11, 3))) - 1.0
    kw = dict(kernel_size=3, stride=2, padding=1, ceil_mode=ceil_mode, data_format=df)
    want = jF.max_pool2d(paddle.to_tensor(x), **kw).numpy()
    got = F.max_pool2d(torch.from_numpy(x), **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(1, 1), (3, 2)])
@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_adaptive_avg_pool2d_and_flatten_match_jax(size, df):
    x = _x((2, 5, 7, 6) if df == "NCHW" else (2, 7, 6, 5))
    want = jF.adaptive_avg_pool2d(paddle.to_tensor(x), size, data_format=df).numpy()
    got = F.adaptive_avg_pool2d(torch.from_numpy(x), size, data_format=df)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(F.flatten(got, 1).numpy(), got.numpy().reshape(2, -1))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_batch_norm_and_running_stats_match_jax(training, df):
    """Paddle's blend: ``momentum * running + (1 - momentum) * batch`` with
    the biased batch variance (torch's own batch norm would weight the
    other way and keep the unbiased variance)."""
    x = _x((4, 6, 5, 5) if df == "NCHW" else (4, 5, 5, 6)) * 2.0 + 3.0
    w, b = _x((6,), 1) + 2.0, _x((6,), 2)
    rm, rv = _x((6,), 3) * 0.1, np.abs(_x((6,), 4)) + 0.5
    jm, jv = paddle.to_tensor(rm.copy()), paddle.to_tensor(rv.copy())
    want = jF.batch_norm(paddle.to_tensor(x), jm, jv, paddle.to_tensor(w), paddle.to_tensor(b),
                         training=training, momentum=0.9, epsilon=1e-5, data_format=df).numpy()
    tm, tv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    got = F.batch_norm(torch.from_numpy(x), tm, tv, torch.from_numpy(w), torch.from_numpy(b),
                       training=training, momentum=0.9, epsilon=1e-5, data_format=df)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tm.numpy(), jm.numpy(), **TOL)
    np.testing.assert_allclose(tv.numpy(), jv.numpy(), **TOL)
    if training:
        axes = (0, 2, 3) if df == "NCHW" else (0, 1, 2)
        np.testing.assert_allclose(tv.numpy(), 0.9 * rv + 0.1 * x.var(axes), rtol=1e-5)


def test_layer_initializers_follow_paddle():
    """Conv2D: KaimingUniform ``sqrt(6 / fan_in)`` and a bias uniform in
    ``1 / sqrt(fan_in)``; BatchNorm2D: scale 1, shift 0, running mean 0 and
    variance 1 under the JAX package's buffer names."""
    conv = layers.Conv2D(8, 16, 3, generator=torch.Generator().manual_seed(0))
    fan_in = 8 * 9
    assert conv.weight.shape == (16, 8, 3, 3)
    assert float(conv.weight.abs().max()) <= (6.0 / fan_in) ** 0.5
    assert float(conv.weight.std()) > 0.8 * (2.0 / fan_in) ** 0.5
    assert float(conv.bias.abs().max()) <= fan_in ** -0.5
    assert layers.Conv2D(8, 16, 1, bias_attr=False).bias is None
    bn = layers.BatchNorm2D(16)
    assert [n for n, _ in bn.named_buffers()] == ["_mean", "_variance"]
    assert torch.equal(bn._variance, torch.ones(16)) and torch.equal(bn.bias, torch.zeros(16))
