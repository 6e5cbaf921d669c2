"""The recurrent layers (``paddle_tpu/nn/rnn.py``) against the JAX package's:
the weights carried by ``set_state_dict``, the same inputs from a numpy
seed, outputs and final states within RTOL/ATOL in float32; and the
gradients of a sum of the outputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
import paddle_tpu_torch.nn as nn  # noqa: E402
from paddle_tpu_torch.framework import place as _place  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
B, T, I, H = 3, 5, 4, 6


@pytest.fixture(autouse=True)
def _on_the_cpu():
    prev = _place._expected_place
    pt.set_device("cpu")
    yield
    _place._expected_place = prev


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(name, *args, **kwargs):
    jl, tl = getattr(jnn, name)(*args, **kwargs), getattr(nn, name)(*args, **kwargs)
    assert sorted(tl.state_dict()) == sorted(jl.state_dict())
    tl.set_state_dict({k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()})
    return jl, tl


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [np.asarray(out.numpy())]


def _close(got, want):
    for g, w in zip(_flat(got), _flat(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["LSTM", "GRU", "SimpleRNN"])
@pytest.mark.parametrize("direction,layers,time_major",
                         [("forward", 1, False), ("bidirect", 2, False), ("forward", 2, True)])
def test_recurrent_layer_matches_jax(name, direction, layers, time_major):
    jl, tl = _pair(name, I, H, num_layers=layers, direction=direction, time_major=time_major)
    x = _x(T, B, I) if time_major else _x(B, T, I)
    _close(tl(pt.to_tensor(x)), jl(jp.to_tensor(x)))


@pytest.mark.parametrize("name", ["LSTM", "GRU", "SimpleRNN"])
def test_recurrent_layer_takes_initial_states(name):
    jl, tl = _pair(name, I, H)
    x, h0, c0 = _x(B, T, I), _x(1, B, H, seed=1), _x(1, B, H, seed=2)
    if name == "LSTM":
        got = tl(pt.to_tensor(x), (pt.to_tensor(h0), pt.to_tensor(c0)))
        want = jl(jp.to_tensor(x), (jp.to_tensor(h0), jp.to_tensor(c0)))
    else:
        got, want = tl(pt.to_tensor(x), pt.to_tensor(h0)), jl(jp.to_tensor(x), jp.to_tensor(h0))
    _close(got, want)


@pytest.mark.parametrize("name", ["LSTMCell", "GRUCell"])
def test_cell_matches_jax(name):
    jl, tl = _pair(name, I, H)
    x, h = _x(B, I), _x(B, H, seed=1)
    _close(tl(pt.to_tensor(x)), jl(jp.to_tensor(x)))
    states = (pt.to_tensor(h), pt.to_tensor(h)) if name == "LSTMCell" else pt.to_tensor(h)
    jstates = (jp.to_tensor(h), jp.to_tensor(h)) if name == "LSTMCell" else jp.to_tensor(h)
    _close(tl(pt.to_tensor(x), states), jl(jp.to_tensor(x), jstates))


@pytest.mark.parametrize("name", ["LSTM", "GRU"])
def test_recurrent_gradients_match_jax(name):
    jl, tl = _pair(name, I, H, direction="bidirect")
    x = _x(B, T, I)
    jx, tx = jp.to_tensor(x, stop_gradient=False), pt.to_tensor(x, stop_gradient=False)
    jl(jx)[0].sum().backward()
    tl(tx)[0].sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()), rtol=1e-4,
                               atol=1e-5)
    jgrads = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n].grad.numpy()),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
