"""Recurrent layers (``paddle_tpu/nn/rnn.py``): ``LSTM``, ``GRU``,
``SimpleRNN``, ``LSTMCell`` and ``GRUCell``.

The JAX package's parameter names and layouts (``weight_ih_l0``
``[gates * H, I]``, ``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``, and
``_reverse`` for the second direction), gates in the order ``i, f, g, o``
(LSTM) and ``r, z, n`` (GRU, the candidate's recurrent term scaled by
``r`` after its product), so a ``paddle_tpu`` state dict loads by name.
A layer over one direction runs as one registry op (``rnn_lstm_layer``,
``rnn_gru_layer``, ``rnn_simple_layer``, as the JAX package registers
them): the input projection of every step in one product, then a loop
over time. The LSTM cell's update (:func:`lstm_step`) is the one
``static.nn.lstm`` runs inside its scan.
"""
from __future__ import annotations

import torch

from .. import ops
from ..framework.tensor import wrap
from ..ops.registry import register_op
from . import functional as F
from . import initializer as I
from .layer_base import Layer

__all__ = ["LSTM", "GRU", "SimpleRNN", "LSTMCell", "GRUCell", "lstm_step"]


def lstm_step(gates, c):
    """One LSTM update from the summed gate pre-activations ``[B, 4H]``
    (``i, f, g, o``) and the cell state: ``(h, c)``. Mode-aware, so a
    static scan body runs it on ``Variable``\\ s."""
    i, f, g, o = ops.split(gates, 4, axis=-1)
    c2 = ops.add(ops.multiply(ops.sigmoid(f), c), ops.multiply(ops.sigmoid(i), ops.tanh(g)))
    return ops.multiply(ops.sigmoid(o), ops.tanh(c2)), c2


def _time_loop(x, reverse, step, state):
    """``step(state, t)`` over the time axis of ``[B, T, ...]``, the outputs
    ``[B, T, H]`` in input order."""
    steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    ys = [None] * x.shape[1]
    for t in steps:
        state, ys[t] = step(state, t)
    return torch.stack(ys, 1), state


@register_op("rnn_lstm_layer", num_outputs=3)
def _lstm_layer(x, h0, c0, w_ih, w_hh, b_ih, b_hh, *, reverse=False):
    """``x`` ``[B, T, I]`` -> ``(y [B, T, H], h [B, H], c [B, H])``."""
    gx = torch.matmul(x, w_ih.t()) + b_ih

    def step(state, t):
        h, c = lstm_step(gx[:, t] + torch.matmul(state[0], w_hh.t()) + b_hh, state[1])
        return (h, c), h

    y, (h, c) = _time_loop(x, reverse, step, (h0, c0))
    return y, h, c


@register_op("rnn_gru_layer", num_outputs=2)
def _gru_layer(x, h0, w_ih, w_hh, b_ih, b_hh, *, reverse=False):
    gx = torch.matmul(x, w_ih.t()) + b_ih

    def step(h, t):
        rx, zx, nx = gx[:, t].chunk(3, -1)
        rh, zh, nh = (torch.matmul(h, w_hh.t()) + b_hh).chunk(3, -1)
        r, z = torch.sigmoid(rx + rh), torch.sigmoid(zx + zh)
        h = (1 - z) * torch.tanh(nx + r * nh) + z * h
        return h, h

    return _time_loop(x, reverse, step, h0)


@register_op("rnn_simple_layer", num_outputs=2)
def _simple_layer(x, h0, w_ih, w_hh, b_ih, b_hh, *, activation="tanh", reverse=False):
    gx = torch.matmul(x, w_ih.t()) + b_ih
    act = torch.tanh if activation == "tanh" else torch.relu

    def step(h, t):
        h = act(gx[:, t] + torch.matmul(h, w_hh.t()) + b_hh)
        return h, h

    return _time_loop(x, reverse, step, h0)


class RNNBase(Layer):
    MODE = "LSTM"
    GATES = 4

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward", dropout=0.0,
                 time_major=False, weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.num_directions = 2 if direction in ("bidirect", "bidirectional") else 1
        self.dropout = dropout
        self.time_major = time_major
        g, std = self.GATES, 1.0 / hidden_size ** 0.5
        init = I.Uniform(-std, std)
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_size = input_size if layer == 0 else hidden_size * self.num_directions
                suffix = f"_l{layer}" + ("_reverse" if d else "")
                for name, shape, attr in (
                        ("weight_ih", [g * hidden_size, in_size], weight_ih_attr),
                        ("weight_hh", [g * hidden_size, hidden_size], weight_hh_attr),
                        ("bias_ih", [g * hidden_size], bias_ih_attr),
                        ("bias_hh", [g * hidden_size], bias_hh_attr)):
                    self.add_parameter(name + suffix, self.create_parameter(
                        shape, attr=attr, is_bias=name.startswith("bias"),
                        default_initializer=init))

    def _weights(self, layer, d):
        suffix = f"_l{layer}" + ("_reverse" if d else "")
        return [self._parameters[n + suffix]
                for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]

    def forward(self, inputs, initial_states=None):
        if self.time_major:
            inputs = ops.transpose(inputs, [1, 0, 2])
        nd = self.num_directions
        zeros = lambda: wrap(torch.zeros(  # noqa: E731
            self.num_layers * nd, inputs.shape[0], self.hidden_size, dtype=inputs.dtype,
            device=inputs.device))
        if self.MODE == "LSTM":
            h0, c0 = initial_states if initial_states is not None else (zeros(), zeros())
        else:
            h0 = initial_states if initial_states is not None else zeros()
        out, last_h, last_c = inputs, [], []
        for layer in range(self.num_layers):
            outs = []
            for d in range(nd):
                idx = layer * nd + d
                weights = self._weights(layer, d)
                if self.MODE == "LSTM":
                    y, h, c = ops._run("rnn_lstm_layer", out, h0[idx], c0[idx], *weights,
                                       reverse=bool(d))
                    last_c.append(c)
                elif self.MODE == "GRU":
                    y, h = ops._run("rnn_gru_layer", out, h0[idx], *weights, reverse=bool(d))
                else:
                    y, h = ops._run("rnn_simple_layer", out, h0[idx], *weights,
                                    activation="tanh", reverse=bool(d))
                outs.append(y)
                last_h.append(h)
            out = outs[0] if nd == 1 else ops.concat(outs, axis=-1)
            if self.dropout and layer < self.num_layers - 1:
                out = F.dropout(out, p=self.dropout, training=self.training)
        final_h = ops.stack(last_h, axis=0)
        if self.time_major:
            out = ops.transpose(out, [1, 0, 2])
        if self.MODE == "LSTM":
            return out, (final_h, ops.stack(last_c, axis=0))
        return out, final_h


class LSTM(RNNBase):
    MODE, GATES = "LSTM", 4


class GRU(RNNBase):
    MODE, GATES = "GRU", 3


class SimpleRNN(RNNBase):
    MODE, GATES = "RNN", 1


class _Cell(Layer):
    def __init__(self, input_size, hidden_size, gates):
        super().__init__()
        init = I.Uniform(-1.0 / hidden_size ** 0.5, 1.0 / hidden_size ** 0.5)
        self.weight_ih = self.create_parameter([gates * hidden_size, input_size],
                                               default_initializer=init)
        self.weight_hh = self.create_parameter([gates * hidden_size, hidden_size],
                                               default_initializer=init)
        self.bias_ih = self.create_parameter([gates * hidden_size], is_bias=True)
        self.bias_hh = self.create_parameter([gates * hidden_size], is_bias=True)
        self.hidden_size = hidden_size

    def _zeros(self, x):
        return wrap(torch.zeros(x.shape[0], self.hidden_size, dtype=x.dtype, device=x.device))

    def _proj(self, x, w, b):
        return ops.add(ops.matmul(x, w, transpose_y=True), b)


class LSTMCell(_Cell):
    def __init__(self, input_size, hidden_size):
        super().__init__(input_size, hidden_size, 4)

    def forward(self, x, states=None):
        h, c = states if states is not None else (self._zeros(x), self._zeros(x))
        gates = ops.add(self._proj(x, self.weight_ih, self.bias_ih),
                        self._proj(h, self.weight_hh, self.bias_hh))
        h, c = lstm_step(gates, c)
        return h, (h, c)


class GRUCell(_Cell):
    def __init__(self, input_size, hidden_size):
        super().__init__(input_size, hidden_size, 3)

    def forward(self, x, states=None):
        h = states if states is not None else self._zeros(x)
        rx, zx, nx = ops.split(self._proj(x, self.weight_ih, self.bias_ih), 3, axis=-1)
        rh, zh, nh = ops.split(self._proj(h, self.weight_hh, self.bias_hh), 3, axis=-1)
        r, z = ops.sigmoid(rx + rh), ops.sigmoid(zx + zh)
        h = (1 - z) * ops.tanh(nx + r * nh) + z * h
        return h, h
