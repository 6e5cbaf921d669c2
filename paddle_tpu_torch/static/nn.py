"""Static-graph layer helpers (``paddle_tpu/static/nn.py``).

The parameter-creating layers: each creates its parameter Variables, appends
an ``init_param`` op to the startup program and builds the layer from the
mode-aware ops. Names come from the program's counters (``param_0``,
``mul_0``, ...), the same in both packages. The recurrent layers
(``simple_rnn``, ``lstm``, ``gru``) run a ``scan`` over time with the JAX
package's weight layout: one ``[in, n_gates * H]`` input matrix, one
``[H, n_gates * H]`` recurrent matrix and one bias, gates in i, f, g, o
order for the LSTM. The control-flow functions are re-exported here, as
``paddle.static.nn`` has them.
"""
from __future__ import annotations

from .. import ops
from ..nn import initializer as I
from .program import default_main_program, default_startup_program

__all__ = ["create_parameter", "fc", "conv2d", "layer_norm", "batch_norm", "embedding",
           "dropout", "simple_rnn", "lstm", "gru", "while_loop", "cond", "scan", "case",
           "switch_case"]


def create_parameter(shape, dtype="float32", name=None, initializer=None, is_bias=False,
                     trainable=True):
    prog = default_main_program()
    name = name or prog._unique_name("param")
    init = I._resolve(initializer, is_bias=is_bias)
    var = prog.global_block().create_parameter(name, shape, dtype, initializer=init,
                                               trainable=trainable)
    default_startup_program().global_block().append_op(
        "init_param", {"X": []}, {"Out": [name]},
        {"initializer": init, "shape": list(shape), "dtype": dtype})
    return var


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None, activation=None,
       name=None):
    """``fluid.layers.fc``: flatten + mul + bias + activation."""
    in_features = 1
    for d in x.shape[num_flatten_dims:]:
        in_features *= d
    w = create_parameter([in_features, size], str(x.dtype), initializer=weight_attr)
    out = ops.mul(x, w, x_num_col_dims=num_flatten_dims)
    if bias_attr is not False:
        b = create_parameter([size], str(x.dtype), initializer=bias_attr, is_bias=True)
        out = ops.add(out, b)
    if activation:
        out = getattr(ops, activation)(out)
    return out


def conv2d(x, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,
           weight_attr=None, bias_attr=None, activation=None, name=None):
    ks = filter_size if isinstance(filter_size, (list, tuple)) else (filter_size, filter_size)
    in_channels = x.shape[1]
    fan_in = in_channels // groups * ks[0] * ks[1]
    w = create_parameter([num_filters, in_channels // groups, ks[0], ks[1]], str(x.dtype),
                         initializer=weight_attr or I.KaimingUniform(fan_in=fan_in))
    out = ops.conv2d(x, w, None, stride=stride, padding=padding, dilation=dilation,
                     groups=groups)
    if bias_attr is not False:
        b = create_parameter([num_filters], str(x.dtype), initializer=bias_attr, is_bias=True)
        out = ops.add(out, ops.reshape(b, [1, num_filters, 1, 1]))
    if activation:
        out = getattr(ops, activation)(out)
    return out


def layer_norm(x, begin_norm_axis=-1, epsilon=1e-5, weight_attr=None, bias_attr=None):
    if begin_norm_axis < 0:
        begin_norm_axis = len(x.shape) + begin_norm_axis
    shape = list(x.shape[begin_norm_axis:])
    scale = create_parameter(shape, str(x.dtype), initializer=weight_attr or I.Constant(1.0))
    bias = create_parameter(shape, str(x.dtype), initializer=bias_attr, is_bias=True)
    return ops.layer_norm(x, shape, scale, bias, epsilon)


def batch_norm(x, momentum=0.9, epsilon=1e-5, weight_attr=None, bias_attr=None, is_test=False,
               name=None):
    c = x.shape[1]
    scale = create_parameter([c], str(x.dtype), initializer=weight_attr or I.Constant(1.0))
    bias = create_parameter([c], str(x.dtype), initializer=bias_attr, is_bias=True)
    mean = create_parameter([c], str(x.dtype), initializer=I.Constant(0.0), trainable=False)
    var = create_parameter([c], str(x.dtype), initializer=I.Constant(1.0), trainable=False)
    return ops.batch_norm(x, mean, var, scale, bias, training=not is_test, momentum=momentum,
                          epsilon=epsilon)


def embedding(x, size, padding_idx=None, weight_attr=None, name=None):
    w = create_parameter(list(size), "float32", initializer=weight_attr or I.Normal(0.0, 1.0))
    return ops.embedding(x, w, padding_idx=padding_idx)


def dropout(x, dropout_prob=0.5, is_test=False):
    return ops.dropout(x, p=dropout_prob, training=not is_test)


# -- recurrent layers over scan (``paddle_tpu/static/nn.py:113-218``) ----------------


def _recurrent(x, init_states, hidden_size, n_gates, step, time_major, init_of):
    """The scan loop of the recurrent layers: ``x`` is ``[B, T, D]`` (or
    ``[T, B, D]``), ``step(states, gates)`` the cell's state update."""
    from .control_flow import scan

    if not time_major:
        x = ops.transpose(x, [1, 0, 2])  # [T, B, D]
    in_dim = x.shape[2]
    w_ih = create_parameter([in_dim, n_gates * hidden_size], str(x.dtype))
    w_hh = create_parameter([hidden_size, n_gates * hidden_size], str(x.dtype))
    b = create_parameter([n_gates * hidden_size], str(x.dtype), is_bias=True)

    if init_states is None:
        batch = x.shape[1]
        if batch in (-1, None):
            raise ValueError("recurrent layers need either a static batch dim or explicit "
                             "initial states (the carries have a fixed shape)")
        init_states = init_of(batch)

    def cell(*args):
        states, xt = list(args[:-1]), args[-1]
        gates = ops.add(ops.add(ops.matmul(xt, w_ih), ops.matmul(states[0], w_hh)), b)
        new_states = step(states, gates)
        return new_states, [new_states[0]]

    finals, ys = scan(cell, init_states, [x])
    out = ys[0]  # [T, B, H]
    if not time_major:
        out = ops.transpose(out, [1, 0, 2])
    return out, finals


def simple_rnn(x, hidden_size, init_h=None, time_major=False, name=None):
    """Elman RNN over scan; returns ``(out, [h_T])``."""

    def step(states, gates):
        return [ops.tanh(gates)]

    return _recurrent(x, [init_h] if init_h is not None else None, hidden_size, 1, step,
                      time_major, lambda b: [ops.zeros([b, hidden_size], str(x.dtype))])


def lstm(x, hidden_size, init_h=None, init_c=None, time_major=False, name=None):
    """``fluid.layers.lstm``; returns ``(out, [h_T, c_T])``."""

    from ..nn.rnn import lstm_step

    def step(states, gates):
        return list(lstm_step(gates, states[1]))

    inits = [init_h, init_c] if init_h is not None and init_c is not None else None
    return _recurrent(x, inits, hidden_size, 4, step, time_major,
                      lambda b: [ops.zeros([b, hidden_size], str(x.dtype)),
                                 ops.zeros([b, hidden_size], str(x.dtype))])


def gru(x, hidden_size, init_h=None, time_major=False, name=None):
    """GRU over scan, the candidate's recurrent term on the reset-scaled
    state; returns ``(out, [h_T])``."""
    from .control_flow import scan

    if not time_major:
        x = ops.transpose(x, [1, 0, 2])
    in_dim = x.shape[2]
    H = hidden_size
    w_ih = create_parameter([in_dim, 3 * H], str(x.dtype))
    w_hh_rz = create_parameter([H, 2 * H], str(x.dtype))
    w_hh_c = create_parameter([H, H], str(x.dtype))
    b = create_parameter([3 * H], str(x.dtype), is_bias=True)

    if init_h is None:
        batch = x.shape[1]
        if batch in (-1, None):
            raise ValueError("gru needs a static batch dim or explicit init_h")
        init_h = ops.zeros([batch, H], str(x.dtype))

    def cell(h, xt):
        xg = ops.add(ops.matmul(xt, w_ih), b)  # [B, 3H]
        x_rz = ops.slice(xg, [1], [0], [2 * H])
        x_c = ops.slice(xg, [1], [2 * H], [3 * H])
        rz = ops.sigmoid(ops.add(x_rz, ops.matmul(h, w_hh_rz)))
        r = ops.slice(rz, [1], [0], [H])
        z = ops.slice(rz, [1], [H], [2 * H])
        cand = ops.tanh(ops.add(x_c, ops.matmul(ops.multiply(r, h), w_hh_c)))
        h2 = ops.add(ops.multiply(z, h), ops.multiply(ops.subtract(ops.full([], 1.0), z), cand))
        return [h2], [h2]

    finals, ys = scan(cell, [init_h], [x])
    out = ys[0]
    if not time_major:
        out = ops.transpose(out, [1, 0, 2])
    return out, finals


from .control_flow import case, cond, scan, switch_case, while_loop  # noqa: E402,F401
