"""Static-graph layer helpers (``paddle_tpu/static/nn.py:15-88``).

The parameter-creating layers: each creates its parameter Variables, appends
an ``init_param`` op to the startup program and builds the layer from the
mode-aware ops. Names come from the program's counters (``param_0``,
``mul_0``, ...), the same in both packages.
"""
from __future__ import annotations

from .. import ops
from ..nn import initializer as I
from .program import default_main_program, default_startup_program

__all__ = ["create_parameter", "fc", "conv2d", "layer_norm"]


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
