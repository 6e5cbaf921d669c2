"""Op kernels of the static programs the port serves (``paddle_tpu/ops/kernels.py``).

Only the ops those programs hold: the ``mul``/``matmul`` products, the
elementwise add, ``gelu``, ``relu``, ``layer_norm``, ``reshape`` and
``conv2d``. Each follows its JAX counterpart's expression (``layer_norm``
computes mean, biased variance and ``rsqrt`` in its own tensor ops, scale
and bias as a separate multiply and add). ``**kw`` swallows attributes a
saved op carries that the kernel does not read, as the JAX kernels do.
"""
from __future__ import annotations

import math

import torch

from .registry import register_op

__all__ = []


@register_op("elementwise_add")
def elementwise_add(x, y, **kw):
    return torch.add(x, y)


@register_op("relu")
def relu(x, **kw):
    return torch.relu(x)


@register_op("gelu")
def gelu(x, *, approximate=False):
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")


@register_op("matmul")
def matmul(x, y, *, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@register_op("mul")
def mul(x, y, *, x_num_col_dims=1, y_num_col_dims=1):
    """``operators/mul_op.cc``: flatten both operands to 2-D, then one
    matrix product."""
    xs = x.reshape(math.prod(x.shape[:x_num_col_dims]), -1)
    ys = y.reshape(math.prod(y.shape[:y_num_col_dims]), -1)
    out = xs @ ys
    return out.reshape(tuple(x.shape[:x_num_col_dims]) + tuple(y.shape[y_num_col_dims:]))


@register_op("reshape")
def reshape(x, *, shape):
    return torch.reshape(x, tuple(shape))


@register_op("layer_norm")
def layer_norm(x, scale=None, bias=None, *, epsilon=1e-5, begin_norm_axis=-1):
    """Normalize over the trailing axes from ``begin_norm_axis``;
    statistics in float32, output in ``x``'s dtype."""
    if begin_norm_axis < 0:
        begin_norm_axis = x.dim() + begin_norm_axis
    axes = tuple(range(begin_norm_axis, x.dim()))
    xf = x.float()
    mean = xf.mean(axes, keepdim=True)
    var = xf.var(axes, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + epsilon)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


@register_op("conv2d")
def conv2d(x, w, *, stride=1, padding=0, dilation=1, groups=1, data_format="NCHW"):
    from ..nn import functional as F  # nn.functional imports ops.cuda

    return F.conv2d(x, w, None, stride=stride, padding=padding, dilation=dilation,
                    groups=groups, data_format=data_format)
