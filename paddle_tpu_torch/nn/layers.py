"""Core layers of the serving path (``paddle_tpu/nn/layers.py``).

``torch.nn.Module``s with Paddle's attribute names and parameter layouts,
so a ``paddle_tpu`` state dict loads by name: ``Linear.weight`` is
``[in_features, out_features]`` as in Paddle (not torch's ``[out, in]``),
``Conv2D.weight`` is OIHW in both data formats, and ``BatchNorm2D`` keeps
its running statistics in the buffers ``_mean`` and ``_variance``.
Random init takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..flags import flag
from . import functional as F
from .initializer import Initializer

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout", "LayerList", "Conv2D", "BatchNorm2D",
           "MaxPool2D", "AdaptiveAvgPool2D", "Flatten", "Sequential", "fused_conv_bn_relu"]


def _param(shape, device=None, dtype=torch.float32):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Linear(nn.Module):
    """``weight_attr`` and ``bias_attr``: an
    :class:`~paddle_tpu_torch.nn.initializer.Initializer` draws the tensor
    from ``generator``; None means XavierUniform for the weight and zeros
    for the bias; ``bias_attr=False`` leaves the bias out. ``name`` is
    accepted for the JAX signature and not kept."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, name=None,
                 generator=None, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        shape = (in_features, out_features)
        if isinstance(weight_attr, Initializer):
            self.weight = nn.Parameter(weight_attr(shape, generator=generator, device=device))
        elif weight_attr is None:
            self.weight = _param(shape, device)
            bound = math.sqrt(6.0 / (in_features + out_features))  # XavierUniform
            with torch.no_grad():
                self.weight.uniform_(-bound, bound, generator=generator)
        else:
            raise TypeError(f"Linear: weight_attr must be an Initializer, got {weight_attr!r}")
        if bias_attr is False:
            self.bias = None
        elif isinstance(bias_attr, Initializer):
            self.bias = nn.Parameter(bias_attr((out_features,), generator=generator,
                                               device=device))
        elif bias_attr is None:
            self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        else:
            raise TypeError(f"Linear: bias_attr must be an Initializer or False, got {bias_attr!r}")

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    """The table ``[num_embeddings, embedding_dim]``, drawn by ``weight_attr``
    (an :class:`~paddle_tpu_torch.nn.initializer.Initializer`) or N(0, 1)
    when it is None, from ``generator``. ``sparse`` and ``name`` are
    accepted for the JAX signature and not kept."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, generator=None, device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        shape = (num_embeddings, embedding_dim)
        if weight_attr is None:
            self.weight = _param(shape, device)
            with torch.no_grad():
                self.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(weight_attr, Initializer):
            self.weight = nn.Parameter(weight_attr(shape, generator=generator, device=device))
        else:
            raise TypeError(f"Embedding: weight_attr must be an Initializer, got {weight_attr!r}")

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False
                       else nn.Parameter(torch.ones(self.normalized_shape, device=device)))
        self.bias = (None if bias_attr is False
                     else nn.Parameter(torch.zeros(self.normalized_shape, device=device)))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class Dropout(nn.Module):
    """``generator`` draws the masks; None means the input's device's
    default generator (``framework.random``)."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


LayerList = nn.ModuleList
# sublayers named "0", "1", ... as the JAX package's Sequential names them
Sequential = nn.Sequential


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class Conv2D(nn.Module):
    """OIHW weight, KaimingUniform (``sqrt(6 / fan_in)``) from ``generator``;
    the bias, unless ``bias_attr`` is False, uniform in ``1/sqrt(fan_in)``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, bias_attr=None, data_format="NCHW", generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
        self.data_format = data_format
        fan_in = in_channels // groups * kh * kw
        self.weight = _param((out_channels, in_channels // groups, kh, kw))
        bound = math.sqrt(6.0 / fan_in)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
        if bias_attr is not False:
            self.bias = _param((out_channels,))
            with torch.no_grad():
                self.bias.uniform_(-1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in),
                                   generator=generator)
        else:
            self.bias = None

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, data_format=self.data_format, **self._attrs)


class BatchNorm2D(nn.Module):
    """Scale ones, shift zeros; running ``_mean`` zeros and ``_variance``
    ones, blended as ``momentum * running + (1 - momentum) * batch``."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, data_format="NCHW"):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = "NCHW" if data_format in ("NCHW", "NCL", "NCDHW") else "NHWC"
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self.momentum,
                            epsilon=self.epsilon, data_format=self.data_format)


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, data_format="NCHW"):
        super().__init__()
        self._attrs = dict(kernel_size=kernel_size, stride=stride, padding=padding,
                           ceil_mode=ceil_mode, data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, **self._attrs)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, data_format=self.data_format)


class Flatten(nn.Module):
    """Axes ``start_axis`` to ``stop_axis`` merged into one (by default all
    but the batch axis)."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


def fused_conv_bn_relu(conv, bn, x):
    """``relu(bn(conv(x)))``, through the fused kernels
    (``FLAGS_use_fused_conv_bn``, ``ops/cuda/conv_bn_relu.py``) when the
    triple is admissible as ``paddle_tpu/nn/layers.py:205-210`` admits it:
    a bias-free, ungrouped, undilated :class:`Conv2D` feeding a
    :class:`BatchNorm2D` of the same layout. In training the running
    statistics are blended into ``bn``'s buffers in place, as
    :func:`~paddle_tpu_torch.nn.functional.batch_norm` does."""
    attrs = conv._attrs
    if (flag("use_fused_conv_bn") and conv.bias is None and attrs["groups"] == 1
            and _pair(attrs["dilation"]) == (1, 1) and isinstance(bn, BatchNorm2D)
            and bn.data_format == ("NCHW" if conv.data_format == "NCHW" else "NHWC")):
        from ..amp import _enabled as _amp_scope
        from ..ops.cuda import conv_bn_relu as cbr

        # as the unfused path autocasts the conv (a white op) and not the
        # batch norm: x and the weight take the AMP dtype, gamma, beta and
        # the running statistics stay f32 (paddle_tpu/nn/layers.py:214-228)
        weight = conv.weight
        scope = _amp_scope()
        if scope is not None and "conv2d" in scope[1]:
            x, weight = (t.to(scope[0]) if t.dtype == torch.float32 else t for t in (x, weight))
        y, new_mean, new_var = cbr.conv_bn_relu(
            x, weight, bn.weight, bn.bias, bn._mean, bn._variance,
            stride=attrs["stride"], padding=attrs["padding"], epsilon=bn.epsilon,
            momentum=bn.momentum, training=bn.training, data_format=conv.data_format)
        if bn.training:
            with torch.no_grad():
                bn._mean.copy_(new_mean)
                bn._variance.copy_(new_var)
        return y
    return F.relu(bn(conv(x)))
