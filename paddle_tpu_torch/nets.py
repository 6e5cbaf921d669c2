"""Composite network helpers (``paddle_tpu/nets.py:28-47``): ``simple_img_conv_pool``.

A ``static.nn.conv2d`` (its parameters made by the startup program) then a
``pool2d``, the block the MNIST book model stacks twice. Like the JAX
helper it follows the static-graph contract: it creates parameters, so a
dygraph model uses ``nn.Conv2D`` and ``nn.MaxPool2D`` instead.
"""
from __future__ import annotations

from . import ops
from .errors import UnimplementedError
from .static import nn as static_nn

__all__ = ["simple_img_conv_pool"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size, pool_stride,
                         pool_padding=0, pool_type="max", global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    """conv2d + pool2d (fluid/nets.py:29). ``use_cudnn`` is accepted for
    the signature and not read."""
    conv_out = static_nn.conv2d(input, num_filters, filter_size, stride=conv_stride,
                                padding=conv_padding, dilation=conv_dilation, groups=conv_groups,
                                weight_attr=param_attr, bias_attr=bias_attr, activation=act)
    if global_pooling:
        raise UnimplementedError("simple_img_conv_pool: global pooling is not ported")
    pool = ops.max_pool2d if pool_type == "max" else ops.avg_pool2d
    return pool(conv_out, kernel_size=pool_size, stride=pool_stride, padding=pool_padding)
