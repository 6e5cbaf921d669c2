"""Composite network helpers (``paddle_tpu/nets.py``): ``fluid/nets.py``'s five.

Compositions over the mode-aware op front and the ``static.nn`` layer functions,
as in the JAX package. ``glu`` and single-head
``scaled_dot_product_attention`` run in dygraph and in a static program;
the convolution and sequence blocks and the multi-head projection create
parameters, so they follow the reference's static-graph contract (a
dygraph model uses ``nn.Conv2D`` or ``nn.MultiHeadAttention``).

``sequence_conv_pool`` takes the padded batch and its lengths (the
sequence ops' ragged form, ``ops/sequence.py``) where the reference takes
an LoDTensor; it is the Paddle book's sentiment block.
"""
from __future__ import annotations

from . import ops
from .static import nn as static_nn

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool", "glu",
           "scaled_dot_product_attention"]


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
        pool = ops.adaptive_max_pool2d if pool_type == "max" else ops.adaptive_avg_pool2d
        return pool(conv_out, output_size=1)
    pool = ops.max_pool2d if pool_type == "max" else ops.avg_pool2d
    return pool(conv_out, kernel_size=pool_size, stride=pool_stride, padding=pool_padding)


def _per_layer(value, n, name):
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"{name} list length {len(value)} != number of conv layers {n}")
        return list(value)
    return [value] * n


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1, conv_filter_size=3,
                   conv_act=None, param_attr=None, conv_with_batchnorm=False,
                   conv_batchnorm_drop_rate=0.0, pool_stride=1, pool_type="max", use_cudnn=True):
    """Serial conv (+ batch norm) (+ dropout) closed by one pool
    (fluid/nets.py:141, VGG's block); with batch norm the activation
    follows the norm."""
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("conv_num_filter must be a list or tuple")
    n = len(conv_num_filter)
    paddings = _per_layer(conv_padding, n, "conv_padding")
    filter_sizes = _per_layer(conv_filter_size, n, "conv_filter_size")
    with_bn = _per_layer(conv_with_batchnorm, n, "conv_with_batchnorm")
    drop_rates = _per_layer(conv_batchnorm_drop_rate, n, "conv_batchnorm_drop_rate")
    attrs = _per_layer(param_attr, n, "param_attr")
    tmp = input
    for i in range(n):
        tmp = static_nn.conv2d(tmp, conv_num_filter[i], filter_sizes[i], padding=paddings[i],
                               weight_attr=attrs[i], bias_attr=False if with_bn[i] else None,
                               activation=None if with_bn[i] else conv_act)
        if with_bn[i]:
            tmp = static_nn.batch_norm(tmp)
            if conv_act:
                tmp = getattr(ops, conv_act)(tmp)
            if drop_rates[i]:
                tmp = static_nn.dropout(tmp, dropout_prob=drop_rates[i])
    pool = ops.max_pool2d if pool_type == "max" else ops.avg_pool2d
    return pool(tmp, kernel_size=pool_size, stride=pool_stride)


def sequence_conv_pool(input, lengths, num_filters, filter_size, param_attr=None, act="sigmoid",
                       pool_type="max", bias_attr=None):
    """sequence_conv + sequence_pool (fluid/nets.py:256) over the padded
    batch ``input [B, T, H]`` and its ``lengths [B]``."""
    in_hidden = input.shape[-1]
    w = static_nn.create_parameter([filter_size * in_hidden, num_filters], str(input.dtype),
                                   initializer=param_attr)
    conv_out = ops.sequence_conv(input, lengths, w, context_length=filter_size)
    if bias_attr is not False:
        b = static_nn.create_parameter([num_filters], str(input.dtype), initializer=bias_attr,
                                       is_bias=True)
        conv_out = ops.add(conv_out, b)
    if act:
        conv_out = getattr(ops, act)(conv_out)
    return ops.sequence_pool(conv_out, lengths, pooltype=pool_type.upper())


def glu(input, dim=-1):
    """Gated linear unit: halves ``a, b`` along ``dim``, ``a *
    sigmoid(b)`` (fluid/nets.py:328)."""
    a, b = ops.split(input, 2, axis=dim)
    return ops.multiply(a, ops.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1, dropout_rate=0.0):
    """Multi-head scaled dot-product attention (fluid/nets.py:372): ``q [N,
    Lq, dk*h]``, ``k [N, Lk, dk*h]``, ``v [N, Lk, dv*h]`` -> ``[N, Lq,
    dv*h]``; one head applies no projection, as the reference."""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same feature size, got "
                         f"{queries.shape[-1]} vs {keys.shape[-1]}")
    if keys.shape[1] != values.shape[1]:
        raise ValueError("keys and values must have the same sequence length, got "
                         f"{keys.shape[1]} vs {values.shape[1]}")
    if queries.shape[-1] % num_heads or values.shape[-1] % num_heads:
        raise ValueError(f"hidden sizes (q {queries.shape[-1]}, v {values.shape[-1]}) must be "
                         f"divisible by num_heads ({num_heads})")
    q, k, v = queries, keys, values
    if num_heads > 1:
        from .static.program import in_static_mode

        if not in_static_mode():
            raise RuntimeError(
                "scaled_dot_product_attention(num_heads > 1) creates implicit projection "
                "parameters and is static-graph only (matching the reference, "
                "fluid/nets.py:372); in dygraph use nn.MultiHeadAttention instead")
        q = static_nn.fc(q, q.shape[-1], num_flatten_dims=2, bias_attr=False)
        k = static_nn.fc(k, k.shape[-1], num_flatten_dims=2, bias_attr=False)
        v = static_nn.fc(v, v.shape[-1], num_flatten_dims=2, bias_attr=False)

    def split_heads(x):
        b, n, hd = x.shape
        b = -1 if b is None else b  # a static data variable declares its batch None
        return ops.transpose(ops.reshape(x, [b, n, num_heads, hd // num_heads]), [0, 2, 1, 3])

    def merge_heads(x):
        x = ops.transpose(x, [0, 2, 1, 3])
        b, n, h, d = x.shape
        return ops.reshape(x, [-1 if b is None else b, n, h * d])

    qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
    scores = ops.scale(ops.matmul(qh, kh, transpose_y=True), scale=float(qh.shape[-1]) ** -0.5)
    weights = ops.softmax(scores)
    if dropout_rate:
        weights = ops.dropout(weights, p=dropout_rate)
    return merge_heads(ops.matmul(weights, vh))
