"""Operators of the port (``paddle_tpu/ops/__init__.py``).

The hand-written CUDA kernels live in :mod:`.cuda`; the op kernels a saved
Program names are registered in :mod:`.registry` by :mod:`.kernels` and
:mod:`.quantize_kernels`, the beam search pair by :mod:`.beam_search` and
the IR optimizer's fused ops by :mod:`.fused_ops`. The functions here are the mode-aware front: under
``static.enable_static()`` a call on a symbolic ``Variable`` appends an
``OpDesc`` to the default program, otherwise it computes on torch tensors.
Only the ops the ported static programs use are here.
"""
from __future__ import annotations

import torch

from . import beam_search, fused_ops, kernels, quantize_kernels  # noqa: F401  (register their ops)
from ..framework.dtype import dtype_name, torch_dtype
from .registry import kernel

__all__ = ["add", "subtract", "multiply", "divide", "maximum", "minimum", "square", "sqrt",
           "sum", "mean", "matmul", "mul", "reshape", "relu", "gelu", "softmax", "layer_norm",
           "conv2d", "max_pool2d", "avg_pool2d", "softmax_with_cross_entropy", "topk",
           "accuracy", "full", "zeros", "scale", "equal", "not_equal", "less_than",
           "less_equal", "greater_than", "greater_equal", "logical_and", "logical_or",
           "logical_xor", "logical_not", "sigmoid", "tanh", "argmax", "cast", "transpose",
           "concat", "split", "stack", "slice", "where", "assign", "batch_norm", "embedding",
           "dropout", "uniform", "normal"]


def _run(name, *tensors, **attrs):
    from ..static.program import Variable, in_static_mode

    if in_static_mode() and (any(isinstance(t, Variable) for t in tensors) or not tensors):
        from ..static.op_append import append_static_op

        return append_static_op(name, tensors, attrs)
    return kernel(name)(*tensors, **attrs)


def add(x, y):
    return _run("elementwise_add", x, y)


def subtract(x, y):
    return _run("elementwise_sub", x, y)


def multiply(x, y):
    return _run("elementwise_mul", x, y)


def divide(x, y):
    return _run("elementwise_div", x, y)


def maximum(x, y):
    return _run("elementwise_max", x, y)


def minimum(x, y):
    return _run("elementwise_min", x, y)


def square(x):
    return _run("square", x)


def sqrt(x):
    return _run("sqrt", x)


def sum(x, axis=None, keepdim=False):
    return _run("reduce_sum", x, dim=axis, keep_dim=keepdim)


def mean(x, axis=None, keepdim=False):
    return _run("reduce_mean", x, dim=axis, keep_dim=keepdim)


def softmax(x, axis=-1):
    return _run("softmax", x, axis=axis)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, data_format="NCHW"):
    return _run("pool2d", x, kernel_size=kernel_size, stride=stride, padding=padding,
                pooling_type="max", ceil_mode=ceil_mode, data_format=data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               data_format="NCHW"):
    return _run("pool2d", x, kernel_size=kernel_size, stride=stride, padding=padding,
                pooling_type="avg", ceil_mode=ceil_mode, exclusive=exclusive,
                data_format=data_format)


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1, ignore_index=-100):
    return _run("softmax_with_cross_entropy", logits, label, soft_label=soft_label, axis=axis,
                ignore_index=ignore_index)


def topk(x, k, axis=-1, largest=True, sorted=True):
    return _run("top_k", x, k=k, axis=axis, largest=largest, sorted=sorted)


def accuracy(input, label, k=1):
    """The share of rows whose label is among ``input``'s top ``k``."""
    _, idx = topk(input, k)
    return _run("accuracy", idx, label)


def full(shape, fill_value, dtype=None):
    """A host tensor (a constant once a static op takes it): float32 for a
    float, int64 for an int, bool for a bool, unless ``dtype`` (a torch
    dtype or its name) says."""
    if dtype is None:
        dtype = (torch.bool if isinstance(fill_value, bool) else
                 torch.int64 if isinstance(fill_value, int) else torch.float32)
    return torch.full(tuple(shape), fill_value, dtype=torch_dtype(dtype))


def zeros(shape, dtype=None):
    return full(shape, 0.0, dtype)


def matmul(x, y, transpose_x=False, transpose_y=False):
    return _run("matmul", x, y, transpose_x=transpose_x, transpose_y=transpose_y)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    return _run("mul", x, y, x_num_col_dims=x_num_col_dims, y_num_col_dims=y_num_col_dims)


def reshape(x, shape):
    return _run("reshape", x, shape=tuple(shape))


def relu(x):
    return _run("relu", x)


def gelu(x, approximate=False):
    return _run("gelu", x, approximate=approximate)


def layer_norm(x, normalized_shape=None, weight=None, bias=None, epsilon=1e-5):
    if normalized_shape is not None:
        n = len(normalized_shape) if isinstance(normalized_shape, (list, tuple)) else 1
        begin_norm_axis = -n
    else:
        begin_norm_axis = -1
    args = [x]
    if weight is not None:
        args.append(weight)
    if bias is not None:
        if weight is None:
            raise ValueError("bias without weight unsupported; pass both")
        args.append(bias)
    return _run("layer_norm", *args, epsilon=epsilon, begin_norm_axis=begin_norm_axis)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1, data_format="NCHW"):
    out = _run("conv2d", x, weight, stride=stride, padding=padding, dilation=dilation,
               groups=groups, data_format=data_format)
    if bias is not None:
        shape = [1] * len(out.shape)
        shape[1 if data_format == "NCHW" else len(out.shape) - 1] = -1
        out = add(out, reshape(bias, shape))
    return out


# -- control flow, recurrent layers and random ops --------------------------------


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    return _run("scale", x, scale=float(scale), bias=float(bias),
                bias_after_scale=bias_after_scale)


def _binary(name):
    def fn(x, y):
        return _run(name, x, y)

    fn.__name__ = name
    return fn


equal = _binary("equal")
not_equal = _binary("not_equal")
less_than = _binary("less_than")
less_equal = _binary("less_equal")
greater_than = _binary("greater_than")
greater_equal = _binary("greater_equal")
logical_and = _binary("logical_and")
logical_or = _binary("logical_or")
logical_xor = _binary("logical_xor")


def logical_not(x):
    return _run("logical_not", x)


def sigmoid(x):
    return _run("sigmoid", x)


def tanh(x):
    return _run("tanh", x)


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _run("arg_max", x, axis=axis, keepdims=keepdim, dtype=dtype_name(dtype))


def cast(x, dtype):
    return _run("cast", x, dtype=dtype_name(dtype))


def transpose(x, perm):
    return _run("transpose", x, perm=tuple(perm))


def concat(xs, axis=0):
    return _run("concat", *xs, axis=axis)


def split(x, num_or_sections, axis=0):
    sections = num_or_sections if isinstance(num_or_sections, int) else tuple(num_or_sections)
    return list(_run("split", x, num_or_sections=sections, axis=axis))


def stack(xs, axis=0):
    return _run("stack", *xs, axis=axis)


def slice(x, axes, starts, ends):
    return _run("slice", x, axes=tuple(axes), starts=tuple(starts), ends=tuple(ends))


def where(cond, x, y):
    return _run("where", cond, x, y)


def assign(x):
    return _run("assign", x)


def embedding(x, weight, padding_idx=None):
    return _run("lookup_table", weight, x, padding_idx=-1 if padding_idx is None else padding_idx)


def batch_norm(x, running_mean, running_var, weight, bias, training=False, momentum=0.9,
               epsilon=1e-5, data_format="NCHW"):
    """In a static program the op's running-statistics outputs are the
    running variables themselves (``__inplace__``), so the executor writes
    them back; eagerly the new statistics are copied into the buffers."""
    from ..static.program import Variable, in_static_mode

    attrs = dict(momentum=momentum, epsilon=epsilon, training=training,
                 data_format=data_format)
    if in_static_mode() and isinstance(x, Variable):
        from ..static.op_append import append_static_op

        alias = {1: running_mean.name, 2: running_var.name} if training else None
        y, _, _ = append_static_op("batch_norm", [x, weight, bias, running_mean, running_var],
                                   attrs, alias_outputs=alias)
        return y
    y, new_mean, new_var = kernel("batch_norm")(x, weight, bias, running_mean, running_var,
                                                **attrs)
    if training:
        with torch.no_grad():
            running_mean.copy_(new_mean)
            running_var.copy_(new_var)
    return y


def dropout(x, p=0.5, training=True, mode="upscale_in_train"):
    if not training or p == 0.0:
        return x
    return _run("dropout", x, p=p, training=training, mode=mode)


def uniform(shape, dtype=None, min=-1.0, max=1.0):
    return _run("uniform_random", shape=tuple(shape), min=float(min), max=float(max),
                dtype=dtype_name(dtype or "float32"))


def normal(mean=0.0, std=1.0, shape=None):
    return _run("gaussian_random", shape=tuple(shape), mean=float(mean), std=float(std),
                dtype="float32")
