"""Operators of the port (``paddle_tpu/ops/__init__.py``).

The hand-written CUDA kernels live in :mod:`.cuda`; the op kernels a saved
Program names are registered in :mod:`.registry` by :mod:`.kernels` and
:mod:`.quantize_kernels`, and the beam search pair by :mod:`.beam_search`. The functions here are the mode-aware front: under
``static.enable_static()`` a call on a symbolic ``Variable`` appends an
``OpDesc`` to the default program, otherwise it computes on torch tensors.
Only the ops the ported static programs use are here.
"""
from __future__ import annotations

from . import beam_search, kernels, quantize_kernels  # noqa: F401  (register their ops)
from .registry import kernel

__all__ = ["add", "matmul", "mul", "reshape", "relu", "gelu", "layer_norm", "conv2d"]


def _run(name, *tensors, **attrs):
    from ..static.program import Variable, in_static_mode

    if in_static_mode() and any(isinstance(t, Variable) for t in tensors):
        from ..static.op_append import append_static_op

        return append_static_op(name, tensors, attrs)
    return kernel(name)(*tensors, **attrs)


def add(x, y):
    return _run("elementwise_add", x, y)


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
