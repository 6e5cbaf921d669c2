"""Static-scale quantization ops (``paddle_tpu/ops/quantize_kernels.py:182-265``).

``quant_dequant_static`` is the simulation op post-training quantization
inserts while it calibrates; ``quantize_static``, ``dequantize_static``,
``mul_int8`` and ``matmul_int8`` are the ops of a deployed int8 program:
real int8 storage and an int8 x int8 -> int32 contraction
(:func:`paddle_tpu_torch.ops.cuda.int8_matmul.int8_matmul`), dequantized
once on the int32 accumulator. The expressions keep the JAX package's
order: ``x / s * bnt``, clip, round (half to even in both frameworks), and
the dequantizing constant ``scale_x * scale_y / (bnt_x * bnt_y)`` computed
in Python floats, then one float32 multiply. The only rounding in a product
is the operands' own quantization.

``FLAGS_use_int8_matmul`` chooses between exact routes and never changes a
number. On CPU tensors both settings run the plain int32 product. The card
has one exact integer route, the kernel: flag on launches it, flag off
raises.
"""
from __future__ import annotations

import math

import torch

from ..errors import UnimplementedError
from ..flags import flag
from ..framework.dtype import torch_dtype
from .cuda.int8_matmul import int8_matmul
from .registry import register_op

__all__ = []


def _bnt(bit_length) -> float:
    return float((1 << (int(bit_length) - 1)) - 1)


def _qdq(x, scale, bit_length):
    """Quantize to [-bnt, bnt] then dequantize (the simulation core)."""
    bnt = _bnt(bit_length)
    s = torch.clamp(scale, min=1e-8)
    q = torch.round(torch.clamp(x / s * bnt, -bnt, bnt))
    return q * s / bnt


@register_op("quant_dequant_static")
def quant_dequant_static(x, *, scale, bit_length=8):
    """PTQ simulation op with a calibrated constant scale."""
    # filled on x's device, not copied from the host: a host-to-device copy
    # cannot be captured into a CUDA graph
    return _qdq(x, torch.full((), float(scale), dtype=x.dtype, device=x.device), bit_length)


@register_op("quantize_static")
def quantize_static(x, *, scale, bit_length=8):
    """float -> int8 with a calibrated constant scale (the activation
    quantize of a deployed int8 program)."""
    bnt = _bnt(bit_length)
    # a tensor on x's device, not a Python number: by a number torch's CUDA
    # division multiplies by the reciprocal, which is an ulp off the true
    # quotient often enough to round an activation to the other side
    s = torch.full((), max(float(scale), 1e-8), dtype=torch.float32, device=x.device)
    q = torch.round(torch.clamp(x.float() / s * bnt, -bnt, bnt))
    return q.to(torch.int8)


@register_op("dequantize_static")
def dequantize_static(x, *, scale, bit_length=8, dtype="float32"):
    """int8 -> float with a constant scale (restores the weight of an op
    with no int8 compute path; folded once at load)."""
    return x.to(torch_dtype(dtype)) * (float(scale) / _bnt(bit_length))


def _contract(x2, y2):
    """The exact int8 product of two 2-D operands by the flag's route."""
    if x2.device.type != "cpu" and not flag("use_int8_matmul"):
        raise UnimplementedError(
            "FLAGS_use_int8_matmul is off and the operands are not on the CPU: the card has "
            "no second exact integer route beside the int8 kernel")
    return int8_matmul(x2.contiguous(), y2.contiguous())


def _dequant_constant(scale_x, scale_y, bit_length, y_bit_length) -> float:
    bnt_x = _bnt(bit_length)
    bnt_y = _bnt(bit_length if y_bit_length is None else y_bit_length)
    return float(scale_x) * float(scale_y) / (bnt_x * bnt_y)


@register_op("matmul_int8")
def matmul_int8(x, y, *, scale_x, scale_y, bit_length=8, y_bit_length=None, transpose_x=False,
                transpose_y=False):
    """int8 x int8 matmul with int32 accumulation and one dequantizing
    multiply. ``bit_length`` is ``x``'s grid width, ``y_bit_length``
    ``y``'s (defaulting to ``x``'s)."""
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    lead = tuple(x.shape[:-1])
    acc = _contract(x.reshape(-1, x.shape[-1]), y)
    out = acc.to(torch.float32) * _dequant_constant(scale_x, scale_y, bit_length, y_bit_length)
    return out.reshape(lead + (y.shape[-1],))


@register_op("mul_int8")
def mul_int8(x, y, *, scale_x, scale_y, bit_length=8, y_bit_length=None, x_num_col_dims=1,
             y_num_col_dims=1):
    """int8 twin of the ``mul`` op (flatten, then the 2-D product)."""
    xs = x.reshape(math.prod(x.shape[:x_num_col_dims]), -1)
    ys = y.reshape(math.prod(y.shape[:y_num_col_dims]), -1)
    acc = _contract(xs, ys)
    out = acc.to(torch.float32) * _dequant_constant(scale_x, scale_y, bit_length, y_bit_length)
    return out.reshape(tuple(x.shape[:x_num_col_dims]) + tuple(y.shape[y_num_col_dims:]))
