"""The quantization ops (``paddle_tpu/ops/quantize_kernels.py``): fake quantization and the static-scale ops.

The ten fake-quantization ops (``:34-182``) simulate int8 in floats: the
quantized grid values, or quantize-then-dequantize with a scale from the
tensor's abs-max, a running window or a moving average. The
quant-dequant ops pass the gradient straight through
(:class:`_QdqSTE`, the JAX kernel's ``custom_vjp``): ``dL/dx = dL/dout``,
and the scale, an observed statistic, gets none.

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
from .registry import register_op, register_shape

__all__ = []


def _bnt(bit_length) -> float:
    return float((1 << (int(bit_length) - 1)) - 1)


def _qdq(x, scale, bit_length):
    """Quantize to [-bnt, bnt] then dequantize (the simulation core)."""
    bnt = _bnt(bit_length)
    s = torch.clamp(scale, min=1e-8)
    q = torch.round(torch.clamp(x / s * bnt, -bnt, bnt))
    return q * s / bnt


def _abs_max(x, dims=None):
    a = torch.abs(x)
    return torch.amax(a) if dims is None else torch.amax(a, dim=dims)


def _grid(x, scale, bit_length):
    """The rounded grid values ``round(clip(x / s * bnt))``."""
    bnt = _bnt(bit_length)
    return torch.round(torch.clamp(x / torch.clamp(scale, min=1e-8) * bnt, -bnt, bnt))


class _QdqSTE(torch.autograd.Function):
    """Quant-dequant with the straight-through gradient
    (FakeQuantDequantGrad): the identity for ``x``, none for the scale."""

    @staticmethod
    def forward(ctx, x, scale, bit_length):
        return _qdq(x, scale, bit_length)

    @staticmethod
    def backward(ctx, gy):
        return gy, None, None


def _moving(cur, in_scale, in_state, in_accum, moving_rate, is_test):
    """The moving-average abs-max observer of the current abs-max ``cur``:
    ``(scale, state, accum)``."""
    if is_test:
        return in_scale.reshape(()), in_state, in_accum
    state = in_state * moving_rate + 1.0
    accum = in_accum * moving_rate + cur
    return (accum / torch.clamp(state, min=1e-8)).reshape(()), state, accum


@register_op("fake_quantize_abs_max", num_outputs=2)
def fake_quantize_abs_max(x, *, bit_length=8):
    """``(grid values, scale)``: the rounded integers as floats, like the
    reference's Out tensor."""
    scale = _abs_max(x)
    return _grid(x, scale, bit_length), scale


@register_op("fake_quantize_dequantize_abs_max", num_outputs=2)
def fake_quantize_dequantize_abs_max(x, *, bit_length=8):
    """Quant-dequant with the dynamic abs-max scale, straight through."""
    scale = _abs_max(x).detach()
    return _QdqSTE.apply(x, scale, bit_length), scale


@register_op("fake_quantize_range_abs_max", num_outputs=2)
def fake_quantize_range_abs_max(x, in_scale, *, bit_length=8, window_size=10000, is_test=False):
    """The scale is the stored one under ``is_test``, else the larger of it
    and the current abs-max (the window folded to its steady state)."""
    scale = (in_scale.reshape(()) if is_test
             else torch.maximum(_abs_max(x), in_scale.reshape(())))
    return _grid(x, scale, bit_length), scale


@register_op("fake_quantize_moving_average_abs_max", num_outputs=4)
def fake_quantize_moving_average_abs_max(x, in_scale, in_state, in_accum, *, bit_length=8,
                                         moving_rate=0.9, is_test=False):
    """The QAT activation quantizer's grid values on the moving-average
    scale: ``(out, out_scale, out_state, out_accum)``."""
    scale, state, accum = _moving(_abs_max(x), in_scale, in_state, in_accum, moving_rate, is_test)
    return _grid(x, scale, bit_length), scale, state, accum


@register_op("fake_quantize_dequantize_moving_average_abs_max", num_outputs=4)
def fake_quantize_dequantize_moving_average_abs_max(x, in_scale, in_state, in_accum, *,
                                                    bit_length=8, moving_rate=0.9,
                                                    is_test=False):
    """Quant-dequant on the moving-average scale, straight through."""
    scale, state, accum = _moving(_abs_max(x).detach(), in_scale, in_state, in_accum,
                                  moving_rate, is_test)
    return _QdqSTE.apply(x, scale, bit_length), scale, state, accum


def _channel_shape(x, quant_axis):
    shape = [1] * x.dim()
    shape[quant_axis] = -1
    return shape


@register_op("fake_channel_wise_quantize_abs_max", num_outputs=2)
def fake_channel_wise_quantize_abs_max(x, *, bit_length=8, quant_axis=0):
    """Per-channel abs-max grid values and ``scales [C]``."""
    scale = _abs_max(x, tuple(d for d in range(x.dim()) if d != quant_axis))
    return _grid(x, scale.reshape(_channel_shape(x, quant_axis)), bit_length), scale


@register_op("fake_channel_wise_quantize_dequantize_abs_max", num_outputs=2)
def fake_channel_wise_quantize_dequantize_abs_max(x, *, bit_length=8, quant_axis=0):
    """Per-channel quant-dequant (the QAT weight quantizer), straight
    through."""
    scale = _abs_max(x, tuple(d for d in range(x.dim()) if d != quant_axis)).detach()
    return _QdqSTE.apply(x, scale.reshape(_channel_shape(x, quant_axis)), bit_length), scale


@register_op("moving_average_abs_max_scale", num_outputs=4)
def moving_average_abs_max_scale(x, in_scale, in_state, in_accum, *, moving_rate=0.9,
                                 is_test=False):
    """The scale observer alone: ``(x, out_scale, out_state, out_accum)``."""
    scale, state, accum = _moving(_abs_max(x), in_scale, in_state, in_accum, moving_rate, is_test)
    return x, scale, state, accum


@register_op("fake_dequantize_max_abs")
def fake_dequantize_max_abs(x, scale, *, max_range):
    """``fake_dequantize_op.cc``: ``x * scale / max_range``."""
    return x * scale.reshape(()) / float(max_range)


@register_op("fake_channel_wise_dequantize_max_abs")
def fake_channel_wise_dequantize_max_abs(x, scale, *, quant_bits=(8,), quant_axis=0):
    return x * scale.reshape(_channel_shape(x, quant_axis)) / _bnt(quant_bits[0])


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


# the int8 products' shape rules: the wrapper raises on ``meta`` tensors, so
# shape inference takes the float product of the same shapes


@register_shape("matmul_int8")
def _matmul_int8_shape(x, y, *, transpose_x=False, transpose_y=False, **kw):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x.float(), y.float())


@register_shape("mul_int8")
def _mul_int8_shape(x, y, *, x_num_col_dims=1, y_num_col_dims=1, **kw):
    lead, tail = tuple(x.shape[:x_num_col_dims]), tuple(y.shape[y_num_col_dims:])
    return torch.empty(lead + tail, dtype=torch.float32, device=x.device)
