"""Fused registry ops, the IR optimizer's rewrite targets (``paddle_tpu/ops/fused_ops.py``).

``analysis/optimizer.py``'s fusion passes rewrite a ``conv2d ->
batch_norm -> relu`` chain onto ``fused_conv_bn_relu`` and a residual
``elementwise_add -> layer_norm`` onto ``fused_layernorm_residual``; the
layer helpers never append these ops themselves. Each is a registry entry
over the hand-written kernel's wrapper: ``ops/cuda/conv_bn_relu.py`` ``conv_bn_relu``
(the fused conv GEMM with the batch-norm affine and relu in its epilogue)
and ``ops/cuda/layernorm_residual.py`` ``layernorm_residual``. As every
wrapper does, they launch the kernel for a CUDA tensor, run the kernel's
plain version for a CPU tensor, and raise on any other device (``meta``
included), so a shape rule beside each gives static shape inference their
outputs. The int8 chains rewrite onto the registered ``matmul_int8`` and
``mul_int8`` (``quantize_kernels.py``) and need no entry here.
"""
from __future__ import annotations

import torch

from .cuda.conv_bn_relu import conv_bn_relu
from .cuda.layernorm_residual import layernorm_residual
from .registry import kernel, register_op, register_shape

__all__ = []


@register_op("fused_conv_bn_relu", num_outputs=3)
def fused_conv_bn_relu(x, weight, scale, bias, mean, var, *, stride=1, padding=0, momentum=0.9,
                       epsilon=1e-5, training=False, data_format="NCHW"):
    """``relu(batch_norm(conv2d(x, weight)))`` as one registry op.

    Returns ``(y, new_running_mean, new_running_var)``, the output structure
    of the ``batch_norm`` op: the optimizer keeps the statistics' output
    names and their ``__inplace__`` aliasing, so the executor writes them
    back as it did. The conv is bias-free, ungrouped and undilated (the
    fusion pass rewrites only such chains)."""
    return conv_bn_relu(x, weight, scale, bias, mean, var, stride=stride, padding=padding,
                        epsilon=float(epsilon), momentum=float(momentum),
                        training=bool(training), data_format=data_format)


@register_shape("fused_conv_bn_relu")
def _fused_conv_bn_relu_shape(x, weight, scale, bias, mean, var, *, stride=1, padding=0,
                              momentum=0.9, epsilon=1e-5, training=False, data_format="NCHW"):
    co = kernel("conv2d")(x, weight, stride=stride, padding=padding, data_format=data_format)
    return kernel("batch_norm")(co, scale, bias, mean, var, momentum=momentum, epsilon=epsilon,
                                training=training, data_format=data_format)


@register_op("fused_layernorm_residual")
def fused_layernorm_residual(x, residual, scale, bias, *, epsilon=1e-5):
    """``LayerNorm(x + residual)`` over the last dimension as one registry
    op: the sum of ``elementwise_add`` -> ``layer_norm`` with a trailing
    ``[H]`` scale and bias, without the sum's round trip through memory."""
    return layernorm_residual(x, residual, scale, bias, float(epsilon))


@register_shape("fused_layernorm_residual")
def _fused_layernorm_residual_shape(x, residual, scale, bias, *, epsilon=1e-5):
    return torch.empty_like(x)
