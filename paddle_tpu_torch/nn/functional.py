"""Functional ops (``paddle_tpu/nn/functional.py``).

Every name is mode-aware: given a static ``Variable`` it appends the op
through the dygraph front (:mod:`paddle_tpu_torch.ops`), so a layer's
forward captures into a program; given a tensor it runs eagerly, and
returns a ``Tensor`` when it was given one. The names without an eager
path of their own here are the front's. The eager paths of the serving
and training names below are the port's own:

Paddle's conventions on torch tensors: ``linear`` takes the ``[in, out]``
weight Paddle stores, ``gelu`` is exact (erf), as ``jax.nn.gelu(x,
approximate=False)`` in ``paddle_tpu/ops/kernels.py``; the losses follow
``paddle_tpu/ops/kernels.py:1077-1130`` (``ignore_index`` labels count
nowhere, ``reduction="mean"`` divides by the valid labels). Random ops take
an explicit ``torch.Generator``, by default their device's
(:mod:`paddle_tpu_torch.framework.random`).

The vision ops follow ``paddle_tpu/ops/kernels.py:699-877``: ``conv2d``
takes OIHW weights in both layouts and Paddle's padding forms (an int,
``[ph, pw]``, ``[top, bottom, left, right]``, ``[[top, bottom], [left,
right]]``, ``"SAME"``, ``"VALID"``); ``max_pool2d`` pads with -inf;
``batch_norm`` computes its statistics in its own tensor ops and blends
the running buffers as Paddle does, ``momentum * running + (1 - momentum)
* batch`` with the biased batch variance (``torch.nn.functional.batch_norm``
weights the other way and keeps the unbiased variance, so it never sees
the buffers).

Every op hands its inputs to :func:`~paddle_tpu_torch.framework.autograd.amp_cast`
under the JAX op type's name (``"linear"``, ``"matmul"``, ``"softmax"``,
``"cross_entropy"``, ``"conv2d"``, ...; ``embedding`` is
``"lookup_table"``, ``max_pool2d`` ``"pool2d"``, :func:`mean`
``"reduce_mean"``), so an :func:`paddle_tpu_torch.amp.auto_cast` scope
casts them as the JAX package's dispatcher does; ``layer_norm`` and
``batch_norm`` keep f32 statistics and return their input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from ..flags import flag as _flag
from ..framework import random as _random
from ..framework.autograd import amp_cast
from ..ops.cuda import pool_backward as _pool_backward

from .. import ops as _ops
from ..framework.tensor import Tensor as _Tensor, wrap as _wrap
from ..ops import (  # noqa: F401  (the names with no eager path of their own here)
    accuracy,
    adaptive_max_pool2d,
    avg_pool2d,
    binary_cross_entropy,
    binary_cross_entropy_with_logits,
    celu,
    conv1d,
    conv2d_transpose,
    cosine_similarity,
    elu,
    group_norm,
    hardshrink,
    hardsigmoid,
    hardswish,
    hardtanh,
    instance_norm,
    interpolate,
    kl_div,
    l1_loss,
    leaky_relu,
    log_loss,
    log_sigmoid,
    log_softmax,
    margin_ranking_loss,
    maxout,
    mish,
    mse_loss,
    nll_loss,
    one_hot,
    pad,
    pixel_shuffle,
    prelu,
    relu6,
    selu,
    sigmoid,
    silu,
    smooth_l1_loss,
    softplus,
    softshrink,
    softsign,
    square_error_cost,
    swish,
    tanh_shrink,
    unfold,
    upsample,
)

__all__ = ["linear", "matmul", "mean", "gelu", "relu", "tanh", "softmax", "layer_norm",
           "embedding", "dropout", "gather", "cross_entropy", "softmax_with_cross_entropy",
           "conv2d", "conv_padding", "batch_norm", "max_pool2d", "adaptive_avg_pool2d",
           "flatten", "accuracy", "adaptive_max_pool2d", "avg_pool2d", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "celu", "conv1d", "conv2d_transpose",
           "cosine_similarity", "elu", "group_norm", "hardshrink", "hardsigmoid", "hardswish",
           "hardtanh", "instance_norm", "interpolate", "kl_div", "l1_loss", "leaky_relu",
           "log_loss", "log_sigmoid", "log_softmax", "margin_ranking_loss", "maxout", "mish",
           "mse_loss", "nll_loss", "one_hot", "pad", "pixel_shuffle", "prelu", "relu6", "selu",
           "sigmoid", "silu", "smooth_l1_loss", "softplus", "softshrink", "softsign",
           "square_error_cost", "swish", "tanh_shrink", "unfold", "upsample"]


def _out(y, x):
    """An eager result as a ``Tensor`` when the input was one."""
    return _wrap(y) if isinstance(x, _Tensor) else y


# -- the mode-aware names: a Variable appends the op, a tensor runs eagerly ----------


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with Paddle's ``[in_features, out_features]`` weight."""
    if _ops._static(x):
        return _ops.linear(x, weight, bias)
    return _out(_linear(x, weight, bias), x)


def matmul(x, y, transpose_x=False, transpose_y=False):
    if _ops._static(x):
        return _ops.matmul(x, y, transpose_x, transpose_y)
    return _out(_matmul(x, y, transpose_x, transpose_y), x)


def mean(x, axis=None, keepdim=False):
    if _ops._static(x):
        return _ops.mean(x, axis, keepdim)
    return _out(_mean(x, axis, keepdim), x)


def gelu(x, approximate=False):
    if _ops._static(x):
        return _ops.gelu(x, approximate)
    return _out(_gelu(x, approximate), x)


def relu(x, name_=None):
    if _ops._static(x):
        return _ops.relu(x)
    return _out(_relu(x), x)


def tanh(x, name_=None):
    if _ops._static(x):
        return _ops.tanh(x)
    return _out(_tanh(x), x)


def softmax(x, axis=-1):
    if _ops._static(x):
        return _ops.softmax(x, axis)
    return _out(_softmax(x, axis), x)


def layer_norm(x, normalized_shape=None, weight=None, bias=None, epsilon=1e-5):
    if _ops._static(x):
        return _ops.layer_norm(x, normalized_shape, weight, bias, epsilon)
    if normalized_shape is None:
        normalized_shape = [x.shape[-1]]
    return _out(_layer_norm(x, normalized_shape, weight, bias, epsilon), x)


def embedding(x, weight, padding_idx=None, sparse=False):
    if _ops._static(x):
        return _ops.embedding(x, weight, padding_idx)
    return _out(_embedding(x, weight, padding_idx), x)


def dropout(x, p=0.5, training=True, mode="upscale_in_train", generator=None):
    """Upscale-in-train dropout (the mask from ``generator``, by default
    the device's); identity in eval or at ``p == 0``."""
    if _ops._static(x) or mode != "upscale_in_train":
        return _ops.dropout(x, p, training, mode)
    return _out(_dropout(x, p, training, generator), x)


def gather(x, index, axis=0):
    if _ops._static(x):
        return _ops.gather(x, index, axis)
    return _out(_gather(x, index, axis), x)


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1, ignore_index=-100):
    """Per-example loss with the class axis kept (size 1)."""
    if _ops._static(logits) or soft_label:
        return _ops.softmax_with_cross_entropy(logits, label, soft_label, axis, ignore_index)
    return _out(_softmax_with_cross_entropy(logits, label, axis, ignore_index), logits)


def cross_entropy(input, label, weight=None, soft_label=False, axis=-1, ignore_index=-100,
                  reduction="mean", use_softmax=True):
    """Softmax cross entropy; over hard labels without weights, ``reduction``
    ``"mean"`` divides by the valid labels (at least 1)."""
    if _ops._static(input) or weight is not None or soft_label or not use_softmax:
        return _ops.cross_entropy(input, label, weight, soft_label, axis, ignore_index,
                                  reduction, use_softmax)
    return _out(_cross_entropy(input, label, ignore_index, reduction, axis), input)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    if _ops._static(x):
        return _ops.conv2d(x, weight, bias, stride, padding, dilation, groups, data_format)
    return _out(_conv2d(x, weight, bias, stride, padding, dilation, groups, data_format), x)


def batch_norm(x, running_mean, running_var, weight, bias, training=False, momentum=0.9,
               epsilon=1e-5, data_format="NCHW"):
    if _ops._static(x):
        return _ops.batch_norm(x, running_mean, running_var, weight, bias, training, momentum,
                               epsilon, data_format)
    return _out(_batch_norm(x, running_mean, running_var, weight, bias, training, momentum,
                            epsilon, data_format), x)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, data_format="NCHW"):
    if _ops._static(x):
        return _ops.max_pool2d(x, kernel_size, stride, padding, ceil_mode, data_format)
    return _out(_max_pool2d(x, kernel_size, stride, padding, ceil_mode, data_format), x)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    if _ops._static(x):
        return _ops.adaptive_avg_pool2d(x, output_size, data_format)
    return _out(_adaptive_avg_pool2d(x, output_size, data_format), x)


def flatten(x, start_axis=0, stop_axis=-1):
    if _ops._static(x):
        return _ops.flatten(x, start_axis, stop_axis)
    return _out(_flatten(x, start_axis, stop_axis), x)


# -- the eager implementations ------------------------------------------------------



def _linear(x, weight, bias=None):
    """``x @ weight + bias`` with Paddle's ``[in_features, out_features]`` weight."""
    x, weight, bias = amp_cast("linear", [x, weight, bias])
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def _matmul(x, y, transpose_x=False, transpose_y=False):
    """``x @ y`` with either operand's last two axes swapped first."""
    x, y = amp_cast("matmul", [x, y])
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def _mean(x, axis=None, keepdim=False):
    """The mean over ``axis`` (all axes when None)."""
    (x,) = amp_cast("reduce_mean", [x])
    return x.mean() if axis is None else x.mean(axis, keepdim=keepdim)


def _gelu(x, approximate=False):
    (x,) = amp_cast("gelu", [x])
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def _relu(x):
    return torch.relu(x)


def _tanh(x):
    return torch.tanh(x)


def _softmax(x, axis=-1):
    (x,) = amp_cast("softmax", [x])
    return torch.softmax(x, dim=axis)


def _layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes: f32 statistics,
    the output in ``x``'s dtype (``kernels.py:963``)."""
    x, weight, bias = amp_cast("layer_norm", [x, weight, bias])
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    if x.dtype == torch.float32 and all(p is None or p.dtype == x.dtype for p in (weight, bias)):
        return _F.layer_norm(x, list(normalized_shape), weight, bias, epsilon)
    f32 = [None if p is None else p.float() for p in (x, weight, bias)]
    return _F.layer_norm(f32[0], list(normalized_shape), f32[1], f32[2], epsilon).to(x.dtype)


def _embedding(x, weight, padding_idx=None):
    """Rows of ``weight`` at ``x``; the rows of a ``padding_idx`` (>= 0) are
    zeros and pass no gradient, as the ``lookup_table`` kernel gives them
    (``kernels.py:1012``)."""
    weight, x = amp_cast("lookup_table", [weight, x])
    if padding_idx is None or padding_idx < 0:
        return _F.embedding(x, weight)
    out = _F.embedding(x, weight, padding_idx=padding_idx)
    return out * (x != padding_idx).unsqueeze(-1).to(out.dtype)


def _dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout; identity in eval or at ``p == 0``. The
    mask comes from ``generator`` (default: the device's default
    generator)."""
    if not training or p == 0.0:
        return x  # not dispatched, so not cast, as in the JAX package
    (x,) = amp_cast("dropout", [x])
    keep = _random.draw(x.device, generator, lambda gen: torch.rand(
        x.shape, device=x.device, generator=gen) >= p)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _gather(x, index, axis=0):
    """Rows (or slices along ``axis``) of ``x`` at ``index``
    (``paddle_tpu.ops.gather``)."""
    return torch.index_select(x, axis, index.reshape(-1))


def _picked_logp(logits, label, axis, ignore_index):
    """``-log_softmax(logits)`` at ``label`` (0 where the label is
    ``ignore_index``) and the valid-label mask, labels squeezed."""
    logp = torch.log_softmax(logits, dim=axis)
    lbl = label.squeeze(axis) if label.dim() == logits.dim() else label
    valid = lbl != ignore_index
    picked = torch.gather(logp, axis, lbl.clamp_min(0).unsqueeze(axis).to(torch.int64))
    loss = torch.where(valid.unsqueeze(axis), -picked, torch.zeros_like(picked))
    return loss, valid


def _softmax_with_cross_entropy(logits, label, axis=-1, ignore_index=-100):
    """Per-example loss with the class axis kept (size 1)."""
    logits, label = amp_cast("softmax_with_cross_entropy", [logits, label])
    loss, _ = _picked_logp(logits, label, axis, ignore_index)
    return loss


def _cross_entropy(input, label, ignore_index=-100, reduction="mean", axis=-1):
    """Softmax cross entropy over hard labels; ``reduction`` is ``"mean"``
    (over the valid labels, at least 1), ``"sum"`` or ``"none"``."""
    input, label = amp_cast("cross_entropy", [input, label])
    loss, valid = _picked_logp(input, label, axis, ignore_index)
    loss = loss.squeeze(axis)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)


def _pair(v):
    return tuple(int(a) for a in v) if isinstance(v, (list, tuple)) else (int(v), int(v))


def conv_padding(padding):
    """``[(top, bottom), (left, right)]`` from Paddle's numeric padding
    forms (``kernels.py:708-718``); strings are :func:`conv2d`'s."""
    if isinstance(padding, (list, tuple)):
        if len(padding) == 2 and all(isinstance(q, (list, tuple)) for q in padding):
            return [tuple(int(a) for a in padding[0]), tuple(int(a) for a in padding[1])]
        if len(padding) == 2:
            return [(int(padding[0]),) * 2, (int(padding[1]),) * 2]
        if len(padding) == 4:
            return [(int(padding[0]), int(padding[1])), (int(padding[2]), int(padding[3]))]
        raise ValueError(f"conv2d: padding {padding!r} has no Paddle form")
    return [(int(padding),) * 2] * 2


def _same_padding(hw, kernel, stride, dilation):
    """XLA's ``"SAME"``: the output is ``ceil(in / stride)``, the total
    padding split with the smaller half first."""
    pads = []
    for n, k, s, d in zip(hw, kernel, stride, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
            data_format="NCHW"):
    """2-D convolution with an OIHW ``weight`` for NCHW or NHWC ``x``. A
    ``bias`` of another dtype than the (cast) product is added after it, as
    the JAX package adds it (an f32 bias promotes a bf16 product)."""
    x, weight = amp_cast("conv2d", [x, weight])
    stride, dilation = _pair(stride), _pair(dilation)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"conv2d: padding {padding!r} is neither SAME nor VALID")
        pads = (_same_padding(x.shape[2:], weight.shape[2:], stride, dilation)
                if mode == "SAME" else [(0, 0), (0, 0)])
    else:
        pads = conv_padding(padding)
    (top, bottom), (left, right) = pads
    fused_bias = bias if bias is None or bias.dtype == x.dtype else None
    if top == bottom and left == right:
        y = _F.conv2d(x, weight, fused_bias, stride, (top, left), dilation, groups)
    else:
        y = _F.conv2d(_F.pad(x, (left, right, top, bottom)), weight, fused_bias, stride, 0,
                      dilation, groups)
    if bias is not None and fused_bias is None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def _batch_norm(x, running_mean, running_var, weight, bias, training=False, momentum=0.9,
                epsilon=1e-5, data_format="NCHW"):
    """Batch normalization over every axis but the channel one. In
    training the biased batch statistics normalize ``x`` and are blended
    into the running buffers in place (no gradient flows into them)."""
    x, weight, bias, mean_in, var_in = amp_cast(
        "batch_norm", [x, weight, bias, running_mean, running_var])
    caxis = 1 if data_format in ("NCHW", "NCL", "NCDHW") else x.dim() - 1
    axes = [i for i in range(x.dim()) if i != caxis]
    shape = [1] * x.dim()
    shape[caxis] = -1
    xf = x.float()
    if training:
        mean = xf.mean(axes)
        var = (xf - mean.reshape(shape)).square().mean(axes)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var + (1 - momentum) * var)
    else:
        mean, var = mean_in, var_in
    y = ((xf - mean.reshape(shape)) * torch.rsqrt(var + epsilon).reshape(shape)
         * weight.reshape(shape) + bias.reshape(shape))
    return y.to(x.dtype)


def _max_pool_forward(x, ks, st, p, extra):
    if extra == [0, 0] and p[0] <= ks[0] // 2 and p[1] <= ks[1] // 2:
        return _F.max_pool2d(x, ks, st, p)  # torch's own padding never wins a max
    x = _F.pad(x, (p[1], p[1] + extra[1], p[0], p[0] + extra[0]), value=float("-inf"))
    return _F.max_pool2d(x, ks, st)


class _MaxPoolKernelBackward(torch.autograd.Function):
    """Max pooling whose backward is the hand-written kernel
    (``kernels.py:775-796`` ``_max_pool_fused``)."""

    @staticmethod
    def forward(ctx, x, ks, st, p):
        y = _max_pool_forward(x, ks, st, p, [0, 0])
        ctx.save_for_backward(x, y)
        ctx.geometry = (ks, st, p)
        return y

    @staticmethod
    def backward(ctx, dy):
        # x keeps its layout when it is NCHW or channels-last (the fused
        # stem conv's output); y and dy are brought to it where they differ
        x, y = ctx.saved_tensors
        layout = _pool_backward.memory_layout(x)
        if layout is None:
            x, layout = x.contiguous(), "nchw"
        y, dy = (_pool_backward.to_layout(t, layout) for t in (y, dy.to(y.dtype)))
        dx = _pool_backward.max_pool2d_backward(x, y, dy, *ctx.geometry)
        return dx, None, None, None


def _max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, data_format="NCHW"):
    """Max pooling whose padding is -inf; ``ceil_mode`` pads the far edge
    as ``kernels.py:816-822`` does. With ``FLAGS_use_pallas_pool_bwd`` on,
    an admitted pool (``max_pool_backward_supported``) takes its backward
    from the kernel of ``ops/cuda/pool_backward.py``."""
    (x,) = amp_cast("pool2d", [x])
    ks = _pair(kernel_size)
    st = _pair(stride) if stride is not None else ks
    p = _pair(padding)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    extra = _ceil_extra(x.shape[2:], ks, st, p, ceil_mode)
    if (_flag("use_pallas_pool_bwd") and x.requires_grad and torch.is_grad_enabled()
            and _pool_backward.max_pool_backward_supported(x.shape, x.dtype, extra, data_format)):
        y = _MaxPoolKernelBackward.apply(x, ks, st, p)
    else:
        y = _max_pool_forward(x, ks, st, p, extra)
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def _ceil_extra(spatial, ks, st, p, ceil_mode):
    """Rows and columns ``ceil_mode`` adds at the far edge."""
    extra = [0, 0]
    if ceil_mode:
        for i, (dim, k, s, pp) in enumerate(zip(spatial, ks, st, p)):
            out_ceil = -(-(dim + 2 * pp - k) // s) + 1
            extra[i] = max(0, (out_ceil - 1) * s + k - (dim + 2 * pp))
    return extra


def _adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over the windows ``[floor(i·H/oh), ceil((i+1)·H/oh))``, the
    windows ``kernels.py:851`` takes."""
    if data_format == "NHWC":
        return _F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), output_size).permute(0, 2, 3, 1)
    return _F.adaptive_avg_pool2d(x, output_size)


def _flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis)
