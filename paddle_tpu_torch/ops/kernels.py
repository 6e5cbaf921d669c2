"""Op kernels of the static programs the port serves and trains (``paddle_tpu/ops/kernels.py``).

Only the ops those programs hold: the ``mul``/``matmul`` products, the
elementwise arithmetic, ``gelu``, ``relu``, ``square``, ``sqrt``, the sum
and mean reductions, ``layer_norm``, ``reshape``, ``conv2d`` and
``pool2d``, ``softmax``, ``softmax_with_cross_entropy``, ``top_k`` and
``accuracy``; and the ops ``append_backward`` and the static optimizers
append: ``fill_any_like``, ``sum_n``, ``sgd``, ``momentum_update``,
``adam_update`` and ``increment``. Each follows its JAX counterpart's
expression (``layer_norm`` computes mean, biased variance and ``rsqrt`` in
its own tensor ops, scale and bias as a separate multiply and add).
``**kw`` swallows attributes a saved op carries that the kernel does not
read, as the JAX kernels do. Every kernel is differentiable by torch's
autograd, which is how the executor evaluates a ``grad::<type>`` op.
"""
from __future__ import annotations

import math

import torch

from .registry import register_op

__all__ = []


@register_op("elementwise_add")
def elementwise_add(x, y, **kw):
    return torch.add(x, y)


@register_op("elementwise_sub")
def elementwise_sub(x, y, **kw):
    return torch.sub(x, y)


@register_op("elementwise_mul")
def elementwise_mul(x, y, **kw):
    return torch.mul(x, y)


@register_op("elementwise_div")
def elementwise_div(x, y, **kw):
    return torch.div(x, y)


@register_op("elementwise_max")
def elementwise_max(x, y, **kw):
    return torch.maximum(x, y)


@register_op("elementwise_min")
def elementwise_min(x, y, **kw):
    return torch.minimum(x, y)


@register_op("square")
def square(x, **kw):
    return torch.square(x)


@register_op("sqrt")
def sqrt(x, **kw):
    return torch.sqrt(x)


def _reduce(fn, x, dim, keep_dim):
    """``fn`` over ``dim`` (an axis, a list of axes, or None for all)."""
    if dim is None:
        out = fn(x)
        return out.reshape((1,) * x.dim()) if keep_dim else out
    dims = tuple(dim) if isinstance(dim, (list, tuple)) else (int(dim),)
    return fn(x, dim=dims, keepdim=keep_dim)


@register_op("reduce_sum")
def reduce_sum(x, *, dim=None, keep_dim=False):
    return _reduce(torch.sum, x, dim, keep_dim)


@register_op("reduce_mean")
def reduce_mean(x, *, dim=None, keep_dim=False):
    return _reduce(torch.mean, x, dim, keep_dim)


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


@register_op("pool2d")
def pool2d(x, *, kernel_size, stride=None, padding=0, pooling_type="max", ceil_mode=False,
           exclusive=True, adaptive=False, data_format="NCHW"):
    """Max pooling through :func:`paddle_tpu_torch.nn.functional.max_pool2d`
    (the one route to the max-pool backward kernel under
    ``FLAGS_use_pallas_pool_bwd``); average pooling as ``kernels.py:838-844``:
    window sums over the zero-padded input, divided by each window's count
    of real taps when ``exclusive`` and the window meets padding, else by
    the window's size."""
    from ..errors import UnimplementedError
    from ..nn import functional as F

    if adaptive:
        raise UnimplementedError("pool2d: adaptive pooling is not ported")
    if pooling_type == "max":
        return F.max_pool2d(x, kernel_size, stride, padding, ceil_mode, data_format)
    ks = F._pair(kernel_size)
    st = F._pair(stride) if stride is not None else ks
    p = F._pair(padding)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    extra = F._ceil_extra(x.shape[2:], ks, st, p, ceil_mode)
    pads = (p[1], p[1] + extra[1], p[0], p[0] + extra[0])

    def window_sums(t):
        return torch.nn.functional.avg_pool2d(torch.nn.functional.pad(t, pads), ks, st,
                                              divisor_override=1)

    summed = window_sums(x)
    if exclusive and (p != (0, 0) or ceil_mode):
        out = summed / window_sums(torch.ones_like(x))
    else:
        out = summed / (ks[0] * ks[1])
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


@register_op("softmax")
def softmax(x, *, axis=-1):
    return torch.softmax(x, dim=axis)


@register_op("softmax_with_cross_entropy")
def softmax_with_cross_entropy(logits, label, *, soft_label=False, axis=-1, ignore_index=-100):
    """``-log_softmax(logits)`` at the hard ``label`` (0 where it is
    ``ignore_index``), the class axis kept with size 1; with
    ``soft_label``, ``-sum(label * log_softmax(logits))``
    (``kernels.py:1076-1092``)."""
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        return -torch.sum(label * logp, dim=axis, keepdim=True)
    lbl = label.squeeze(axis) if label.dim() == logits.dim() else label
    idx = lbl.clamp_min(0).unsqueeze(axis).to(torch.int64)
    loss = -torch.gather(logp, axis, idx)
    return torch.where((lbl != ignore_index).unsqueeze(axis), loss, torch.zeros_like(loss))


@register_op("top_k", num_outputs=2)
def top_k(x, *, k, axis=-1, largest=True, sorted=True):
    """The ``k`` largest (or smallest) entries along ``axis`` and their int64
    indices, the lower index first among equal values, as ``lax.top_k``
    orders them: a stable sort (``torch.topk`` promises no order among
    ties on the card)."""
    vals, idx = torch.sort(x.movedim(axis, -1), dim=-1, descending=largest, stable=True)
    k = int(k)
    return vals[..., :k].movedim(-1, axis), idx[..., :k].movedim(-1, axis).to(torch.int64)


@register_op("accuracy")
def accuracy(pred_topk_idx, label, **kw):
    """The share of rows whose label is among their top-k indices, float32."""
    lbl = label if label.dim() == pred_topk_idx.dim() else label[:, None]
    correct = torch.any(pred_topk_idx == lbl, dim=-1)
    return torch.mean(correct.to(torch.float32))


# -- the ops append_backward and the static optimizers append ------------------


@register_op("fill_any_like")
def fill_any_like(x, *, value):
    return torch.full_like(x, value)


@register_op("sum_n")
def sum_n(*xs, **kw):
    """Gradient accumulation: the inputs added left to right."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register_op("sgd")
def sgd_update(param, grad, lr, **kw):
    return param - lr * grad


@register_op("momentum_update", num_outputs=2)
def momentum_update(param, grad, velocity, lr, *, mu=0.9, use_nesterov=False):
    """The plain expression (the JAX package's static op is plain too,
    ``kernels.py:1349``): ``v = mu * v + g``, then ``p - lr * v`` (Nesterov
    ``p - lr * (g + mu * v)``)."""
    v = mu * velocity + grad
    if use_nesterov:
        return param - lr * (grad + mu * v), v
    return param - lr * v, v


def _one_minus_pow(beta, t):
    """``1 - beta**t`` in float32 for a float32 step ``t``: on the CPU
    torch's float32 ``pow``, the JAX CPU step's arithmetic; on the card
    the power in float64 rounded once (``optimizer._bias_correction``),
    since CUDA's float32 ``pow`` rounds otherwise at some ``t``."""
    if t.device.type == "cpu":
        return 1 - torch.full((), beta, dtype=torch.float32) ** t
    from ..optimizer import _bias_correction

    return _bias_correction(beta, t)


@register_op("adam_update", num_outputs=3)
def adam_update(param, grad, moment1, moment2, lr, step, *, beta1=0.9, beta2=0.999,
                epsilon=1e-8):
    """``kernels.py:1357-1367``; ``step`` is the float32 count the
    ``increment`` before it advanced."""
    m = beta1 * moment1 + (1 - beta1) * grad
    v = beta2 * moment2 + (1 - beta2) * grad * grad
    t = step.to(param.dtype)
    mhat = m / _one_minus_pow(beta1, t)
    vhat = v / _one_minus_pow(beta2, t)
    return param - lr * mhat / (torch.sqrt(vhat) + epsilon), m, v


@register_op("increment")
def increment(x, *, value=1.0):
    return torch.add(x, value)
