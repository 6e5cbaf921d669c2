"""Layers (``paddle_tpu/nn/layers.py``).

Each is a :class:`~paddle_tpu_torch.nn.layer_base.Layer` (a
``torch.nn.Module``) with Paddle's attribute names and parameter layouts,
so a ``paddle_tpu`` state dict loads by name: ``Linear.weight`` is
``[in_features, out_features]`` as in Paddle (not torch's ``[out, in]``),
``Conv2D.weight`` is OIHW in both data formats, ``Conv2DTranspose.weight``
IOHW, and the batch norms keep their running statistics in the buffers
``_mean`` and ``_variance``. Forwards go through
:mod:`paddle_tpu_torch.nn.functional`, so given ``Variable``\\ s in static
mode a layer appends its ops to the program. Random init takes an explicit
``torch.Generator`` (the layer's parameters are then made on its device)
or draws on the default place
(:func:`~paddle_tpu_torch.framework.place.parameter_device`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import ops
from ..flags import flag
from ..framework.place import parameter_device
from ..framework.tensor import Tensor, wrap
from . import functional as F
from . import initializer as I
from .layer_base import Layer

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout", "LayerList", "ParameterList",
           "Sequential", "Conv1D", "Conv2D", "Conv2DTranspose", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm2D",
           "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D", "Flatten",
           "PReLU", "ReLU", "ReLU6", "LeakyReLU", "ELU", "CELU", "SELU", "GELU", "Sigmoid",
           "LogSigmoid", "Tanh", "Hardsigmoid", "Hardswish", "Hardtanh", "Hardshrink",
           "Softshrink", "Softplus", "Softsign", "Swish", "Silu", "Mish", "Tanhshrink",
           "Softmax", "LogSoftmax", "CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
           "BCELoss", "BCEWithLogitsLoss", "NLLLoss", "KLDivLoss", "MarginRankingLoss",
           "Upsample", "PixelShuffle", "Pad2D", "CosineSimilarity", "PairwiseDistance",
           "Bilinear", "SpectralNorm", "Unfold", "Fold", "fused_conv_bn_relu"]


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class Linear(Layer):
    """``weight_attr`` and ``bias_attr``: an initializer or a
    :class:`ParamAttr` draws the tensor from ``generator``; None means
    XavierUniform for the weight and zeros for the bias; ``bias_attr=False``
    leaves the bias out."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None, name=None,
                 generator=None, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(generator=generator, device=device)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform(), **kw)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([out_features], attr=bias_attr, is_bias=True, **kw))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    """The table ``[num_embeddings, embedding_dim]``, drawn by
    ``weight_attr`` or N(0, 1) when it is None, from ``generator``."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, generator=None, device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0), generator=generator, device=device)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False else self.create_parameter(
            self.normalized_shape, attr=weight_attr, default_initializer=I.Constant(1.0),
            device=device))
        self.bias = (None if bias_attr is False else self.create_parameter(
            self.normalized_shape, attr=bias_attr, is_bias=True, device=device))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class Dropout(Layer):
    """``generator`` draws the masks; None means the input's device's
    default generator (``framework.random``)."""

    def __init__(self, p=0.5, mode="upscale_in_train", name=None, generator=None):
        super().__init__()
        self.p = p
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training, mode=self.mode,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


# -- containers (fluid/dygraph/container.py) -----------------------------------------


class Sequential(Layer):
    """Sublayers named ``"0"``, ``"1"``, ... (or as the ``(name, layer)``
    pairs given), called in order."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = layers[0]
        for i, item in enumerate(layers):
            name, layer = item if isinstance(item, tuple) else (str(i), item)
            self.add_sublayer(name, layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        return Sequential(*layers[idx]) if isinstance(idx, slice) else layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or []):
            self.add_sublayer(str(i), layer)

    def append(self, layer):
        self.add_sublayer(str(len(self._modules)), layer)
        return self

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, *args, **kwargs):
        raise NotImplementedError("LayerList is a container; call its sublayers")


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or []:
            self.append(p)

    def append(self, p):
        self.add_parameter(str(len(self._parameters)), p)
        return self

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())


# -- convolutions ---------------------------------------------------------------------


class Conv2D(Layer):
    """OIHW weight, KaimingUniform (``sqrt(6 / fan_in)``) from ``generator``
    unless ``weight_attr`` says; the bias, unless ``bias_attr`` is False,
    uniform in ``1/sqrt(fan_in)``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", generator=None, device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
        self.data_format = data_format
        fan_in = in_channels // groups * kh * kw
        kwg = dict(generator=generator, device=device)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, kh, kw], attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in), **kwg)
        bound = 1.0 / math.sqrt(fan_in)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound), **kwg))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, data_format=self.data_format, **self._attrs)


class Conv1D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, weight_attr=None, bias_attr=None, generator=None, device=None):
        super().__init__()
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
        fan_in = in_channels // groups * kernel_size
        kwg = dict(generator=generator, device=device)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, kernel_size], attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in), **kwg)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True, **kwg))

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, **self._attrs)


class Conv2DTranspose(Layer):
    """IOHW weight (``[in, out // groups, kh, kw]``)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None, bias_attr=None,
                 generator=None, device=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self._attrs = dict(stride=stride, padding=padding, output_padding=output_padding,
                           dilation=dilation, groups=groups)
        kwg = dict(generator=generator, device=device)
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups, kh, kw], attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=in_channels * kh * kw // groups), **kwg)
        self.bias = (None if bias_attr is False else self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True, **kwg))

    def forward(self, x):
        return F.conv2d_transpose(x, self.weight, self.bias, **self._attrs)


# -- normalization ----------------------------------------------------------------------


class _BatchNormBase(Layer):
    """Scale ones, shift zeros; running ``_mean`` zeros and ``_variance``
    ones, blended as ``momentum * running + (1 - momentum) * batch``."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", device=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = "NCHW" if data_format in ("NCHW", "NCL", "NCDHW") else "NHWC"
        self.weight = self.create_parameter([num_features], attr=weight_attr,
                                            default_initializer=I.Constant(1.0), device=device)
        self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True,
                                          device=device)
        dev = parameter_device(device)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self.momentum,
                            epsilon=self.epsilon, data_format=self.data_format)


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


BatchNorm = BatchNorm2D


class SyncBatchNorm(_BatchNormBase):
    """On one card, the batch norm of the local batch (the JAX package's
    computes over the global batch under data parallelism, which the port
    has no mesh for yet)."""


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_channels], attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias, self.epsilon)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-5, weight_attr=None, bias_attr=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_features], attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, self.weight, self.bias, self.epsilon)


# -- pooling and shape ----------------------------------------------------------------


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, data_format="NCHW"):
        super().__init__()
        self._attrs = dict(kernel_size=kernel_size, stride=stride, padding=padding,
                           ceil_mode=ceil_mode, data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, **self._attrs)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
                 data_format="NCHW"):
        super().__init__()
        self._attrs = dict(kernel_size=kernel_size, stride=stride, padding=padding,
                           ceil_mode=ceil_mode, exclusive=exclusive, data_format=data_format)

    def forward(self, x):
        return F.avg_pool2d(x, **self._attrs)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, data_format=self.data_format)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, data_format=self.data_format)


class Flatten(Layer):
    """Axes ``start_axis`` to ``stop_axis`` merged into one (by default all
    but the batch axis)."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


# -- activations as layers -------------------------------------------------------------


def _act_layer(name, fn_name, **defaults):
    def __init__(self, **kwargs):
        Layer.__init__(self)
        for k, v in defaults.items():
            setattr(self, k, kwargs.get(k, v))

    def forward(self, x):
        return getattr(F, fn_name)(x, **{k: getattr(self, k) for k in defaults})

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__,
                                 "__doc__": f"``F.{fn_name}`` as a layer."})


ReLU = _act_layer("ReLU", "relu")
ReLU6 = _act_layer("ReLU6", "relu6")
LeakyReLU = _act_layer("LeakyReLU", "leaky_relu", negative_slope=0.01)
ELU = _act_layer("ELU", "elu", alpha=1.0)
CELU = _act_layer("CELU", "celu", alpha=1.0)
SELU = _act_layer("SELU", "selu")
GELU = _act_layer("GELU", "gelu", approximate=False)
Sigmoid = _act_layer("Sigmoid", "sigmoid")
LogSigmoid = _act_layer("LogSigmoid", "log_sigmoid")
Tanh = _act_layer("Tanh", "tanh")
Hardsigmoid = _act_layer("Hardsigmoid", "hardsigmoid")
Hardswish = _act_layer("Hardswish", "hardswish")
Hardtanh = _act_layer("Hardtanh", "hardtanh", min=-1.0, max=1.0)
Hardshrink = _act_layer("Hardshrink", "hardshrink", threshold=0.5)
Softshrink = _act_layer("Softshrink", "softshrink", threshold=0.5)
Softplus = _act_layer("Softplus", "softplus", beta=1.0, threshold=20.0)
Softsign = _act_layer("Softsign", "softsign")
Swish = _act_layer("Swish", "swish")
Silu = _act_layer("Silu", "silu")
Mish = _act_layer("Mish", "mish")
Tanhshrink = _act_layer("Tanhshrink", "tanh_shrink")
Softmax = _act_layer("Softmax", "softmax", axis=-1)
LogSoftmax = _act_layer("LogSoftmax", "log_softmax", axis=-1)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None):
        super().__init__()
        self.weight = self.create_parameter([num_parameters], attr=weight_attr,
                                            default_initializer=I.Constant(init))

    def forward(self, x):
        w = self.weight
        if w.shape[0] > 1:
            shape = [1] * len(x.shape)
            shape[1] = w.shape[0]
            w = ops.reshape(w, shape)
        return F.prelu(x, w)


# -- losses (paddle/nn/layer/loss.py) ---------------------------------------------------


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean", soft_label=False,
                 axis=-1, use_softmax=True):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self.weight, soft_label=self.soft_label,
                               axis=self.axis, ignore_index=self.ignore_index,
                               reduction=self.reduction, use_softmax=self.use_softmax)


class _Loss(Layer):
    """A loss of ``F``: ``forward(*inputs)`` calls :attr:`fn` with the
    layer's options."""

    fn = None
    options = ()

    def forward(self, *inputs):
        return getattr(F, self.fn)(*inputs, **{k: getattr(self, k) for k in self.options})


class MSELoss(_Loss):
    fn, options = "mse_loss", ("reduction",)

    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction


class L1Loss(_Loss):
    fn, options = "l1_loss", ("reduction",)

    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction


class SmoothL1Loss(_Loss):
    fn, options = "smooth_l1_loss", ("reduction", "delta")

    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self.reduction, self.delta = reduction, delta


class BCELoss(_Loss):
    fn, options = "binary_cross_entropy", ("reduction",)

    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction


class BCEWithLogitsLoss(_Loss):
    fn, options = "binary_cross_entropy_with_logits", ("reduction", "pos_weight")

    def __init__(self, reduction="mean", pos_weight=None):
        super().__init__()
        self.reduction, self.pos_weight = reduction, pos_weight


class NLLLoss(_Loss):
    fn, options = "nll_loss", ("reduction", "ignore_index")

    def __init__(self, reduction="mean", ignore_index=-100):
        super().__init__()
        self.reduction, self.ignore_index = reduction, ignore_index


class KLDivLoss(_Loss):
    fn, options = "kl_div", ("reduction",)

    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction


class MarginRankingLoss(_Loss):
    fn, options = "margin_ranking_loss", ("margin", "reduction")

    def __init__(self, margin=0.0, reduction="mean"):
        super().__init__()
        self.margin, self.reduction = margin, reduction


# -- the rest ----------------------------------------------------------------------------


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest", align_corners=False):
        super().__init__()
        self._attrs = dict(size=size, scale_factor=scale_factor, mode=mode,
                           align_corners=align_corners)

    def forward(self, x):
        return F.interpolate(x, **self._attrs)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor)


class Pad2D(Layer):
    """``padding`` ``[left, right, top, bottom]`` (or one int) over the
    spatial axes of NCHW."""

    def __init__(self, padding, mode="constant", value=0.0):
        super().__init__()
        if isinstance(padding, int):
            padding = [padding] * 4
        left, right, top, bottom = padding
        self.paddings = [0, 0, 0, 0, top, bottom, left, right]
        self.mode = mode
        self.value = value

    def forward(self, x):
        return ops.pad(x, self.paddings, mode=self.mode, value=self.value)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self._axis, self._eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self._axis, eps=self._eps)


class PairwiseDistance(Layer):
    """``||x - y + epsilon||_p`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False):
        super().__init__()
        self._p, self._eps, self._keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        d = ops.add(ops.subtract(x, y), self._eps)
        return ops.p_norm(d, self._p, -1, self._keepdim, epsilon=0.0)


class Bilinear(Layer):
    """``out_k = x1 @ W_k @ x2 + b_k`` (``bilinear_tensor_product_op.cc``)."""

    def __init__(self, in1_features, in2_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter([out_features, in1_features, in2_features],
                                            attr=weight_attr,
                                            default_initializer=I.XavierUniform())
        self.bias = (None if bias_attr is False else
                     self.create_parameter([out_features], attr=bias_attr, is_bias=True))

    def forward(self, x1, x2):
        out = ops.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        return out if self.bias is None else ops.add(out, self.bias)


class SpectralNorm(Layer):
    """A weight divided by its largest singular value, estimated by power
    iteration from the buffers ``weight_u`` and ``weight_v`` (drawn as
    the JAX package draws them, from numpy's seed 0)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12):
        super().__init__()
        self._dim, self._iters, self._eps = dim, power_iters, eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        rng = np.random.RandomState(0)
        dev = parameter_device()
        self.register_buffer("weight_u", torch.as_tensor(
            (rng.randn(h) / np.sqrt(h)).astype("float32"), device=dev))
        self.register_buffer("weight_v", torch.as_tensor(
            (rng.randn(w) / np.sqrt(w)).astype("float32"), device=dev))

    def forward(self, weight):
        return ops._run("spectral_norm", weight, self.weight_u, self.weight_v, dim=self._dim,
                        power_iters=self._iters, eps=self._eps)


class Unfold(Layer):
    """im2col: ``[N, C, H, W]`` -> ``[N, C*kh*kw, L]``."""

    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self._attrs = dict(kernel_sizes=kernel_sizes, strides=strides, paddings=paddings,
                           dilations=dilations)

    def forward(self, x):
        return F.unfold(x, **self._attrs)


class Fold(Layer):
    """col2im, the inverse of :class:`Unfold`: overlapping patches summed
    back into ``[N, C, H, W]``."""

    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self._attrs = dict(output_sizes=output_sizes, kernel_sizes=kernel_sizes,
                           strides=strides, paddings=paddings, dilations=dilations)

    def forward(self, x):
        return ops._run("fold", x, **self._attrs)


def fused_conv_bn_relu(conv, bn, x):
    """``relu(bn(conv(x)))``, through the fused kernels
    (``FLAGS_use_fused_conv_bn``, ``ops/cuda/conv_bn_relu.py``) when the
    triple is admissible as ``paddle_tpu/nn/layers.py:205-210`` admits it:
    a bias-free, ungrouped, undilated :class:`Conv2D` feeding a batch norm
    of the same layout, on tensors (a static ``Variable`` appends the three
    ops). In training the running statistics are blended into ``bn``'s
    buffers in place, as :func:`~paddle_tpu_torch.nn.functional.batch_norm`
    does."""
    attrs = conv._attrs
    if (flag("use_fused_conv_bn") and isinstance(x, torch.Tensor) and conv.bias is None
            and attrs["groups"] == 1 and _pair(attrs["dilation"]) == (1, 1)
            and isinstance(bn, _BatchNormBase)
            and bn.data_format == ("NCHW" if conv.data_format == "NCHW" else "NHWC")):
        from ..amp import _enabled as _amp_scope
        from ..ops.cuda import conv_bn_relu as cbr

        # as the unfused path autocasts the conv (a white op) and not the
        # batch norm: x and the weight take the AMP dtype, gamma, beta and
        # the running statistics stay f32 (paddle_tpu/nn/layers.py:214-228)
        weight = conv.weight
        scope = _amp_scope()
        given = x
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
        return wrap(y) if isinstance(given, Tensor) else y
    return F.relu(bn(conv(x)))
