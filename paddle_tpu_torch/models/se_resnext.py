"""SE-ResNeXt (``paddle_tpu/models/se_resnext.py``).

Reference parity: the dist_se_resnext.py fixture
(python/paddle/fluid/tests/unittests/dist_se_resnext.py). The JAX model's
layer names, so a ``paddle_tpu`` state dict loads by name. Its grouped 3x3
convs stay on the port's ``Conv2D`` with batch norm and relu apart, as in
the JAX model (no ``fused_conv_bn_relu``: its kernels take ``groups == 1``
only). Random init draws from ``generator``.
"""
from __future__ import annotations

from ..nn import functional as F
from ..nn.layer_base import Layer
from ..nn.layers import (
    AdaptiveAvgPool2D,
    BatchNorm2D,
    Conv2D,
    Linear,
    MaxPool2D,
    Sequential,
)

__all__ = ["SEResNeXt", "se_resnext50_32x4d", "se_resnext101_32x4d"]


class _ConvBN(Layer):
    def __init__(self, in_c, out_c, k, stride=1, groups=1, act=True, generator=None):
        super().__init__()
        self.conv = Conv2D(in_c, out_c, k, stride=stride,
                           padding=(k - 1) // 2, groups=groups,
                           bias_attr=False, generator=generator)
        self.bn = BatchNorm2D(out_c)
        self._act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self._act else x


class _SEBlock(Layer):
    """Squeeze-and-excitation gate (dist_se_resnext.py squeeze_excitation)."""

    def __init__(self, channels, reduction=16, generator=None):
        super().__init__()
        self.pool = AdaptiveAvgPool2D((1, 1))
        self.fc1 = Linear(channels, channels // reduction, generator=generator)
        self.fc2 = Linear(channels // reduction, channels, generator=generator)

    def forward(self, x):
        s = F.flatten(self.pool(x), 1)
        s = F.sigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s.reshape(x.shape[0], x.shape[1], 1, 1)


class _SEResNeXtBottleneck(Layer):
    expansion = 2

    def __init__(self, in_c, planes, stride=1, cardinality=32,
                 downsample=None, reduction=16, generator=None):
        super().__init__()
        out_c = planes * self.expansion
        self.conv1 = _ConvBN(in_c, planes, 1, generator=generator)
        self.conv2 = _ConvBN(planes, planes, 3, stride=stride,
                             groups=cardinality, generator=generator)
        self.conv3 = _ConvBN(planes, out_c, 1, act=False, generator=generator)
        self.se = _SEBlock(out_c, reduction, generator=generator)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.se(self.conv3(self.conv2(self.conv1(x))))
        return F.relu(out + identity)


class SEResNeXt(Layer):
    def __init__(self, layers=(3, 4, 6, 3), cardinality=32, base_width=4,
                 num_classes=1000, generator=None):
        super().__init__()
        self.cardinality = cardinality
        width = cardinality * base_width  # 128 for 32x4d
        self.stem = _ConvBN(3, 64, 7, stride=2, generator=generator)
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.in_c = 64
        stages = []
        planes = width
        for i, n in enumerate(layers):
            stride = 1 if i == 0 else 2
            stages.append(self._make_stage(planes, n, stride, generator))
            planes *= 2
        self.stages = Sequential(*stages)
        self.pool = AdaptiveAvgPool2D((1, 1))
        self.fc = Linear(self.in_c, num_classes, generator=generator)

    def _make_stage(self, planes, blocks, stride, generator=None):
        out_c = planes * _SEResNeXtBottleneck.expansion
        downsample = None
        if stride != 1 or self.in_c != out_c:
            downsample = _ConvBN(self.in_c, out_c, 1, stride=stride,
                                 act=False, generator=generator)
        layers = [_SEResNeXtBottleneck(
            self.in_c, planes, stride, self.cardinality, downsample, generator=generator
        )]
        self.in_c = out_c
        for _ in range(blocks - 1):
            layers.append(_SEResNeXtBottleneck(
                self.in_c, planes, 1, self.cardinality, generator=generator
            ))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.stem(x))
        x = self.pool(self.stages(x))
        return self.fc(F.flatten(x, 1))


def se_resnext50_32x4d(**kw):
    return SEResNeXt((3, 4, 6, 3), **kw)


def se_resnext101_32x4d(**kw):
    return SEResNeXt((3, 4, 23, 3), **kw)
