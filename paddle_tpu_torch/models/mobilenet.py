"""MobileNet V1 and V2 (``paddle_tpu/models/mobilenet.py``).

Reference parity: python/paddle/incubate/hapi/vision/models/
mobilenetv1.py / mobilenetv2.py. The JAX model's layer names
(``stem.conv``, ``blocks.<i>.dw.bn``, ``blocks.<i>.project_bn``), so a
``paddle_tpu`` state dict loads by name. The grouped and depthwise convs
stay on the port's ``Conv2D`` with their batch norm and relu apart, as the
JAX model does not call ``fused_conv_bn_relu`` (whose kernels take
``groups == 1`` only). Random init draws from ``generator``.
"""
from __future__ import annotations

from ..nn import functional as F
from ..nn.layer_base import Layer
from ..nn.layers import (
    AdaptiveAvgPool2D,
    BatchNorm2D,
    Conv2D,
    Linear,
    Sequential,
)

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


class _ConvBNReLU(Layer):
    def __init__(self, in_c, out_c, k=3, stride=1, groups=1, relu6=False, generator=None):
        super().__init__()
        self.conv = Conv2D(in_c, out_c, k, stride=stride,
                           padding=(k - 1) // 2, groups=groups,
                           bias_attr=False, generator=generator)
        self.bn = BatchNorm2D(out_c)
        self._relu6 = relu6

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu6(x) if self._relu6 else F.relu(x)


class _DepthwiseSeparable(Layer):
    def __init__(self, in_c, out_c, stride, generator=None):
        super().__init__()
        self.dw = _ConvBNReLU(in_c, in_c, 3, stride, groups=in_c, generator=generator)
        self.pw = _ConvBNReLU(in_c, out_c, 1, generator=generator)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(Layer):
    """hapi/vision/models/mobilenetv1.py."""

    def __init__(self, num_classes=1000, scale=1.0, generator=None):
        super().__init__()
        s = lambda c: max(int(c * scale), 8)  # noqa: E731
        cfg = [
            (s(32), s(64), 1), (s(64), s(128), 2), (s(128), s(128), 1),
            (s(128), s(256), 2), (s(256), s(256), 1), (s(256), s(512), 2),
            *[(s(512), s(512), 1)] * 5,
            (s(512), s(1024), 2), (s(1024), s(1024), 1),
        ]
        self.stem = _ConvBNReLU(3, s(32), 3, stride=2, generator=generator)
        self.blocks = Sequential(
            *[_DepthwiseSeparable(i, o, st, generator) for i, o, st in cfg]
        )
        self.pool = AdaptiveAvgPool2D((1, 1))
        self.fc = Linear(s(1024), num_classes, generator=generator)

    def forward(self, x):
        x = self.pool(self.blocks(self.stem(x)))
        return self.fc(F.flatten(x, 1))


class _InvertedResidual(Layer):
    def __init__(self, in_c, out_c, stride, expand, generator=None):
        super().__init__()
        hidden = in_c * expand
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand != 1:
            layers.append(_ConvBNReLU(in_c, hidden, 1, relu6=True, generator=generator))
        layers.append(
            _ConvBNReLU(hidden, hidden, 3, stride, groups=hidden, relu6=True,
                        generator=generator)
        )
        self.body = Sequential(*layers)
        self.project = Conv2D(hidden, out_c, 1, bias_attr=False, generator=generator)
        self.project_bn = BatchNorm2D(out_c)

    def forward(self, x):
        y = self.project_bn(self.project(self.body(x)))
        return x + y if self.use_res else y


class MobileNetV2(Layer):
    """hapi/vision/models/mobilenetv2.py."""

    def __init__(self, num_classes=1000, scale=1.0, generator=None):
        super().__init__()
        s = lambda c: max(int(c * scale), 8)  # noqa: E731
        # (expand, out, repeats, stride)
        cfg = [
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        self.stem = _ConvBNReLU(3, s(32), 3, stride=2, relu6=True, generator=generator)
        blocks = []
        in_c = s(32)
        for t, c, n, st in cfg:
            for i in range(n):
                blocks.append(
                    _InvertedResidual(in_c, s(c), st if i == 0 else 1, t, generator)
                )
                in_c = s(c)
        self.blocks = Sequential(*blocks)
        self.head = _ConvBNReLU(in_c, s(1280), 1, relu6=True, generator=generator)
        self.pool = AdaptiveAvgPool2D((1, 1))
        self.fc = Linear(s(1280), num_classes, generator=generator)

    def forward(self, x):
        x = self.pool(self.head(self.blocks(self.stem(x))))
        return self.fc(F.flatten(x, 1))


def mobilenet_v1(**kw):
    return MobileNetV1(**kw)


def mobilenet_v2(**kw):
    return MobileNetV2(**kw)
