"""The ResNet family (``paddle_tpu/models/resnet.py``).

The JAX package's attribute names, so a ``paddle_tpu`` state dict loads
by name (``layer1.0.downsample.1._mean``), and its parameter order, so
optimizer accumulators index alike. In every block the conv -> bn -> relu
triples go through :func:`~paddle_tpu_torch.nn.layers.fused_conv_bn_relu`
(the stem, ``conv1``/``bn1`` of each block and ``conv2``/``bn2`` of each
bottleneck: 33 on ResNet-50); the last bn of a block feeds the residual
add and the downsample's bn none, so both stay unfused. The stride sits
on the bottleneck's 3x3 conv (ResNet v1.5). Weights are OIHW in both data
formats; random init draws from ``generator``.
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
    fused_conv_bn_relu,
)

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, data_format="NCHW",
                 generator=None):
        super().__init__()
        kw = dict(bias_attr=False, data_format=data_format, generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1, **kw)
        self.bn1 = BatchNorm2D(planes, data_format=data_format)
        self.conv2 = Conv2D(planes, planes, 3, padding=1, **kw)
        self.bn2 = BatchNorm2D(planes, data_format=data_format)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = fused_conv_bn_relu(self.conv1, self.bn1, x)
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, data_format="NCHW",
                 generator=None):
        super().__init__()
        kw = dict(bias_attr=False, data_format=data_format, generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 1, **kw)
        self.bn1 = BatchNorm2D(planes, data_format=data_format)
        self.conv2 = Conv2D(planes, planes, 3, stride=stride, padding=1, **kw)
        self.bn2 = BatchNorm2D(planes, data_format=data_format)
        self.conv3 = Conv2D(planes, planes * self.expansion, 1, **kw)
        self.bn3 = BatchNorm2D(planes * self.expansion, data_format=data_format)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = fused_conv_bn_relu(self.conv1, self.bn1, x)
        out = fused_conv_bn_relu(self.conv2, self.bn2, out)
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(out + identity)


class ResNet(Layer):
    def __init__(self, block, depth_cfg, num_classes=1000, with_pool=True, data_format="NCHW",
                 generator=None):
        super().__init__()
        self.inplanes = 64
        self.data_format = data_format
        self.conv1 = Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False,
                            data_format=data_format, generator=generator)
        self.bn1 = BatchNorm2D(64, data_format=data_format)
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1, data_format=data_format)
        self.layer1 = self._make_layer(block, 64, depth_cfg[0], 1, generator)
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], 2, generator)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], 2, generator)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], 2, generator)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), data_format=data_format)
        self.num_classes = num_classes
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes, generator=generator)

    def _make_layer(self, block, planes, blocks, stride=1, generator=None):
        kw = dict(data_format=self.data_format, generator=generator)
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride,
                       bias_attr=False, **kw),
                BatchNorm2D(planes * block.expansion, data_format=self.data_format),
            )
        layers = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **kw))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(fused_conv_bn_relu(self.conv1, self.bn1, x))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(F.flatten(x, 1))
        return x


def resnet18(**kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], **kw)


def resnet34(**kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], **kw)


def resnet50(**kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], **kw)


def resnet101(**kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], **kw)


def resnet152(**kw):
    return ResNet(BottleneckBlock, [3, 8, 36, 3], **kw)
