"""The VGG family (``paddle_tpu/models/vgg.py``).

Reference parity: python/paddle/incubate/hapi/vision/models/vgg.py. The
JAX model's layer names (``features.<i>``, ``classifier.<i>``), so a
``paddle_tpu`` state dict loads by name (``convert.vgg_state_from_numpy``).
The max pools go through ``F.max_pool2d``, whose backward is the
hand-written kernel under ``FLAGS_use_pallas_pool_bwd``. Random init draws
from ``generator``; the dropout masks from the input's device's default
generator.
"""
from __future__ import annotations

from ..nn import functional as F
from ..nn.layer_base import Layer
from ..nn.layers import (
    AdaptiveAvgPool2D,
    BatchNorm2D,
    Conv2D,
    Dropout,
    Linear,
    MaxPool2D,
    Sequential,
)

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_features(cfg, batch_norm, generator):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
            continue
        layers.append(Conv2D(in_c, v, 3, padding=1, generator=generator))
        if batch_norm:
            layers.append(BatchNorm2D(v))
        layers.append(_ReLU())
        in_c = v
    return Sequential(*layers)


class _ReLU(Layer):
    def forward(self, x):
        return F.relu(x)


class VGG(Layer):
    """hapi/vision/models/vgg.py VGG."""

    def __init__(self, cfg="D", num_classes=1000, batch_norm=False,
                 dropout=0.5, generator=None):
        super().__init__()
        self.features = _make_features(_CFGS[cfg], batch_norm, generator)
        self.avgpool = AdaptiveAvgPool2D((7, 7))
        self.classifier = Sequential(
            Linear(512 * 7 * 7, 4096, generator=generator), _ReLU(), Dropout(dropout),
            Linear(4096, 4096, generator=generator), _ReLU(), Dropout(dropout),
            Linear(4096, num_classes, generator=generator),
        )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(F.flatten(x, 1))


def vgg11(**kw):
    return VGG("A", **kw)


def vgg13(**kw):
    return VGG("B", **kw)


def vgg16(**kw):
    return VGG("D", **kw)


def vgg19(**kw):
    return VGG("E", **kw)
