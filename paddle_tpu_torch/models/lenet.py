"""LeNet-5 for MNIST (``paddle_tpu/models/lenet.py``).

The dygraph model of ``BASELINE.json``'s first config: conv 6 @ 3x3
(padding 1), relu, max-pool 2/2; conv 16 @ 5x5, relu, max-pool 2/2; fc 120,
relu, fc 84, relu, fc 10. Its sublayers carry the JAX model's names
(``features.0``, ``features.3``, ``fc.1``, ``fc.3``, ``fc.5``), so a
``paddle_tpu`` state dict loads by name. The static program of the same
net is built from ``nets.simple_img_conv_pool`` and ``static.nn.fc``.
"""
from __future__ import annotations

from torch import nn

from ..nn import functional as F
from ..nn.layers import Conv2D, Flatten, Linear, MaxPool2D, Sequential

__all__ = ["LeNet"]


class LeNet(nn.Module):
    def __init__(self, num_classes=10, generator=None):
        super().__init__()
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, generator=generator),
            _Act("relu"),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, generator=generator),
            _Act("relu"),
            MaxPool2D(2, 2),
        )
        self.fc = Sequential(
            Flatten(),
            Linear(400, 120, generator=generator),
            _Act("relu"),
            Linear(120, 84, generator=generator),
            _Act("relu"),
            Linear(84, num_classes, generator=generator),
        )

    def forward(self, x):
        return self.fc(self.features(x))


class _Act(nn.Module):
    def __init__(self, name):
        super().__init__()
        self._fn = getattr(F, name)

    def forward(self, x):
        return self._fn(x)
