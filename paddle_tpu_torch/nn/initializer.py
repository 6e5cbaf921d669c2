"""Parameter initializers (``paddle_tpu/nn/initializer.py``) for static programs.

Each draws from the CPU's default generator of
:mod:`paddle_tpu_torch.framework.random` (``seed(value)`` restarts it), so
a program's startup is reproducible; the streams differ from the JAX
package's, so parity tests carry weights across as numpy.
"""
from __future__ import annotations

import math

import torch

from ..framework import random as _random
from ..framework.dtype import torch_dtype

__all__ = ["Initializer", "Constant", "XavierUniform", "KaimingUniform"]


class Initializer:
    def __call__(self, shape, dtype="float32"):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32"):
        return torch.full(tuple(shape), self.value, dtype=torch_dtype(dtype))


def _uniform(shape, dtype, low, high):
    u = torch.rand(tuple(shape), dtype=torch_dtype(dtype), generator=_random.default_generator())
    return u * (high - low) + low


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])  # conv kernels are OIHW
    return shape[1] * receptive, shape[0] * receptive


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype="float32"):
        fi, fo = _fans(shape)
        limit = math.sqrt(6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        return _uniform(shape, dtype, -limit, limit)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype="float32"):
        fi = self.fan_in or _fans(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, -limit, limit)


def _resolve(init, is_bias=False):
    if init is None:
        return Constant(0.0) if is_bias else XavierUniform()
    if isinstance(init, Initializer):
        return init
    if isinstance(init, (int, float)):
        return Constant(float(init))
    raise TypeError(f"bad initializer {init!r}")
