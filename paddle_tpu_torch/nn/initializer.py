"""Parameter initializers (``paddle_tpu/nn/initializer.py``) for layers and static programs.

Each draws from ``generator`` when the caller passes one (a layer's own),
else from the CPU's default generator of
:mod:`paddle_tpu_torch.framework.random` (``seed(value)`` restarts it), so
a program's startup is reproducible; the streams differ from the JAX
package's, so parity tests carry weights across as numpy.
"""
from __future__ import annotations

import math

import torch

from ..framework import random as _random
from ..framework.dtype import torch_dtype

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform", "XavierNormal",
           "XavierUniform", "KaimingNormal", "KaimingUniform", "Assign"]


class Initializer:
    """``init(shape, dtype="float32", generator=None, device=None)``: a
    new tensor on ``device`` (the CPU by default), drawn from ``generator``
    (a generator of that device) or the device's default one."""

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        raise NotImplementedError


def _generator(generator, device):
    if generator is not None or (device is not None and torch.device(device).type == "meta"):
        return generator
    return _random.default_generator(device)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        return torch.full(tuple(shape), self.value, dtype=torch_dtype(dtype), device=device)


class Normal(Initializer):
    """``N(mean, std**2)`` (``paddle_tpu/nn/initializer.py:31-37``)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        z = torch.randn(tuple(shape), dtype=torch_dtype(dtype), device=device,
                        generator=_generator(generator, device))
        return z * self.std + self.mean


class TruncatedNormal(Initializer):
    """``N(mean, std**2)`` truncated to two standard deviations: a
    standard normal cut to [-2, 2] by the inverse CDF of a uniform draw
    (``jax.random.truncated_normal``'s law)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
        u = _uniform(shape, "float32", lo, hi, generator, device)
        z = (math.sqrt(2) * torch.erfinv(2 * u - 1)).clamp(-2.0, 2.0)
        return (z * self.std + self.mean).to(torch_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        return _uniform(shape, dtype, self.low, self.high, generator, device)


class Assign(Initializer):
    """The given values (an array or tensor of the parameter's shape)."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        v = self.value
        t = (v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v)).to(
            device=device, dtype=torch_dtype(dtype))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"Assign initializer of shape {tuple(t.shape)} for a parameter of "
                             f"shape {tuple(shape)}")
        return t.clone()


def _uniform(shape, dtype, low, high, generator=None, device=None):
    u = torch.rand(tuple(shape), dtype=torch_dtype(dtype), device=device,
                   generator=_generator(generator, device))
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

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        fi, fo = _fans(shape)
        limit = math.sqrt(6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        return _uniform(shape, dtype, -limit, limit, generator, device)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        fi, fo = _fans(shape)
        std = math.sqrt(2.0 / ((self.fan_in or fi) + (self.fan_out or fo)))
        return Normal(0.0, std)(shape, dtype, generator, device)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        fi = self.fan_in or _fans(shape)[0]
        std = math.sqrt(2.0 / (1 + self.negative_slope ** 2)) / math.sqrt(fi)
        return Normal(0.0, std)(shape, dtype, generator, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        fi = self.fan_in or _fans(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, dtype, -limit, limit, generator, device)


def _resolve(init, is_bias=False):
    if init is None:
        return Constant(0.0) if is_bias else XavierUniform()
    if isinstance(init, Initializer):
        return init
    if isinstance(init, (int, float)):
        return Constant(float(init))
    raise TypeError(f"bad initializer {init!r}")
