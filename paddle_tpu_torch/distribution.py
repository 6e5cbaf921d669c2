"""Probability distributions (``paddle_tpu/distribution.py``).

Reference parity: python/paddle/fluid/layers/distributions.py (Uniform,
Normal, Categorical, MultivariateNormalDiag: sample, entropy, log_prob,
kl). Parameters that are not tensors become float32 tensors on the default
place (the card unless ``set_device("cpu")``); a tensor stays where it is.
``sample(shape, generator=None)`` draws from ``generator`` (a
``torch.Generator`` on the parameters' device), by default that device's
generator of ``framework.random``, which ``paddle.seed`` reseeds. Normal,
Uniform and MultivariateNormalDiag samples are reparameterized
(differentiable in the parameters); Categorical samples by Gumbel-max, as
``jax.random.categorical`` does. Results are the port's ``Tensor``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .framework import random as _random
from .framework.tensor import to_tensor, wrap

__all__ = [
    "Distribution", "Uniform", "Normal", "Bernoulli", "Categorical",
    "MultivariateNormalDiag", "kl_divergence",
]


def _t(x):
    if isinstance(x, torch.Tensor):
        return x
    return to_tensor(np.asarray(x, dtype="float32"))


def _uniform(shape, like, generator):
    gen = generator or _random.default_generator(like.device)
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=like.device)


def _clip(x, eps):
    return torch.clamp(x, eps, 1.0)


class Distribution:
    def sample(self, shape=(), generator=None):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        return wrap(torch.exp(self.log_prob(value)))

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    """U(low, high); reparameterized sampling."""

    def __init__(self, low, high):
        self.low = _t(low)
        self.high = _t(high)

    def sample(self, shape=(), generator=None):
        u = _uniform(tuple(shape) + tuple(self.low.shape), self.low, generator)
        return wrap(self.low + u * (self.high - self.low))

    def log_prob(self, value):
        value = _t(value)
        inside = (value >= self.low) & (value < self.high)
        lp = -torch.log(self.high - self.low)
        return wrap(torch.where(inside, lp, torch.full_like(lp, -np.inf)))

    def entropy(self):
        return wrap(torch.log(self.high - self.low))

    def kl_divergence(self, other):
        if not isinstance(other, Uniform):
            raise TypeError("kl(Uniform || non-Uniform) unsupported")
        return wrap(torch.log((other.high - other.low) / (self.high - self.low)))


class Normal(Distribution):
    """N(loc, scale); reparameterized sampling."""

    def __init__(self, loc, scale):
        self.loc = _t(loc)
        self.scale = _t(scale)

    def sample(self, shape=(), generator=None):
        gen = generator or _random.default_generator(self.loc.device)
        eps = torch.randn(tuple(shape) + tuple(self.loc.shape), generator=gen,
                          dtype=torch.float32, device=self.loc.device)
        return wrap(self.loc + eps * self.scale)

    def log_prob(self, value):
        value = _t(value)
        var = torch.square(self.scale)
        return wrap(torch.square(value - self.loc) / var * -0.5
                    - (torch.log(self.scale) + 0.5 * math.log(2 * math.pi)))

    def entropy(self):
        return wrap(torch.log(self.scale) + 0.5 * (1.0 + math.log(2 * math.pi)))

    def kl_divergence(self, other):
        if not isinstance(other, Normal):
            raise TypeError("kl(Normal || non-Normal) unsupported")
        var_ratio = torch.square(self.scale / other.scale)
        t1 = torch.square((self.loc - other.loc) / other.scale)
        return wrap(((var_ratio + t1) - (torch.log(var_ratio) + 1.0)) * 0.5)


class Bernoulli(Distribution):
    def __init__(self, probs):
        self.p = _t(probs)

    def sample(self, shape=(), generator=None):
        u = _uniform(tuple(shape) + tuple(self.p.shape), self.p, generator)
        return wrap((u < self.p).to(torch.float32))

    def log_prob(self, value):
        value = _t(value)
        eps = 1e-8
        return wrap(value * torch.log(_clip(self.p, eps))
                    + (1.0 - value) * torch.log(_clip(1.0 - self.p, eps)))

    def entropy(self):
        eps = 1e-8
        q = 1.0 - self.p
        return wrap((self.p * torch.log(_clip(self.p, eps)) + q * torch.log(_clip(q, eps)))
                    * -1.0)


class Categorical(Distribution):
    """Categories over the last axis of ``logits``."""

    def __init__(self, logits):
        self.logits = _t(logits)

    def _log_p(self):
        return torch.log_softmax(self.logits, dim=-1)

    def sample(self, shape=(), generator=None):
        lead = tuple(shape) + tuple(self.logits.shape[:-1])
        u = _uniform(lead + tuple(self.logits.shape[-1:]), self.logits, generator)
        # Gumbel-max: -log(-log(u)), u in [tiny, 1)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        return wrap(torch.argmax(self.logits + gumbel, dim=-1))

    def log_prob(self, value):
        lp = self._log_p()
        idx = _t(value).to(torch.int64)
        lead = torch.broadcast_shapes(lp.shape[:-1], idx.shape)
        lp = lp.expand(*lead, lp.shape[-1])
        return wrap(torch.gather(lp, -1, idx.expand(lead)[..., None])[..., 0])

    def entropy(self):
        lp = self._log_p()
        return wrap(torch.sum(torch.exp(lp) * lp, dim=-1) * -1.0)

    def kl_divergence(self, other):
        if not isinstance(other, Categorical):
            raise TypeError("kl(Categorical || non-Categorical) unsupported")
        lp, lq = self._log_p(), other._log_p()
        return wrap(torch.sum(torch.exp(lp) * (lp - lq), dim=-1))


class MultivariateNormalDiag(Distribution):
    """N(loc, diag(scale^2)) over the last axis (distributions.py
    MultivariateNormalDiag)."""

    def __init__(self, loc, scale):
        self.loc = _t(loc)
        self.scale = _t(scale)  # diagonal stds [.., D]

    def sample(self, shape=(), generator=None):
        gen = generator or _random.default_generator(self.loc.device)
        eps = torch.randn(tuple(shape) + tuple(self.loc.shape), generator=gen,
                          dtype=torch.float32, device=self.loc.device)
        return wrap(self.loc + eps * self.scale)

    def log_prob(self, value):
        value = _t(value)
        d = self.loc.shape[-1]
        z = (value - self.loc) / self.scale
        return wrap(torch.sum(torch.square(z), dim=-1) * -0.5
                    - (torch.sum(torch.log(self.scale), dim=-1) + 0.5 * d * math.log(2 * math.pi)))

    def entropy(self):
        d = self.loc.shape[-1]
        return wrap(torch.sum(torch.log(self.scale), dim=-1)
                    + 0.5 * d * (1.0 + math.log(2 * math.pi)))

    def kl_divergence(self, other):
        if not isinstance(other, MultivariateNormalDiag):
            raise TypeError("kl between different families unsupported")
        var_ratio = torch.square(self.scale / other.scale)
        t1 = torch.square((self.loc - other.loc) / other.scale)
        return wrap(torch.sum((var_ratio + t1) - (torch.log(var_ratio) + 1.0), dim=-1) * 0.5)


def kl_divergence(p, q):
    return p.kl_divergence(q)
