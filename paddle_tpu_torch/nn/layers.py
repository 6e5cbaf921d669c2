"""Core layers of the serving path (``paddle_tpu/nn/layers.py``).

``torch.nn.Module``s with Paddle's attribute names and parameter layouts,
so a ``paddle_tpu`` state dict loads by name: ``Linear.weight`` is
``[in_features, out_features]`` as in Paddle (not torch's ``[out, in]``).
Random init takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from . import functional as F

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout", "LayerList"]


def _param(shape, device=None, dtype=torch.float32):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Linear(nn.Module):
    def __init__(self, in_features, out_features, bias_attr=None, generator=None,
                 device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param((in_features, out_features), device)
        bound = math.sqrt(6.0 / (in_features + out_features))  # XavierUniform
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
        if bias_attr is not False:
            self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        else:
            self.bias = None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, generator=None,
                 device=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = _param((num_embeddings, embedding_dim), device)
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = (None if weight_attr is False
                       else nn.Parameter(torch.ones(self.normalized_shape, device=device)))
        self.bias = (None if bias_attr is False
                     else nn.Parameter(torch.zeros(self.normalized_shape, device=device)))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class Dropout(nn.Module):
    """``generator`` draws the masks; None means the input's device's
    default generator (``framework.random``)."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


LayerList = nn.ModuleList
