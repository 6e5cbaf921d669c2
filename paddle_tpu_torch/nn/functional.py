"""Functional ops of the serving path (``paddle_tpu/nn/functional.py``).

Paddle's conventions on torch tensors: ``linear`` takes the ``[in, out]``
weight Paddle stores, ``gelu`` is exact (erf), as ``jax.nn.gelu(x,
approximate=False)`` in ``paddle_tpu/ops/kernels.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

__all__ = ["linear", "gelu", "relu", "tanh", "softmax", "layer_norm", "embedding", "dropout"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with Paddle's ``[in_features, out_features]`` weight."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def gelu(x, approximate=False):
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return _F.layer_norm(x, list(normalized_shape), weight, bias, epsilon)


def embedding(x, weight, padding_idx=None):
    return _F.embedding(x, weight, padding_idx=padding_idx)


def dropout(x, p=0.5, training=True):
    """Upscale-in-train dropout; identity in eval or at ``p == 0``."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
