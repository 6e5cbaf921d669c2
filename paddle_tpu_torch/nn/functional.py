"""Functional ops of the serving and training paths (``paddle_tpu/nn/functional.py``).

Paddle's conventions on torch tensors: ``linear`` takes the ``[in, out]``
weight Paddle stores, ``gelu`` is exact (erf), as ``jax.nn.gelu(x,
approximate=False)`` in ``paddle_tpu/ops/kernels.py``; the losses follow
``paddle_tpu/ops/kernels.py:1077-1130`` (``ignore_index`` labels count
nowhere, ``reduction="mean"`` divides by the valid labels). Random ops take
an explicit ``torch.Generator``, by default their device's
(:mod:`paddle_tpu_torch.framework.random`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from ..framework import random as _random

__all__ = ["linear", "gelu", "relu", "tanh", "softmax", "layer_norm", "embedding", "dropout",
           "gather", "cross_entropy", "softmax_with_cross_entropy"]


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


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout; identity in eval or at ``p == 0``. The
    mask comes from ``generator`` (default: the device's default
    generator)."""
    if not training or p == 0.0:
        return x
    gen = _random.default_generator(x.device) if generator is None else generator
    keep = torch.rand(x.shape, device=x.device, generator=gen) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def gather(x, index, axis=0):
    """Rows (or slices along ``axis``) of ``x`` at ``index``
    (``paddle_tpu.ops.gather``)."""
    return torch.index_select(x, axis, index.reshape(-1))


def _picked_logp(logits, label, axis, ignore_index):
    """``-log_softmax(logits)`` at ``label`` (0 where the label is
    ``ignore_index``) and the valid-label mask, labels squeezed."""
    logp = torch.log_softmax(logits, dim=axis)
    lbl = label.squeeze(axis) if label.dim() == logits.dim() else label
    valid = lbl != ignore_index
    picked = torch.gather(logp, axis, lbl.clamp_min(0).unsqueeze(axis).to(torch.int64))
    loss = torch.where(valid.unsqueeze(axis), -picked, torch.zeros_like(picked))
    return loss, valid


def softmax_with_cross_entropy(logits, label, axis=-1, ignore_index=-100):
    """Per-example loss with the class axis kept (size 1)."""
    loss, _ = _picked_logp(logits, label, axis, ignore_index)
    return loss


def cross_entropy(input, label, ignore_index=-100, reduction="mean", axis=-1):
    """Softmax cross entropy over hard labels; ``reduction`` is ``"mean"``
    (over the valid labels, at least 1), ``"sum"`` or ``"none"``."""
    loss, valid = _picked_logp(input, label, axis, ignore_index)
    loss = loss.squeeze(axis)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    return loss.sum() / valid.sum().to(loss.dtype).clamp_min(1.0)
