"""Optimizer update op kernels (``paddle_tpu/ops/optimizer_kernels.py``): the update rules beyond SGD, Momentum and Adam.

Pure rules ``(param, grad, accumulators, lr) -> new values`` over the JAX
kernels' attribute names and expressions (each cites the reference's
``operators/optimizers/`` source as the JAX kernel does), so static
programs and custom loops apply the same arithmetic as the optimizer
classes. ``dpsgd_update`` draws its noise from ``generator`` (the
device's default generator when None): the JAX kernel's ``key`` names a
JAX stream the port does not have.
"""
from __future__ import annotations

import torch

from ..framework import random as _random
from .registry import register_op

__all__ = []


def _norm(t):
    return torch.linalg.vector_norm(t)


@register_op("adamax_update", num_outputs=3)
def adamax_update(param, grad, moment, inf_norm, lr, step, *, beta1=0.9, beta2=0.999,
                  epsilon=1e-8):
    """``optimizers/adamax_op.cc``."""
    m = beta1 * moment + (1 - beta1) * grad
    u = torch.maximum(beta2 * inf_norm, torch.abs(grad))
    t = step.to(param.dtype)
    return param - lr / (1 - beta1 ** t) * m / (u + epsilon), m, u


@register_op("adagrad_update", num_outputs=2)
def adagrad_update(param, grad, moment, lr, *, epsilon=1e-6):
    """``optimizers/adagrad_op.cc``."""
    g2 = moment + grad * grad
    return param - lr * grad / (torch.sqrt(g2) + epsilon), g2


@register_op("adadelta_update", num_outputs=3)
def adadelta_update(param, grad, avg_squared_grad, avg_squared_update, lr, *, rho=0.95,
                    epsilon=1e-6):
    """``optimizers/adadelta_op.cc``."""
    g2 = rho * avg_squared_grad + (1 - rho) * grad * grad
    update = -torch.sqrt((avg_squared_update + epsilon) / (g2 + epsilon)) * grad
    u2 = rho * avg_squared_update + (1 - rho) * update * update
    return param + lr * update, g2, u2


@register_op("rmsprop_update", num_outputs=3)
def rmsprop_update(param, grad, mean_square, moment, lr, *, rho=0.95, epsilon=1e-6,
                   momentum=0.0, centered=False, mean_grad=None):
    """``optimizers/rmsprop_op.cc`` (the uncentered form)."""
    ms = rho * mean_square + (1 - rho) * grad * grad
    mom = momentum * moment + lr * grad / torch.sqrt(ms + epsilon)
    return param - mom, ms, mom


@register_op("ftrl_update", num_outputs=3)
def ftrl_update(param, grad, squared_accum, linear_accum, lr, *, l1=0.0, l2=0.0,
                lr_power=-0.5):
    """``optimizers/ftrl_op.cc``."""
    new_sq = squared_accum + grad * grad
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(squared_accum)) / lr
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        sigma = (new_sq ** (-lr_power) - squared_accum ** (-lr_power)) / lr
        denom = new_sq ** (-lr_power) / lr + 2 * l2
    new_lin = linear_accum + grad - sigma * param
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    return pre / denom, new_sq, new_lin


@register_op("lamb_update", num_outputs=3)
def lamb_update(param, grad, moment1, moment2, lr, step, *, beta1=0.9, beta2=0.999,
                epsilon=1e-6, weight_decay=0.01):
    """``optimizers/lamb_op.cc``: the layer-adaptive trust ratio."""
    m = beta1 * moment1 + (1 - beta1) * grad
    v = beta2 * moment2 + (1 - beta2) * grad * grad
    t = step.to(param.dtype)
    r = (m / (1 - beta1 ** t)) / (torch.sqrt(v / (1 - beta2 ** t)) + epsilon) \
        + weight_decay * param
    w_norm, r_norm = _norm(param), _norm(r)
    ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
    return param - lr * ratio * r, m, v


@register_op("lars_momentum_update", num_outputs=2)
def lars_momentum_update(param, grad, velocity, lr, *, mu=0.9, lars_coeff=0.001,
                         lars_weight_decay=0.0005, epsilon=0.0):
    """``optimizers/lars_momentum_op.cc``: layer-wise adaptive rate
    scaling."""
    w_norm, g_norm = _norm(param), _norm(grad)
    local_lr = torch.where((w_norm > 0) & (g_norm > 0),
                           lars_coeff * w_norm / (g_norm + lars_weight_decay * w_norm + epsilon),
                           1.0)
    v = mu * velocity + lr * local_lr * (grad + lars_weight_decay * param)
    return param - v, v


@register_op("proximal_gd_update")
def proximal_gd_update(param, grad, lr, *, l1=0.0, l2=0.0):
    """``optimizers/proximal_gd_op.cc``: the proximal step of l1/l2
    regularized descent."""
    prox = param - lr * grad
    if l1 > 0:
        return torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1, min=0.0) \
            / (1.0 + lr * l2)
    return prox / (1.0 + lr * l2)


@register_op("proximal_adagrad_update", num_outputs=2)
def proximal_adagrad_update(param, grad, moment, lr, *, l1=0.0, l2=0.0):
    """``optimizers/proximal_adagrad_op.cc``."""
    g2 = moment + grad * grad
    adapted_lr = lr / torch.sqrt(g2)
    prox = param - adapted_lr * grad
    if l1 > 0:
        return torch.sign(prox) * torch.clamp(torch.abs(prox) - adapted_lr * l1, min=0.0) \
            / (1.0 + adapted_lr * l2), g2
    return prox / (1.0 + adapted_lr * l2), g2


@register_op("dpsgd_update")
def dpsgd_update(param, grad, lr, *, clip=10.0, batch_size=16.0, sigma=1.0, key=None,
                 generator=None):
    """``optimizers/dpsgd_op.cc``: differentially private SGD, the gradient
    clipped to norm ``clip`` and Gaussian noise of scale ``sigma * clip``
    added."""
    scale = torch.clamp(clip / torch.clamp(_norm(grad), min=1e-12), max=1.0)
    noise = sigma * clip * _random.draw(param.device, generator, lambda gen: torch.randn(
        grad.shape, dtype=grad.dtype, device=grad.device, generator=gen))
    return param - lr * (grad * scale + noise) / batch_size
