"""Optimizers (``paddle_tpu/optimizer/__init__.py``): the base class, Adam and AdamW.

Each update follows the JAX package's expression order, not
``torch.optim``'s, so the two packages agree to rounding on the same
gradients: Adam's ``param - lr * mhat / (sqrt(vhat) + eps)`` and AdamW's
decoupled ``- lr * coeff * param_old`` after it (``:289-320``).
Accumulators are per-parameter tensors on the parameter's device, named
and indexed as the JAX package names them in ``state_dict``
(``moment1_{i}``, ``moment2_{i}``, ``global_step``), so optimizer state
carries across (:func:`paddle_tpu_torch.convert.adamw_state_from_numpy`).
Parameters whose ``grad`` is None, or that do not require grad, are
skipped, as the JAX package skips parameters without a gradient. The
other optimizers, gradient clipping and the concrete LR schedules are not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from . import lr as lr  # noqa: F401
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW", "L2Decay", "lr"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * param


def _resolve_weight_decay(weight_decay):
    if weight_decay is None:
        return None
    if isinstance(weight_decay, (int, float)):
        return L2Decay(float(weight_decay))
    return weight_decay


class Optimizer:
    """``parameters``: the tensors to update, or ``(name, tensor)`` pairs
    (``model.named_parameters()``) whose names ``apply_decay_param_fun``
    sees; unnamed parameters are called ``param_{i}``."""

    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters must be provided (dygraph mode)")
        if grad_clip is not None:
            raise NotImplementedError("gradient clipping is not ported yet")
        items = list(parameters)
        self._param_names = [it[0] if isinstance(it, tuple) else f"param_{i}"
                             for i, it in enumerate(items)]
        self._parameter_list = [it[1] if isinstance(it, tuple) else it for it in items]
        self._learning_rate = learning_rate
        self._weight_decay = _resolve_weight_decay(weight_decay)
        # accumulators: name -> list of tensors aligned with the parameters
        self._accumulators: dict[str, list] = {}
        self._global_step = 0

    def _ensure_accumulator(self, name):
        if name not in self._accumulators:
            self._accumulators[name] = [torch.zeros_like(p) for p in self._parameter_list]
        return self._accumulators[name]

    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    @torch.no_grad()
    def step(self):
        params_grads = []
        for i, p in enumerate(self._parameter_list):
            if p.grad is None or not p.requires_grad:
                continue
            g = p.grad.to(p.dtype)
            if self._weight_decay is not None and not isinstance(self, AdamW):
                g = self._weight_decay(p, g)
            params_grads.append((i, p, g))
        lr_value = self.get_lr()
        self._global_step += 1
        for i, p, g in params_grads:
            p.copy_(self._apply_one(i, p, g, lr_value))

    def _apply_one(self, index, param, grad, lr):
        raise NotImplementedError

    def state_dict(self):
        out = {"global_step": self._global_step}
        for name, accs in self._accumulators.items():
            for i, a in enumerate(accs):
                out[f"{name}_{i}"] = a.detach().clone()
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        """Load a :meth:`state_dict` (tensors or numpy arrays): each
        accumulator goes to its parameter's device and dtype."""
        self._global_step = int(state.get("global_step", 0))
        names = {k.rsplit("_", 1)[0] for k in state if k not in ("global_step", "LR_Scheduler")}
        for name in names:
            accs = []
            i = 0
            while f"{name}_{i}" in state:
                p = self._parameter_list[i]
                a = state[f"{name}_{i}"]
                if not isinstance(a, torch.Tensor):
                    a = torch.from_numpy(np.array(a))
                if tuple(a.shape) != tuple(p.shape):
                    raise ValueError(f"{name}_{i}: shape {tuple(a.shape)} does not fit "
                                     f"parameter {self._param_names[i]} {tuple(p.shape)}")
                accs.append(a.to(device=p.device, dtype=p.dtype).clone())
                i += 1
            if accs:
                self._accumulators[name] = accs
        if "LR_Scheduler" in state and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])


class Adam(Optimizer):
    """operators/optimizers/adam_op.cc"""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _apply_one(self, index, param, grad, lr):
        m = self._ensure_accumulator("moment1")
        v = self._ensure_accumulator("moment2")
        t = self._global_step
        m[index] = self._beta1 * m[index] + (1 - self._beta1) * grad
        v[index] = self._beta2 * v[index] + (1 - self._beta2) * grad * grad
        mhat = m[index] / (1 - self._beta1**t)
        vhat = v[index] / (1 - self._beta2**t)
        return param - lr * mhat / (torch.sqrt(vhat) + self._epsilon)


class AdamW(Adam):
    """Decoupled weight decay: after the Adam update, ``- lr * coeff *
    param_old`` for every parameter whose name ``apply_decay_param_fun``
    accepts (all when it is None)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, grad_clip=None, name=None,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters, None, grad_clip,
                         name=name)
        self._wd_coeff = float(weight_decay) if isinstance(weight_decay, (int, float)) \
            else getattr(weight_decay, "coeff", 0.0)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_one(self, index, param, grad, lr):
        decay = True
        if self._apply_decay_param_fun is not None:
            decay = self._apply_decay_param_fun(self._param_names[index])
        new_param = super()._apply_one(index, param, grad, lr)
        if decay and self._wd_coeff:
            new_param = new_param - lr * self._wd_coeff * param
        return new_param
