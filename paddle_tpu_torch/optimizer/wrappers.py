"""Wrapper optimizers (``paddle_tpu/optimizer/wrappers.py``): EMA, ModelAverage and Lookahead.

Reference parity: python/paddle/fluid/optimizer.py:3411
(ExponentialMovingAverage), :3102 (ModelAverage over the
average_accumulates op), :4822 (LookaheadOptimizer, arXiv:1907.08610).

The JAX package keeps the shadow state as arrays beside the parameters and
swaps arrays in ``apply()``. Here the shadow state is tensors on the
parameters' device, updated in place, and ``apply()``/``restore()`` copy
values into the parameters' own storage (``copy_``), never re-bind them: a
train or eval step captured in a CUDA graph (``runtime/compiled.py``)
reads the parameters where they lay at its capture, so a swap by
re-binding would leave every graph running on the old tensors.

Unlike the JAX package, EMA and ModelAverage need no ``sync()`` under a
compiled step: the port's train step updates the model itself, so
``update()``/``accumulate()`` after each step read the live weights.

``Lookahead`` is an :class:`~paddle_tpu_torch.optimizer.Optimizer` that
shares the inner optimizer's accumulators (the slow weights sit beside
them under ``slow``), its step count and its device scalars. Its every-k
sync is a ``torch.where`` on the step count (the device one inside a
compiled step), so one captured graph serves every step, the sync steps
included; the slow weights start as a float32 copy of the fast ones.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import Optimizer

__all__ = ["ExponentialMovingAverage", "ModelAverage", "Lookahead", "LookaheadOptimizer"]


def _resolve_parameters(parameters):
    """A module (anything with ``parameters()``) or an iterable of
    tensors; a parameter with ``do_model_average = False`` is left out."""
    if parameters is None:
        raise ValueError(
            "parameters must be provided (a Layer or a list of Tensors); "
            "the reference's static-graph variants collect them from the "
            "default program, which has no dygraph counterpart")
    if hasattr(parameters, "parameters") and callable(parameters.parameters):
        parameters = parameters.parameters()
    return [p for p in parameters if getattr(p, "do_model_average", None) is not False]


def _as_tensor(value, like):
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value))
    return value.to(device=like.device, dtype=like.dtype)


class _ParamSwap:
    """``apply()``/``restore()`` over a ``_target_values()`` hook: the
    values are copied into the parameters' storage, the live values kept
    in a backup of copies."""

    _backup = None

    def _target_values(self):
        raise NotImplementedError

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        """Copy the averaged values into the parameters; restore on exit
        (with ``need_restore``)."""
        if self._backup is not None:
            raise RuntimeError(
                "apply() is already active; nested apply() would clobber the "
                "backup and restore() would reinstate averaged weights")
        with torch.no_grad():
            self._backup = [p.detach().clone() for p in self._parameters]
            for p, v in zip(self._parameters, self._target_values()):
                p.copy_(v)
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        if self._backup is None:
            return
        with torch.no_grad():
            for p, b in zip(self._parameters, self._backup):
                p.copy_(b)
        self._backup = None


class ExponentialMovingAverage(_ParamSwap):
    """EMA of parameters with bias correction and decay scheduling
    (fluid/optimizer.py:3411): ``ema = ema * decay + param * (1 - decay)``,
    applied as ``ema / (1 - prod(decay_t))``. With ``thres_steps`` the decay
    of an update is ``min(decay, (1 + t) / (10 + t))``. Before the first
    ``update()``, ``apply()`` installs the live weights."""

    def __init__(self, parameters=None, decay=0.999, thres_steps=None, name=None):
        self._parameters = _resolve_parameters(parameters)
        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._name = name or ""
        self._step = 0
        self._decay_prod = 1.0
        self._ema = [torch.zeros_like(p, requires_grad=False) for p in self._parameters]
        self._backup = None

    def _current_decay(self):
        if self._thres_steps is not None:
            t = float(self._thres_steps() if callable(self._thres_steps) else self._thres_steps)
            return min(self._decay, (1.0 + t) / (10.0 + t))
        return self._decay

    @torch.no_grad()
    def update(self):
        """Fold the current parameter values into the averages: three
        multi-tensor passes, each product and the sum rounded as the JAX
        expression rounds them."""
        d = self._current_decay()
        self._step += 1
        self._decay_prod *= d
        torch._foreach_mul_(self._ema, d)
        torch._foreach_add_(self._ema, torch._foreach_mul(
            [p.detach().to(e.dtype) for p, e in zip(self._parameters, self._ema)], 1.0 - d))

    def _target_values(self):
        if self._step == 0:
            return [p.detach() for p in self._parameters]
        denom = 1.0 - self._decay_prod
        return [e / denom for e in self._ema]

    def state_dict(self):
        out = {"step": self._step, "decay_prod": self._decay_prod}
        for i, e in enumerate(self._ema):
            out[f"ema_{i}"] = e.detach().clone()
        return out

    def set_state_dict(self, state):
        self._step = int(state["step"])
        self._decay_prod = float(state["decay_prod"])
        with torch.no_grad():
            for i, e in enumerate(self._ema):
                e.copy_(_as_tensor(state[f"ema_{i}"], e))


class ModelAverage(_ParamSwap):
    """Windowed parameter averaging (fluid/optimizer.py:3102,
    operators/average_accumulates_op.h:40). Three float32 sums per
    parameter on its device; the counts and the window's decisions on the
    host, as Python ints: the window restarts when ``num_accumulates >=
    min_average_window`` and ``num_accumulates >= min(max_average_window,
    num_updates * average_window_rate)``; every 16384 updates ``sum_1`` is
    drained into ``sum_2``. ``apply()`` installs ``(sum_1 + sum_2 + sum_3)
    / (num_accumulates + old_num_accumulates)``."""

    _MAX_NUM_ACCUMULATES = 16384  # average_accumulates_op.h:45

    def __init__(self, average_window_rate, parameters=None, min_average_window=10000,
                 max_average_window=10000, name=None):
        self._parameters = _resolve_parameters(parameters)
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        if self.min_average_window > self.max_average_window:
            raise ValueError("min_average_window must be <= max_average_window")

        def zeros():
            return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in self._parameters]

        self._sum_1, self._sum_2, self._sum_3 = zeros(), zeros(), zeros()
        self.num_updates = 0
        self.num_accumulates = 0
        self.old_num_accumulates = 0
        self._backup = None

    @torch.no_grad()
    def accumulate(self):
        """Fold the current parameters into the window (once a step)."""
        self.num_updates += 1
        self.num_accumulates += 1
        for s, p in zip(self._sum_1, self._parameters):
            s.add_(p.detach().float())
        if self.num_updates % self._MAX_NUM_ACCUMULATES == 0:
            for s2, s1 in zip(self._sum_2, self._sum_1):
                s2.add_(s1)
                s1.zero_()
        window = min(self.max_average_window, self.num_updates * self.average_window)
        if self.num_accumulates >= self.min_average_window and self.num_accumulates >= window:
            for s1, s2, s3 in zip(self._sum_1, self._sum_2, self._sum_3):
                s3.copy_(s1 + s2)
                s1.zero_()
                s2.zero_()
            self.old_num_accumulates = self.num_accumulates
            self.num_accumulates = 0

    step = accumulate
    update = accumulate

    def _target_values(self):
        total = self.num_accumulates + self.old_num_accumulates
        if total == 0:
            return [p.detach() for p in self._parameters]
        return [(s1 + s2 + s3) / float(total)
                for s1, s2, s3 in zip(self._sum_1, self._sum_2, self._sum_3)]

    def state_dict(self):
        out = {"num_updates": self.num_updates, "num_accumulates": self.num_accumulates,
               "old_num_accumulates": self.old_num_accumulates}
        for name, sums in (("sum_1", self._sum_1), ("sum_2", self._sum_2),
                           ("sum_3", self._sum_3)):
            for i, s in enumerate(sums):
                out[f"{name}_{i}"] = s.detach().clone()
        return out

    def set_state_dict(self, state):
        self.num_updates = int(state["num_updates"])
        self.num_accumulates = int(state["num_accumulates"])
        self.old_num_accumulates = int(state["old_num_accumulates"])
        with torch.no_grad():
            for name, sums in (("sum_1", self._sum_1), ("sum_2", self._sum_2),
                               ("sum_3", self._sum_3)):
                for i, s in enumerate(sums):
                    s.copy_(_as_tensor(state[f"{name}_{i}"], s))


class Lookahead(Optimizer):
    """Lookahead (fluid/optimizer.py:4822, arXiv:1907.08610): the inner
    optimizer updates the fast weights every step; every ``k`` steps the
    slow weights move ``slow + alpha * (fast - slow)`` and the fast weights
    are set to them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if inner_optimizer is None:
            raise ValueError("inner optimizer can not be None")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha should be in [0, 1]")
        if not (isinstance(k, int) and k > 0):
            raise ValueError("k should be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._parameter_list = list(inner_optimizer._parameter_list)
        self._param_names = list(inner_optimizer._param_names)
        self._accumulators = inner_optimizer._accumulators  # shared, as in the JAX package
        self._learning_rate = inner_optimizer._learning_rate
        self._weight_decay = None
        self._grad_clip = None

    # the inner optimizer's step count and device scalars are this one's
    @property
    def _global_step(self):
        return self.inner_optimizer._global_step

    @_global_step.setter
    def _global_step(self, value):
        self.inner_optimizer._global_step = value

    @property
    def _step_t(self):
        return self.inner_optimizer._step_t

    @property
    def _lr_t(self):
        return self.inner_optimizer._lr_t

    @property
    def _on_device(self):
        return self.inner_optimizer._on_device

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def set_lr(self, value):
        self.inner_optimizer.set_lr(value)

    def _use_device_scalars(self, device):
        self.inner_optimizer._use_device_scalars(device)

    def _scalars_on_device(self, on=True):
        return self.inner_optimizer._scalars_on_device(on)

    def _write_lr(self):
        self.inner_optimizer._write_lr()

    def _accumulator_names(self):
        return ("slow", *self.inner_optimizer._accumulator_names())

    def _new_accumulator(self, name, param):
        if name == "slow":  # the reference's startup assign (fluid/optimizer.py:4928)
            return param.detach().float().clone()
        return self.inner_optimizer._new_accumulator(name, param)

    @torch.no_grad()
    def step(self):
        slow = self._ensure_accumulator("slow")
        inner = self.inner_optimizer
        inner.step()
        if inner._on_device:
            sync = (inner._step_t % self.k) == 0
        else:
            sync = torch.tensor(inner._global_step % self.k == 0)
        for s, p in zip(slow, self._parameter_list):
            fast = p.to(s.dtype)
            new_s = torch.where(sync, s + self.alpha * (fast - s), s)
            s.copy_(new_s)
            p.copy_(torch.where(sync, new_s, fast).to(p.dtype))

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    clear_gradients = clear_grad


# reference-era alias (fluid/optimizer.py:4822 class name)
LookaheadOptimizer = Lookahead
