"""Learning-rate schedulers (``paddle_tpu/optimizer/lr.py``): the base class and the 12 schedules.

Schedulers are host-side state, a Python float per step; the optimizer
reads ``scheduler()`` at every step. Each schedule keeps the JAX
package's formula and its ``state_dict`` (``last_epoch``, ``last_lr``),
so the two packages give the same float at every step. Under
``train_step(jit=True)`` the optimizer writes that float into its lr on
the card (``Optimizer._write_lr``) before each replay, so a schedule moves
the lr without a new capture.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "NoamDecay", "StepDecay", "MultiStepDecay", "ExponentialDecay",
           "NaturalExpDecay", "InverseTimeDecay", "PolynomialDecay", "CosineAnnealingDecay",
           "LinearWarmup", "PiecewiseDecay", "LambdaDecay", "ReduceOnPlateau"]


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = learning_rate
        self.step()

    def get_lr(self):
        raise NotImplementedError

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]


class NoamDecay(LRScheduler):
    """``base * d_model**-0.5 * min(step**-0.5, step * warmup**-1.5)``
    (Vaswani et al. 2017), the step at least 1."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model**-0.5
                * min(step**-0.5, step * self.warmup_steps**-1.5))


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1, verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (max(self.last_epoch, 0) // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1, verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma**n


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** max(self.last_epoch, 0)


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * max(self.last_epoch, 0))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * max(self.last_epoch, 0))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0, cycle=False,
                 last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        if self.cycle and step > 0:
            decay_steps = self.decay_steps * math.ceil(step / self.decay_steps)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        return (self.eta_min
                + (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * step / self.T_max)) / 2)


class LinearWarmup(LRScheduler):
    """From ``start_lr`` to ``end_lr`` over ``warmup_steps``, then
    ``learning_rate``: a float, or a scheduler that steps only after the
    warmup."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr, last_epoch=-1,
                 verbose=False):
        self.lr_sched = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.target = None if self.lr_sched is not None else learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(end_lr, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 0)
        if step < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * step / self.warmup_steps
        if self.lr_sched is not None:
            return self.lr_sched.last_lr
        return self.target

    def step(self, epoch=None):
        if self.lr_sched is not None and self.last_epoch >= self.warmup_steps:
            self.lr_sched.step(epoch)
        super().step(epoch)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(max(self.last_epoch, 0))


class ReduceOnPlateau(LRScheduler):
    """Multiplies the lr by ``factor`` (not below ``min_lr``) once
    ``metrics`` has failed to improve by ``threshold`` for more than
    ``patience`` calls of ``step(metrics)``, then waits ``cooldown``
    calls. ``step()`` without a metric does nothing."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10, threshold=1e-4,
                 cooldown=0, min_lr=0.0, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.cooldown_counter = 0
        self.best = None
        self.num_bad_epochs = 0
        self.base_lr = learning_rate
        self.last_lr = learning_rate
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        current = float(metrics.item() if hasattr(metrics, "item") else metrics)
        self.last_epoch += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
            return
        better = (self.best is None
                  or (self.mode == "min" and current < self.best - self.threshold)
                  or (self.mode == "max" and current > self.best + self.threshold))
        if better:
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.last_lr = max(self.last_lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad_epochs = 0
