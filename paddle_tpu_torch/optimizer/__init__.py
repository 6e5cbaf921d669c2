"""Optimizers (``paddle_tpu/optimizer/__init__.py``): the base class, SGD, Momentum, Adam and AdamW, the gradient clips and the decays.

Each update follows the JAX package's expression order, not
``torch.optim``'s, so the two packages agree to rounding on the same
gradients: Adam's ``param - lr * mhat / (sqrt(vhat) + eps)`` and AdamW's
decoupled ``- lr * coeff * param_old`` after it (``:289-320``).
Momentum (``:230-277``) updates every parameter through one call of the
fused in-place multi-tensor kernel (``ops/cuda/optimizer_update.py``,
``FLAGS_use_fused_optimizer``), which folds a plain ``L2Decay`` in itself,
so ``step`` then skips the separate decay pass (``:157-173``).
Accumulators are per-parameter tensors on the parameter's device, named
and indexed as the JAX package names them in ``state_dict``
(``moment1_{i}``, ``moment2_{i}``, ``velocity_{i}``, ``global_step``), so
optimizer state carries across
(:func:`paddle_tpu_torch.convert.adamw_state_from_numpy`,
:func:`~paddle_tpu_torch.convert.momentum_state_from_numpy`).
Parameters whose ``grad`` is None, or that do not require grad, are
skipped, as the JAX package skips parameters without a gradient.

``step`` works in the JAX order (``:153-181``): the weight decay
(``L2Decay``, ``L1Decay``) is added to each gradient first, then
``grad_clip`` (:class:`ClipGradByValue`, :class:`ClipGradByNorm`,
:class:`ClipGradByGlobalNorm`) sees the decayed gradients, then the lr is
read and the update applied. The clips are tensor ops with no host
decision (``torch.where``, never ``.item()``), so inside a captured step
the norms and factors stay on the card; the global norm sums squares in
float32. Momentum folds its L2 decay into the kernel only without a clip,
since the clip must see the decayed gradient (``:245-255``). A parameter
with a ``regularizer`` attribute (the slot the JAX ``Parameter`` keeps,
``paddle_tpu/framework/tensor.py:435-442``) takes it in place of the
global decay, under every optimizer, AdamW and Lamb included
(``:165-172``); Momentum's kernel then leaves that parameter's decay out
(``:262-268``).

Adagrad, Adadelta, RMSProp, Adamax and Lamb (``:323-424``) keep the JAX
constructor signatures, accumulator names and expression order. Adamax's
``1 - beta1**t`` and Lamb's two corrections come, inside the compiled
step, from the device step count as Adam's do; Lamb's trust ratio is two
norms and a ``torch.where``, with no host read. Adagrad's ``moment`` starts
at ``initial_accumulator_value`` on every path (the JAX train step starts
it at 0: ROADMAP.md Queue C). The wrappers (EMA, ModelAverage, Lookahead)
are in :mod:`.wrappers`.

Accumulators are updated in place (``copy_``), so they keep their storage
from step to step, as a step captured in a CUDA graph needs. Called on its
own, ``step`` takes the lr and the step count as Python numbers, as the
JAX package's eager optimizer does (Adam's bias correction ``1 -
beta**t`` and AdamW's ``lr * coeff`` then in float64); so does the train
step with ``jit=False``, and so does a direct ``step()`` on an optimizer a
compiled train step also drives. Inside the compiled train step
(``framework/jit.py``, ``jit=True``) they are device tensors
(:meth:`Optimizer._use_device_scalars`, :meth:`Optimizer._scalars_on_device`):
the step count an int32 the step advances on the device, the lr a float32
the train step writes before each step, as the JAX compiled step feeds its
traced ``_global_step`` and ``lr`` (``paddle_tpu/framework/jit.py:155-173,
441``); those scalars are then float32 computations, as there. Once made,
the device step count advances with every ``step``, so it stays equal to
the host's.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..flags import flag
from ..ops.cuda import optimizer_update as _update
from . import lr as lr  # noqa: F401
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adagrad", "Adadelta", "RMSProp",
           "Adamax", "Lamb", "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "L1Decay", "L2Decay", "lr"]


# -- gradient clipping (paddle_tpu/optimizer/__init__.py:33-72) --------------


def _clip_factor(norm, clip_norm):
    """``clip_norm / max(norm, 1e-12)`` where ``norm > clip_norm``, else 1,
    in ``norm``'s dtype, on its device, with no host decision. The quotient
    is a true division of two tensors (a Python float over a tensor would
    multiply by a reciprocal)."""
    scaled = torch.full_like(norm, clip_norm) / torch.clamp_min(norm, 1e-12)
    return torch.where(norm > clip_norm, scaled, torch.ones_like(norm))


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient entry clamped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max)) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``, its norm
    taken in its own dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        return [(p, g * _clip_factor(torch.sqrt(torch.sum(g * g)), self.clip_norm))
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by one factor so that their joint L2 norm, the
    squares summed in float32, is at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        if not params_grads:
            return params_grads
        global_sq = sum(torch.sum(g.float() ** 2) for _, g in params_grads)
        factor = _clip_factor(torch.sqrt(global_sq), self.clip_norm)
        return [(p, g * factor.to(g.dtype)) for p, g in params_grads]


# -- regularizers (paddle_tpu/optimizer/__init__.py:77-91) -------------------


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * param


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * torch.sign(param)


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
        items = list(parameters)
        self._param_names = [it[0] if isinstance(it, tuple) else f"param_{i}"
                             for i, it in enumerate(items)]
        self._parameter_list = [it[1] if isinstance(it, tuple) else it for it in items]
        self._learning_rate = learning_rate
        self._weight_decay = _resolve_weight_decay(weight_decay)
        self._grad_clip = grad_clip
        # accumulators: name -> list of tensors aligned with the parameters
        self._accumulators: dict[str, list] = {}
        self._global_step = 0
        # the train step's scalars on the device (_use_device_scalars): the
        # step count (int32, advanced by step) and the lr (float32), read by
        # step inside _scalars_on_device
        self._step_t = None
        self._lr_t = None
        self._on_device = False

    #: the accumulators a step keeps, by the JAX package's names
    _ACCUMULATORS: tuple = ()

    def _accumulator_names(self):
        return self._ACCUMULATORS

    def _new_accumulator(self, name, param):
        return torch.zeros_like(param)

    def _ensure_accumulator(self, name):
        if name not in self._accumulators:
            self._accumulators[name] = [self._new_accumulator(name, p)
                                        for p in self._parameter_list]
        return self._accumulators[name]

    def _init_accumulators(self):
        """Make every accumulator a step keeps, as the JAX train step's
        ``init_opt_state`` does before its first step, so a checkpoint of
        the state names them before any step has run."""
        for name in self._accumulator_names():
            self._ensure_accumulator(name)

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

    def _use_device_scalars(self, device):
        """Make the step count and the lr as 0-dim tensors on ``device``
        (int32 and float32), unless there already: from now on ``step``
        advances the count there, and inside :meth:`_scalars_on_device`
        reads both there (the lr as :meth:`_write_lr` wrote it)."""
        device = torch.device(device)
        if self._step_t is None or self._step_t.device != device:
            self._step_t = torch.tensor(self._global_step, dtype=torch.int32, device=device)
            self._lr_t = torch.tensor(self.get_lr(), dtype=torch.float32, device=device)

    @contextlib.contextmanager
    def _scalars_on_device(self, on=True):
        """With ``on``, ``step`` inside takes the lr and the step count from
        the tensors :meth:`_use_device_scalars` made (the compiled train
        step's); else the Python numbers."""
        prev, self._on_device = self._on_device, bool(on)
        try:
            yield
        finally:
            self._on_device = prev

    def _write_lr(self):
        """Write :meth:`get_lr` into the device lr, rounded to float32."""
        self._lr_t.fill_(self.get_lr())

    def _fused_decay_coeff(self):
        """The L2-decay coefficient the update kernel folds in itself; None
        when ``step`` applies the decay to the gradient first."""
        return None

    @torch.no_grad()
    def step(self):
        fused_wd = self._fused_decay_coeff()
        params_grads = []
        for i, p in enumerate(self._parameter_list):
            if p.grad is None or not p.requires_grad:
                continue
            g = p.grad.to(p.dtype)
            reg = getattr(p, "regularizer", None)
            if reg is not None:
                g = reg(p, g)
            elif self._weight_decay is not None and not isinstance(self, AdamW) and fused_wd is None:
                g = self._weight_decay(p, g)
            params_grads.append((i, p, g))
        if self._grad_clip is not None:
            clipped = self._grad_clip([((i, p), g) for i, p, g in params_grads])
            params_grads = [(i, p, g) for (i, p), g in clipped]
        if self._step_t is not None:
            self._step_t.add_(1)  # the device count keeps with the host's
        lr_value = self._lr_t if self._on_device else self.get_lr()
        self._global_step += 1
        self._apply_all(params_grads, lr_value)

    def _apply_all(self, params_grads, lr):
        """Update every ``(index, param, grad)`` of ``params_grads``: one
        :meth:`_apply_one` each."""
        for i, p, g in params_grads:
            new_param = self._apply_one(i, p, g, lr)
            if new_param is not p:  # an update in place returns the parameter itself
                p.copy_(new_param)

    def _apply_one(self, index, param, grad, lr):
        """The updated parameter: a new tensor, or ``param`` itself when the
        update wrote it in place."""
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
        accumulator goes to its parameter's device and dtype, copied into
        the accumulator already there, which keeps its storage."""
        self._global_step = int(state.get("global_step", 0))
        if self._step_t is not None:
            self._step_t.fill_(self._global_step)
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
            old = self._accumulators.get(name)
            if old is not None and len(old) == len(accs):
                for a, new in zip(old, accs):
                    a.copy_(new)
            elif accs:
                self._accumulators[name] = accs
        if "LR_Scheduler" in state and isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])


class SGD(Optimizer):
    """operators/optimizers/sgd_op.cc: ``param - lr * grad``."""

    def _apply_one(self, index, param, grad, lr):
        return param - lr * grad


class Momentum(Optimizer):
    """operators/optimizers/momentum_op.cc (+ ``use_nesterov``): velocity
    ``v = mu * v + g``, then ``param - lr * v`` (Nesterov: ``param - lr *
    (g + mu * v)``), through the fused in-place kernel unless
    ``FLAGS_use_fused_optimizer`` is off."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None, use_nesterov=False,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    _ACCUMULATORS = ("velocity",)

    def _fused_decay_coeff(self):
        # only a plain, non-zero L2Decay folds into the kernel, and only
        # without a clip: the clip must see the decayed gradient
        if (not flag("use_fused_optimizer") or self._grad_clip is not None
                or type(self._weight_decay) is not L2Decay or not self._weight_decay.coeff):
            return None
        return self._weight_decay.coeff

    def _apply_all(self, params_grads, lr):
        """With ``FLAGS_use_fused_optimizer`` on, every parameter with a
        gradient goes to the multi-tensor kernel in one call (a launch per
        :data:`~paddle_tpu_torch.ops.cuda.optimizer_update.MAX_TENSORS`
        parameters on the card); off, one plain update each. A parameter
        with its own ``regularizer`` (applied in ``step``) goes to a call
        of its own without the folded decay."""
        if not flag("use_fused_optimizer"):
            return super()._apply_all(params_grads, lr)
        vel = self._ensure_accumulator("velocity")
        wd = self._fused_decay_coeff() or 0.0
        groups = {}
        for i, p, g in params_grads:
            own = wd and getattr(p, "regularizer", None) is not None
            groups.setdefault(0.0 if own else wd, []).append((i, p, g))
        for coeff, group in groups.items():
            _update.fused_momentum_update_multi(
                [p for _, p, _ in group], [g for _, _, g in group], [vel[i] for i, _, _ in group],
                lr, momentum=self._momentum, weight_decay=coeff, use_nesterov=self._use_nesterov)

    def _apply_one(self, index, param, grad, lr):
        vel = self._ensure_accumulator("velocity")
        v = self._momentum * vel[index] + grad
        vel[index].copy_(v)
        if self._use_nesterov:
            return param - lr * (grad + self._momentum * v)
        return param - lr * v


def _bias_correction(beta, t):
    """``1 - beta**t`` as a float32 0-dim tensor on ``t``'s device, the
    power correctly rounded: ``beta`` rounded to float32 and widened, raised
    to the int32 ``t`` in float64 (about a double ulp from the exact power
    on the card and on the CPU), rounded once to float32, subtracted from 1
    in float32. It equals the JAX step's float32 value (glibc's ``powf`` on
    the CPU) at every ``t`` up to 100,000 for beta 0.9, 0.98 and 0.99; for
    0.999 at all but t = 2958 and 3606, where ``powf`` misrounds by an ulp
    (``tests/test_torch_serving_compiled.py``)."""
    b = torch.full((), beta, dtype=torch.float32, device=t.device).double()
    return 1 - (b ** t.double()).float()


def _bias_corrections(opt, betas):
    """``1 - beta**t`` for each of ``betas``: float64 from ``opt``'s host
    step count, or float32 0-dim tensors from its device one, as the JAX
    train step computes them (a weak ``beta`` to the power of its int32
    ``_global_step``: float32). On the CPU that is torch's float32 ``pow``
    of a float32 ``beta`` and an int32 ``t``, bit-equal to the JAX step's.
    On the card, :func:`_bias_correction`: CUDA's float32 ``pow`` rounds
    otherwise at some ``t`` (ROADMAP.md Queue C)."""
    if not opt._on_device:
        t = opt._global_step
        return tuple(1 - b**t for b in betas)
    t = opt._step_t
    if t.device.type == "cpu":
        return tuple(1 - torch.full((), b, dtype=torch.float32)**t for b in betas)
    return tuple(_bias_correction(b, t) for b in betas)


class Adam(Optimizer):
    """operators/optimizers/adam_op.cc"""

    _ACCUMULATORS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._bias_correction = None

    def _apply_all(self, params_grads, lr):
        self._bias_correction = _bias_corrections(self, (self._beta1, self._beta2))  # once a step
        super()._apply_all(params_grads, lr)

    def _apply_one(self, index, param, grad, lr):
        m = self._ensure_accumulator("moment1")[index]
        v = self._ensure_accumulator("moment2")[index]
        bc1, bc2 = self._bias_correction
        m.copy_(self._beta1 * m + (1 - self._beta1) * grad)
        v.copy_(self._beta2 * v + (1 - self._beta2) * grad * grad)
        mhat = m / bc1
        vhat = v / bc2
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
        self._lr_decay = None

    def _apply_all(self, params_grads, lr):
        # lr * coeff once a step: float32 from the device lr (the JAX train
        # step's), float64 from a Python one (its eager optimizer's)
        self._lr_decay = lr * self._wd_coeff
        super()._apply_all(params_grads, lr)

    def _apply_one(self, index, param, grad, lr):
        decay = True
        if self._apply_decay_param_fun is not None:
            decay = self._apply_decay_param_fun(self._param_names[index])
        new_param = super()._apply_one(index, param, grad, lr)
        if decay and self._wd_coeff:
            new_param = new_param - self._lr_decay * param
        return new_param


class Adagrad(Optimizer):
    """operators/optimizers/adagrad_op.cc: ``moment += g * g``, then ``param
    - lr * g / (sqrt(moment) + epsilon)``; ``moment`` starts at
    ``initial_accumulator_value``."""

    _ACCUMULATORS = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None, weight_decay=None,
                 grad_clip=None, initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _new_accumulator(self, name, param):
        return torch.full_like(param, self._init_acc)

    def _apply_one(self, index, param, grad, lr):
        acc = self._ensure_accumulator("moment")[index]
        acc.copy_(acc + grad * grad)
        return param - lr * grad / (torch.sqrt(acc) + self._epsilon)


class Adadelta(Optimizer):
    """operators/optimizers/adadelta_op.cc"""

    _ACCUMULATORS = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._epsilon, self._rho = epsilon, rho

    def _apply_one(self, index, param, grad, lr):
        avg_sq = self._ensure_accumulator("avg_squared_grad")[index]
        avg_up = self._ensure_accumulator("avg_squared_update")[index]
        avg_sq.copy_(self._rho * avg_sq + (1 - self._rho) * grad * grad)
        update = -torch.sqrt((avg_up + self._epsilon) / (avg_sq + self._epsilon)) * grad
        avg_up.copy_(self._rho * avg_up + (1 - self._rho) * update * update)
        return param + lr * update


class RMSProp(Optimizer):
    """operators/optimizers/rmsprop_op.cc (``centered``: the mean gradient's
    square taken off the mean square)."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._rho, self._epsilon, self._momentum, self._centered = rho, epsilon, momentum, centered

    def _accumulator_names(self):
        return ("mean_square", "momentum") + (("mean_grad",) if self._centered else ())

    def _apply_one(self, index, param, grad, lr):
        ms = self._ensure_accumulator("mean_square")[index]
        mom = self._ensure_accumulator("momentum")[index]
        ms.copy_(self._rho * ms + (1 - self._rho) * grad * grad)
        if self._centered:
            mg = self._ensure_accumulator("mean_grad")[index]
            mg.copy_(self._rho * mg + (1 - self._rho) * grad)
            denom = ms - mg**2 + self._epsilon
        else:
            denom = ms + self._epsilon
        mom.copy_(self._momentum * mom + lr * grad / torch.sqrt(denom))
        return param - mom


class Adamax(Optimizer):
    """operators/optimizers/adamax_op.cc: ``param - lr / (1 - beta1**t) * moment
    / (inf_norm + epsilon)``."""

    _ACCUMULATORS = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lr_step = None

    def _apply_all(self, params_grads, lr):
        self._lr_step = lr / _bias_corrections(self, (self._beta1,))[0]  # once a step
        super()._apply_all(params_grads, lr)

    def _apply_one(self, index, param, grad, lr):
        m = self._ensure_accumulator("moment")[index]
        inf_norm = self._ensure_accumulator("inf_norm")[index]
        m.copy_(self._beta1 * m + (1 - self._beta1) * grad)
        inf_norm.copy_(torch.maximum(self._beta2 * inf_norm, torch.abs(grad)))
        return param - self._lr_step * m / (inf_norm + self._epsilon)


class _NamedParameter:
    """A parameter seen with a ``name``: every other attribute is the
    parameter's."""

    __slots__ = ("name", "param")

    def __init__(self, name, param):
        self.name = name
        self.param = param

    def __getattr__(self, attr):
        return getattr(self.param, attr)


class Lamb(Optimizer):
    """operators/optimizers/lamb_op.cc: Adam's direction ``r`` plus the
    decay, ``u = r + wd * param``, scaled by the trust ratio ``|param| /
    |u|`` (1 where either norm is 0), all on the tensors' device.
    ``exclude_from_weight_decay_fn(param)`` turns the decay off for a
    parameter; it receives the parameter as a :class:`_NamedParameter`,
    whose ``name`` is the name the optimizer knows it by
    (``named_parameters()`` or ``param_{i}``; a torch tensor's own ``name``
    cannot be set) and whose other attributes are the parameter's, where
    the JAX package passes its ``Parameter`` with its process-wide
    ``name``."""

    _ACCUMULATORS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _apply_all(self, params_grads, lr):
        self._bias_correction = _bias_corrections(self, (self._beta1, self._beta2))
        super()._apply_all(params_grads, lr)

    def _apply_one(self, index, param, grad, lr):
        m = self._ensure_accumulator("moment1")[index]
        v = self._ensure_accumulator("moment2")[index]
        bc1, bc2 = self._bias_correction
        m.copy_(self._beta1 * m + (1 - self._beta1) * grad)
        v.copy_(self._beta2 * v + (1 - self._beta2) * grad * grad)
        r = (m / bc1) / (torch.sqrt(v / bc2) + self._epsilon)
        wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(
                _NamedParameter(self._param_names[index], self._parameter_list[index])):
            wd = 0.0
        update = r + wd * param
        w_norm = torch.sqrt(torch.sum(param**2))
        u_norm = torch.sqrt(torch.sum(update**2))
        ok = (w_norm > 0) & (u_norm > 0)
        # the quotient where it is taken; a 0 norm divides 1, so no NaN is
        # made that the where throws away (FLAGS_check_nan_inf sees every op)
        trust = torch.where(ok, w_norm / torch.where(ok, u_norm, torch.ones_like(u_norm)),
                            torch.ones_like(w_norm))
        return param - lr * trust * update


from .wrappers import (  # noqa: E402  (wrappers.py subclasses Optimizer)
    ExponentialMovingAverage, Lookahead, LookaheadOptimizer, ModelAverage)

__all__ += ["ExponentialMovingAverage", "ModelAverage", "Lookahead", "LookaheadOptimizer"]
