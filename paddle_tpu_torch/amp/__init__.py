"""Automatic mixed precision (``paddle_tpu/amp/__init__.py``).

Cast at dispatch, as the JAX package does it: inside an :func:`auto_cast`
scope every port op hands its inputs to
:func:`paddle_tpu_torch.framework.autograd.amp_cast` under the JAX op
type's name, and the hook installed here casts float32 inputs of a white
op to the AMP dtype (bfloat16 by default) and AMP-dtype inputs of a black
op to float32; integer tensors and every other op pass through. ``O2``
treats every op off the black list as white. The two lists are the JAX
package's own, copied here: the port imports nothing of it.
``torch.autocast`` is not used: its lists are not these (it runs
``layer_norm`` and ``softmax`` in float32 and caches casts).

:class:`GradScaler` is the dynamic loss scaler, step for step the JAX
package's (``:128-227``): ``unscale_`` multiplies every gradient by ``1 /
scale`` and records whether any is not finite; ``step`` skips the
optimizer on such a step; ``update`` grows the scale after
``incr_every_n_steps`` good steps and shrinks it after
``decr_every_n_nan_or_inf`` bad ones. That found-inf decision is a host
``bool``: inside a compiled step (``train_step(jit=True)``) ``unscale_``
raises, as a Python ``bool`` of a tracer raises in the JAX step; a step
with a ``GradScaler`` runs with ``jit=False``. :func:`decorate` at ``O2`` casts a
model's float32 parameters to the AMP dtype unless ``master_weight`` is
set.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..framework import autograd
from ..runtime import compiled as _compiled

__all__ = ["auto_cast", "amp_guard", "GradScaler", "AmpScaler", "decorate",
           "WHITE_LIST", "BLACK_LIST"]

# matmul-class ops (fp16_lists.py's white list plus "linear", which every
# Linear layer dispatches)
WHITE_LIST = {
    "matmul", "mul", "bmm", "addmm", "einsum", "linear",
    "conv1d", "conv2d", "conv2d_transpose", "conv3d",
}
# numerically sensitive reductions and transcendentals; batch_norm and
# layer_norm are on neither list: their statistics are f32 inside the op,
# and they carry their input's dtype
BLACK_LIST = {
    "softmax_with_cross_entropy", "cross_entropy", "softmax", "log_softmax",
    "group_norm", "instance_norm",
    "exp", "log", "log2", "log10", "log1p", "logsumexp",
    "reduce_mean", "reduce_sum", "mean", "sum", "cumsum",
    "sigmoid", "erf", "pow", "rsqrt", "sqrt", "square",
}

_state = threading.local()


def _enabled():
    """The active scope ``(dtype, white, black)``, or None."""
    return getattr(_state, "amp", None)


def _is_float(t, dtype):
    return isinstance(t, torch.Tensor) and t.dtype == dtype


def _hook(op_type, tensors):
    """Cast ``tensors`` at the dispatch of ``op_type`` by the active scope."""
    scope = _enabled()
    if scope is None:
        return tensors
    dtype, white, black = scope
    if op_type in white:
        return [t.to(dtype) if _is_float(t, torch.float32) else t for t in tensors]
    if op_type in black:
        return [t.to(torch.float32) if _is_float(t, dtype) else t for t in tensors]
    return tensors


autograd.set_amp_hook(_hook)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype) or not out.is_floating_point:
        raise ValueError(f"auto_cast: {dtype!r} is not a floating dtype")
    return out


class _CastAll:
    """O2's white list: every op except the black list."""

    def __init__(self, black):
        self.black = black

    def __contains__(self, op):
        return op not in self.black


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None, level="O1",
              dtype="bfloat16"):
    """Scope in which white-listed ops run in ``dtype`` (``O1``), or every
    op off the black list (``O2``). A nested scope replaces the outer one
    and restores it on exit; ``enable=False`` leaves the outer one on."""
    if not enable:
        yield
        return
    white = set(WHITE_LIST) | set(custom_white_list or ())
    black = (set(BLACK_LIST) | set(custom_black_list or ())) - set(custom_white_list or ())
    tdtype = _torch_dtype(dtype)
    scope = (tdtype, _CastAll(black), black) if level == "O2" else (tdtype, white, black)
    prev = _enabled()
    _state.amp = scope
    try:
        yield
    finally:
        _state.amp = prev


amp_guard = auto_cast  # fluid.dygraph.amp.amp_guard


class GradScaler:
    """Dynamic loss scaler (AmpScaler, ``fluid/dygraph/amp/loss_scaler.py``).

    bf16 needs no loss scaling, but the scale, unscale, inf check and
    dynamic adjustment are kept exactly, as the JAX package keeps them."""

    def __init__(self, enable=True, init_loss_scaling=32768.0, incr_ratio=2.0, decr_ratio=0.5,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        return var * self._scale if self._enable else var

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every gradient by ``1 / scale`` (not a division: on the
        card the two round differently) and record whether any is not
        finite (``amp_check_finite_and_scale``). Raises inside a compiled
        step: the decision waits for the device, which a CUDA graph cannot."""
        if _compiled.in_compiled_step():
            raise RuntimeError("GradScaler: the found-inf decision is a host bool and cannot "
                               "run inside a compiled step (train_step(jit=True)); build the "
                               "step with jit=False")
        if not self._enable:
            self._found_inf = False
            return
        inv = 1.0 / self._scale
        finite = []
        for p in optimizer._parameter_list:
            if p.grad is None:
                continue
            p.grad = p.grad * inv
            finite.append(torch.isfinite(p.grad).all())
        self._found_inf = bool(finite) and not bool(torch.stack(finite).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def set_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


AmpScaler = GradScaler


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16", master_weight=None,
             save_dtype=None):
    """At ``O2``, cast every float32 parameter of ``models`` (a module or a
    list of them) to ``dtype`` in place, unless ``master_weight`` is set;
    buffers keep their dtype. Returns ``models``, or ``(models,
    optimizers)`` when optimizers are given."""
    if level not in ("O1", "O2"):
        raise ValueError("level must be O1 or O2")
    if level == "O2" and models is not None and not master_weight:
        target = _torch_dtype(dtype)
        for m in models if isinstance(models, (list, tuple)) else [models]:
            for p in m.parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(target)
    if optimizers is None:
        return models
    return models, optimizers
