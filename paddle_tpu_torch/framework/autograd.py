"""Gradient switches and the AMP cast seam of the port's ops
(``paddle_tpu/framework/autograd.py``).

``no_grad``, ``enable_grad``, ``is_grad_enabled`` and ``grad`` are
``torch.autograd``'s: torch records the tape the JAX package keeps by hand
(``:32``, ``:241``). ``no_grad`` works as a context manager and as a
decorator.

The AMP cast seam (``:84-104``):

The JAX package casts an op's inputs where it dispatches the op
(``apply_op`` consults ``_amp_hook``); the port runs torch eagerly and has
no dispatcher, so every port op calls :func:`amp_cast` with the JAX op
type's name (``"linear"``, ``"matmul"``, ``"cross_entropy"``, ...) and
computes on what it returns. :mod:`paddle_tpu_torch.amp` installs the hook
that casts by the active ``auto_cast`` scope; with no hook, or outside a
scope, the tensors come back unchanged. Casts are ``Tensor.to``, so
autograd carries them: an f32 parameter cast to bf16 for a white op
receives its gradient in f32.
"""
from __future__ import annotations

import torch

__all__ = ["set_amp_hook", "amp_cast", "no_grad", "enable_grad", "is_grad_enabled", "grad"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


def grad(outputs, inputs, grad_outputs=None, retain_graph=False, allow_unused=False):
    """The gradients of ``outputs`` with respect to ``inputs`` (a list, one
    entry an input; None for an input ``outputs`` does not reach when
    ``allow_unused``), leaving every ``.grad`` as it was."""
    from .tensor import wrap

    outputs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is not None and not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    try:
        got = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                                  retain_graph=retain_graph, allow_unused=allow_unused)
    except RuntimeError as e:
        if "not have been used in the graph" in str(e):
            raise RuntimeError("one of the inputs has no gradient; pass allow_unused=True") from e
        raise
    return [None if g is None else wrap(g) for g in got]

# (op_type, tensors) -> tensors; installed by paddle_tpu_torch.amp
_amp_hook = None


def set_amp_hook(fn):
    global _amp_hook
    _amp_hook = fn


def amp_cast(op_type, tensors):
    """``tensors`` (a list or tuple; ``None`` entries pass through) as the
    op ``op_type`` takes them under the active AMP scope."""
    if _amp_hook is None:
        return list(tensors)
    return list(_amp_hook(op_type, list(tensors)))
