"""The AMP cast seam of the port's ops (``paddle_tpu/framework/autograd.py:84-104``).

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

__all__ = ["set_amp_hook", "amp_cast"]

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
