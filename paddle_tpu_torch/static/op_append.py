"""Static-graph op appending (``paddle_tpu/static/op_append.py``).

The mode-aware front (:mod:`paddle_tpu_torch.ops`) calls
:func:`append_static_op` when static mode is on. An output's shape and
dtype come from running the registered kernel on ``meta`` tensors (the
counterpart of ``jax.eval_shape``), so there are no hand-written shape
rules; a dynamic (-1) axis stands in as an unusual prime and is restored.
"""
from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidArgumentError
from ..ops.registry import kernel
from ..framework.dtype import dtype_name, torch_dtype
from .program import Variable, default_main_program

__all__ = ["append_static_op", "capture_constant"]

# stands in for a -1 (batch) axis during the abstract run
_DYN = 83

_GLOBAL_CONST_ID = [0]


def _meta_of(t):
    if isinstance(t, Variable):
        shape = [_DYN if d in (-1, None) else d for d in (t.shape or [])]
        return torch.empty(shape, dtype=torch_dtype(t.dtype), device="meta")
    return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")


def capture_constant(t, block=None):
    """Capture an eager tensor (or array) as a persistable constant
    Variable, named uniquely across programs."""
    prog = default_main_program()
    block = block or prog.current_block()
    arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    _GLOBAL_CONST_ID[0] += 1
    cname = prog._unique_name(f"const{_GLOBAL_CONST_ID[0]}")
    cvar = block.create_var(name=cname, shape=list(arr.shape), dtype=dtype_name(arr.dtype),
                            persistable=True)
    prog._constants[cname] = arr
    return cvar


def append_static_op(op_type, tensors, attrs):
    """Append an OpDesc to the current block; returns its output Variable(s)."""
    prog = default_main_program()
    block = prog.current_block()
    tensors = [t if isinstance(t, (Variable, torch.Tensor)) else torch.as_tensor(t)
               for t in tensors]
    in_names = [t.name if isinstance(t, Variable) else capture_constant(t, block).name
                for t in tensors]
    metas = [_meta_of(t) for t in tensors]
    try:
        out = kernel(op_type)(*metas, **attrs)
    except Exception as e:  # noqa: BLE001 — any kernel error is a shape-inference failure here
        raise InvalidArgumentError(
            f"shape inference failed for operator {op_type!r} with input shapes "
            f"{[tuple(m.shape) for m in metas]}: {e}") from e
    multi = isinstance(out, (tuple, list))
    any_dynamic = any(isinstance(t, Variable) and t.shape and
                      any(d in (-1, None) for d in t.shape) for t in tensors)
    out_vars = []
    for o in (list(out) if multi else [out]):
        shape = [(-1 if (any_dynamic and d == _DYN) else d) for d in o.shape]
        var = block.create_var(name=prog._unique_name(op_type), shape=shape,
                               dtype=dtype_name(o.dtype))
        var.stop_gradient = all((not isinstance(t, Variable)) or t.stop_gradient
                                for t in tensors) or not o.dtype.is_floating_point
        out_vars.append(var)
    block.append_op(op_type, {"X": in_names}, {"Out": [v.name for v in out_vars]}, dict(attrs))
    return tuple(out_vars) if multi else out_vars[0]
