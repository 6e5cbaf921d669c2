"""Static-graph op appending (``paddle_tpu/static/op_append.py``).

The mode-aware front (:mod:`paddle_tpu_torch.ops`) calls
:func:`append_static_op` when static mode is on. An output's shape and
dtype come from running the registered kernel on ``meta`` tensors (the
counterpart of ``jax.eval_shape``; ``ops/registry.py`` ``eval_meta``), so
the only hand-written shape rules are those of the ops whose kernels
cannot run there; a dynamic (-1) axis stands in as an unusual prime and is
restored.
An op without tensor inputs (a random op's ``shape`` attribute) runs there
under ``torch.device("meta")``, so shape inference draws nothing.

A random op (:data:`RNG_OPS`) gets the JAX package's ``__rng__`` and
``__rng_id__`` attributes: the id is the op's place among the program's
random ops, fixed at build time, and the executor keys the op's draws by
it, so a ``grad::`` op (which copies the forward's attributes) takes back
the forward's draws.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..errors import InvalidArgumentError
from ..ops.registry import eval_meta
from ..framework.dtype import dtype_name, torch_dtype
from .program import Variable, default_main_program

__all__ = ["append_static_op", "capture_constant", "named_tensors"]

# the random ops of the registry (``paddle_tpu/static/op_append.py:29-32``)
RNG_OPS = {"dropout", "uniform_random", "gaussian_random", "truncated_gaussian_random"}

# stands in for a -1 (batch) axis during the abstract run
_DYN = 83

_GLOBAL_CONST_ID = [0]

# id(tensor) -> (tensor, variable name) while a layer is captured by name
_named: dict = {}


@contextlib.contextmanager
def named_tensors(mapping):
    """Inside the block, an op given one of ``mapping``'s tensors (name ->
    tensor: a layer's parameters and buffers) reads a persistable variable
    of that name in the program's global block, made on first use, instead
    of a captured constant: ``jit.save`` stores the values in the
    parameters file only, under the layer's own names."""
    _named.update({id(t): (t, name) for name, t in mapping.items()})
    try:
        yield
    finally:
        for t in mapping.values():
            _named.pop(id(t), None)


def _input_name(t, block):
    hit = _named.get(id(t))
    if hit is None or hit[0] is not t:
        return capture_constant(t, block).name
    name = hit[1]
    gb = block.program.global_block()
    if name not in gb.vars:
        gb.create_var(name=name, shape=list(t.shape), dtype=dtype_name(t.dtype),
                      persistable=True)
    return name


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


def append_static_op(op_type, tensors, attrs, alias_outputs=None):
    """Append an OpDesc to the current block; returns its output Variable(s).
    ``alias_outputs`` (output index -> variable name) makes an output an
    existing variable the op also reads (batch norm's running statistics),
    recorded in the ``__inplace__`` attribute."""
    prog = default_main_program()
    block = prog.current_block()
    tensors = [t if isinstance(t, (Variable, torch.Tensor)) else torch.as_tensor(t)
               for t in tensors]
    in_names = [t.name if isinstance(t, Variable) else _input_name(t, block) for t in tensors]
    metas = [_meta_of(t) for t in tensors]
    try:
        out = eval_meta(op_type, metas, attrs)
    except Exception as e:  # noqa: BLE001 — any kernel error is a shape-inference failure here
        raise InvalidArgumentError(
            f"shape inference failed for operator {op_type!r} with input shapes "
            f"{[tuple(m.shape) for m in metas]}: {e}") from e
    multi = isinstance(out, (tuple, list))
    any_dynamic = any(isinstance(t, Variable) and t.shape and
                      any(d in (-1, None) for d in t.shape) for t in tensors)
    out_vars = []
    for i, o in enumerate(list(out) if multi else [out]):
        if alias_outputs and i in alias_outputs:
            out_vars.append(block.var(alias_outputs[i]))
            continue
        shape = [(-1 if (any_dynamic and d == _DYN) else d) for d in o.shape]
        var = block.create_var(name=prog._unique_name(op_type), shape=shape,
                               dtype=dtype_name(o.dtype))
        var.stop_gradient = all((not isinstance(t, Variable)) or t.stop_gradient
                                for t in tensors) or not o.dtype.is_floating_point
        out_vars.append(var)
    desc_attrs = dict(attrs)
    if alias_outputs:
        desc_attrs["__inplace__"] = sorted(alias_outputs.values())
    if op_type in RNG_OPS:
        desc_attrs["__rng__"] = True
        desc_attrs["__rng_id__"] = prog._rng_counter
        prog._rng_counter += 1
    block.append_op(op_type, {"X": in_names}, {"Out": [v.name for v in out_vars]}, desc_attrs)
    return tuple(out_vars) if multi else out_vars[0]
