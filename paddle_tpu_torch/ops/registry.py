"""Op registry (``paddle_tpu/ops/registry.py``), the port's own copy.

A kernel is a function ``fn(*tensors, **attrs) -> tensor | tuple`` over
torch tensors, registered under the op type a saved Program names; the
static executor and the mode-aware front (:mod:`paddle_tpu_torch.ops`) look
it up here. Positional arguments are tensor inputs, keyword arguments the
op's attributes, as in the JAX package, so an ``OpDesc`` either package
wrote runs in the other.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

from ..errors import UnimplementedError

__all__ = ["OpDef", "register_op", "get_op", "kernel", "has_op", "all_ops"]


class OpDef(NamedTuple):
    name: str
    fn: Callable
    num_outputs: int


_REGISTRY: Dict[str, OpDef] = {}


def register_op(name: str, num_outputs: int = 1):
    """Decorator: register a kernel under an op type name."""

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"op {name!r} registered twice")
        _REGISTRY[name] = OpDef(name, fn, num_outputs)
        return fn

    return deco


def get_op(name: str) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnimplementedError(
            f"op {name!r} has no kernel in paddle_tpu_torch; ported: {sorted(_REGISTRY)}") from None


def kernel(name: str) -> Callable:
    return get_op(name).fn


def has_op(name: str) -> bool:
    return name in _REGISTRY


def all_ops():
    return dict(_REGISTRY)
