"""Op registry (``paddle_tpu/ops/registry.py``), the port's own copy.

A kernel is a function ``fn(*tensors, **attrs) -> tensor | tuple`` over
torch tensors, registered under the op type a saved Program names; the
static executor and the mode-aware front (:mod:`paddle_tpu_torch.ops`) look
it up here. Positional arguments are tensor inputs, keyword arguments the
op's attributes, as in the JAX package, so an ``OpDesc`` either package
wrote runs in the other.

Static shape inference (op appending, the verifier, the memory planner)
runs an op on ``meta`` tensors, the counterpart of ``jax.eval_shape``
(:func:`eval_meta`). A wrapper of a hand-written kernel raises on ``meta``
tensors, so an op over one registers a shape rule (:func:`register_shape`)
that computes its outputs' shapes and dtypes from the plain composition it
stands for.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple

import torch

from ..errors import UnimplementedError

__all__ = ["OpDef", "register_op", "register_shape", "get_op", "kernel", "has_op", "all_ops",
           "eval_meta", "host_read"]


class OpDef(NamedTuple):
    name: str
    fn: Callable
    num_outputs: int


_REGISTRY: Dict[str, OpDef] = {}
_SHAPE_RULES: Dict[str, Callable] = {}


def register_op(name: str, num_outputs: int = 1):
    """Decorator: register a kernel under an op type name."""

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"op {name!r} registered twice")
        _REGISTRY[name] = OpDef(name, fn, num_outputs)
        return fn

    return deco


def register_shape(name: str):
    """Decorator: the shape rule of op ``name``, ``fn(*metas, **attrs)``
    returning ``meta`` tensors of the outputs' shapes and dtypes."""

    def deco(fn):
        _SHAPE_RULES[name] = fn
        return fn

    return deco


def eval_meta(name: str, metas, attrs):
    """Op ``name``'s outputs on the ``meta`` tensors ``metas``: its shape
    rule where it has one, else its kernel run on them (under
    ``torch.device("meta")`` when the op takes no tensor)."""
    fn = _SHAPE_RULES.get(name) or kernel(name)
    with contextlib.nullcontext() if metas else torch.device("meta"):
        return fn(*metas, **attrs)


def host_read(what: str):
    """A kernel's sanctioned read of device values on the host
    (``runtime.compiled.host_read``, imported here at the call: the
    runtime imports the ops)."""
    from ..runtime.compiled import host_read as _host_read

    _host_read(what)


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
