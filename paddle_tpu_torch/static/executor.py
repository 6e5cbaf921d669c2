"""Static-graph executor (``paddle_tpu/static/executor.py``): an eager interpreter.

``Executor.run`` walks the program's global block op by op, looks each op
up in the registry and keeps the values in a dictionary. The JAX executor
lowers a whole block to one compiled module behind plan and executable
caches; this card's counterpart of that (a CUDA graph per feed shape) is
not ported, so there is nothing to cache or count here and every op is one
or more launches. Scope values are torch tensors on the executor's device:
the CUDA card unless the caller names another (no card and no name
raises), and a value set from the host moves there once, when it is first
read, not per run. Control-flow ops (``while``, ``cond``, ``scan``) raise
``UnimplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..errors import InvalidArgumentError, NotFoundError, UnimplementedError
from ..framework.dtype import torch_dtype
from ..ops.registry import kernel
from .program import default_main_program, default_startup_program

__all__ = ["Scope", "global_scope", "Executor"]

_BLOCK_OPS = ("while", "cond", "scan")


class Scope:
    """name -> tensor map (``framework/scope.h``)."""

    def __init__(self):
        self._vars: dict = {}

    def set(self, name, value):
        """Store ``value`` (a tensor, or anything ``torch.as_tensor`` takes;
        numpy arrays are copied) under ``name``."""
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.array(value))
        self._vars[name] = value if isinstance(value, torch.Tensor) else torch.as_tensor(value)

    def get(self, name):
        try:
            return self._vars[name]
        except KeyError:
            raise NotFoundError(f"variable {name!r} is not in the scope") from None

    def on(self, name, device):
        """The value of ``name`` on ``device``; a value that lies elsewhere
        moves there and stays."""
        t = self.get(name)
        if t.device != device:
            t = t.to(device)
            self._vars[name] = t
        return t

    def numpy(self, name):
        return self.get(name).detach().cpu().numpy()

    def has(self, name):
        return name in self._vars

    def var_names(self):
        return list(self._vars)

    def clear(self):
        self._vars.clear()


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


class Executor:
    """Runs programs on ``device`` (``None``: the CUDA card, or raise)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())

    def run_startup(self, startup_program=None, scope=None):
        """Run the startup program's ``init_param`` ops: each parameter not
        yet in the scope is drawn by its initializer."""
        startup_program = startup_program or default_startup_program()
        scope = scope or global_scope()
        for op in startup_program.global_block().ops:
            if op.type != "init_param":
                raise UnimplementedError(
                    f"startup op {op.type!r}: only init_param is ported")
            name = op.outputs["Out"][0]
            if not scope.has(name):
                scope.set(name, op.attrs["initializer"](op.attrs["shape"], op.attrs["dtype"]))

    @torch.no_grad()
    def run(self, program=None, feed=None, fetch_list=None, scope=None, return_numpy=True):
        """Interpret ``program``'s global block on ``feed`` (name -> array or
        tensor) and return the fetched values, numpy arrays on the host
        unless ``return_numpy=False`` (then tensors on the device)."""
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        fetch_names = [v if isinstance(v, str) else v.name for v in (fetch_list or [])]
        block = program.global_block()
        for cname, cval in program._constants.items():
            if not scope.has(cname):
                scope.set(cname, cval)
        env = {}
        for name, value in feed.items():
            dtype = torch_dtype(block.var(name).dtype) if block.has_var(name) else None
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.ascontiguousarray(value))
            env[name] = value.to(device=self.device, dtype=dtype)

        def value_of(name):
            if name in env:
                return env[name]
            if scope.has(name):
                return scope.on(name, self.device)
            raise InvalidArgumentError(
                f"variable {name!r} is neither fed, computed by an earlier op, nor in the scope")

        for op in block.ops:
            if op.type in _BLOCK_OPS:
                raise UnimplementedError(
                    f"control-flow op {op.type!r} is not ported: the executor interprets "
                    "the global block only")
            attrs = {k: v for k, v in op.attrs.items() if not k.startswith("__")}
            out = kernel(op.type)(*[value_of(n) for n in op.inputs.get("X", [])], **attrs)
            results = list(out) if isinstance(out, (tuple, list)) else [out]
            for n, v in zip(op.outputs.get("Out", []), results):
                if n:
                    env[n] = v
        fetched = [value_of(n) for n in fetch_names]
        return [t.cpu().numpy() for t in fetched] if return_numpy else fetched
