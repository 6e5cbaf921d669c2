"""Static-graph executor (``paddle_tpu/static/executor.py``): an interpreter, captured once per signature on the card.

The interpreter (:meth:`Executor._interpret`) walks the program's global
block op by op, looks each op up in the registry and keeps the values in a
dictionary. The JAX executor lowers a whole block to one compiled module
per (plan key, fetch names, feed names, feed shapes and dtypes,
persistables) through its ``CompiledStore`` (``:699-760, 860-890``). On
the card the port interprets the first run of each signature eagerly and
captures that interpretation into a CUDA graph over static feed buffers
(``runtime/compiled.py`` ``GraphStore("executor")``, one per executor);
later runs of the signature copy their feeds in and replay it. The
signature is the program's ``_identity_token`` and ``_version``, the fetch
and feed names, each feed's shape and dtype after the block's cast, the
TF32 settings and the scope's identity and generation. A capture or replay
that fails raises ``CaptureError``; nothing runs eagerly in its place. On
the CPU every run is the interpreter.

Scope values are torch tensors on the executor's device: the CUDA card
unless the caller names another (no card and no name raises), and a value
set from the host moves there once, when it is first read, not per run. A
graph reads the scope's tensors where they lay at its capture, so
replacing a value (:meth:`Scope.set` of a name already there, or
:meth:`Scope.clear`) starts a new generation and the next run captures
again. Control-flow ops (``while``, ``cond``, ``scan``) raise
``UnimplementedError``.

Training programs (``append_backward``, the static optimizers): a
``grad::<type>`` op re-runs the registered forward kernel on its inputs
under autograd and takes ``torch.autograd.grad`` with the out-gradients
(:func:`run_grad_op`), as the JAX executor takes ``jax.vjp``
(``:568-614``). A value an op writes to a persistable variable (a
parameter, a velocity or moment, ``adam_step``) is what later ops of the
run read, and at the end of the run it is copied into the scope's own
tensor (``copy_``), never put in its place: a graph then updates the
scope at each replay, and the scope's generation does not move.

``FLAGS_check_nan_inf`` (``:972-980``, ``:1075-1100``): with the flag on,
the run scans what it fetched and the persistables it wrote for NaN/Inf
(``isfinite``, so an inf counts) before they are written back, names the
first bad variable and the op that wrote it, and acts by
``FLAGS_check_nan_inf_action`` (``framework/nan_inf.py``); on ``raise``
the scope keeps its values from before the run. A captured run keeps one
graph, which then returns the written values instead of writing them:
they are scanned after the replay and copied into the scope after the
scan.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..device import resolve_device
from ..errors import (FatalError, InvalidArgumentError, NotFoundError, UnimplementedError,
                      op_error_context)
from ..flags import flag
from ..framework import nan_inf
from ..framework.dtype import torch_dtype
from ..framework.jit import _captures, _first_run, _signature
from ..ops.registry import kernel
from ..runtime.compiled import GraphStore, clone_outputs, compiled_step, precision_key
from .program import default_main_program, default_startup_program

__all__ = ["Scope", "global_scope", "Executor", "run_grad_op"]

_BLOCK_OPS = ("while", "cond", "scan")

_scope_tokens = itertools.count()


class Scope:
    """name -> tensor map (``framework/scope.h``). ``_token`` names the
    scope for the life of the process; ``_generation`` grows whenever a
    value a graph may have read is replaced or dropped."""

    def __init__(self):
        self._vars: dict = {}
        self._token = next(_scope_tokens)
        self._generation = 0

    def set(self, name, value):
        """Store ``value`` (a tensor, or anything ``torch.as_tensor`` takes;
        numpy arrays are copied) under ``name``; replacing a value starts a
        new generation."""
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.array(value))
        if name in self._vars:
            self._generation += 1
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
        self._generation += 1


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


class Executor:
    """Runs programs on ``device`` (``None``: the CUDA card, or raise);
    on the card through :attr:`store`, a graph per signature."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.store = GraphStore("executor")  # shared by a predictor's clones
        self._written_of = {}  # sig -> names of the written values a scanned graph returns

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
        """Run ``program``'s global block on ``feed`` (name -> array or
        tensor) and return the fetched values, numpy arrays on the host
        unless ``return_numpy=False`` (then tensors on the device, copies
        of a graph's outputs)."""
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        fetch_names = [v if isinstance(v, str) else v.name for v in (fetch_list or [])]
        block = program.global_block()
        for cname, cval in program._constants.items():
            if not scope.has(cname):
                scope.set(cname, cval)
        names = list(feed)
        values = []
        for name, value in feed.items():
            dtype = torch_dtype(block.var(name).dtype) if block.has_var(name) else None
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.ascontiguousarray(value))
            values.append(value.to(dtype=dtype))
        read = _to_host if return_numpy else clone_outputs
        scan = bool(flag("check_nan_inf"))
        written_names = []  # with scan: the names of the written values the run returns

        def interpret(*feeds):
            return self._interpret(block, dict(zip(names, feeds)), scope, fetch_names,
                                   written_names if scan else None)

        def scanned(out):
            fetched, written = out[:len(fetch_names)], dict(zip(written_names,
                                                                out[len(fetch_names):]))
            if self._scan_nan_inf(program, fetch_names, fetched, written):
                self._write_back(scope, written)
            return read(fetched)

        if not _captures(self.device):
            out = interpret(*[v.to(self.device) for v in values])
            return scanned(out) if scan else read(out)
        sig = ((program._identity_token, program._version, tuple(fetch_names), tuple(names))
               + _signature(values) + (precision_key(), scope._token, scope._generation, scan))
        store = self.store
        entry = store.find(sig)
        if entry is None:
            with store.capturing:
                entry = store.lookup(sig)
                if entry is None:
                    inputs = [v.to(self.device, copy=True) for v in values]
                    with compiled_step():
                        out = _first_run(self.device, lambda: interpret(*inputs))
                        store.capture(sig, interpret, inputs)
                    self._written_of[sig] = list(written_names)
                    return scanned(out) if scan else read(out)
        if scan:
            written_names[:] = self._written_of[sig]
            return scanned(store.replay(entry, *values, read=clone_outputs))
        return store.replay(entry, *values, read=read)

    def _write_back(self, scope, written):
        """Copy each written persistable into the scope's own tensor (set
        it, where the scope has none)."""
        for n, v in written.items():
            if scope.has(n):
                scope.on(n, self.device).copy_(v)
            else:
                scope.set(n, v)

    @staticmethod
    def _scan_nan_inf(program, fetch_names, fetches, written):
        """The post-run scan: True when every fetched and written floating
        value is finite, or when ``warn`` lets a bad one pass; else raises
        ``FatalError`` naming the first bad variable and the op that wrote
        it (``paddle_tpu/static/executor.py`` ``_scan_nan_inf``)."""
        bad = next((name for name, t in [*zip(fetch_names, fetches), *written.items()]
                    if t.is_floating_point() and not bool(torch.isfinite(t).all())), None)
        if bad is None:
            return True
        if nan_inf.nan_event_action(
                f"var:{bad}", f"variable {bad!r} contains NaN/Inf after the block ran") is None:
            return True
        producer = next((op for op in program.global_block().ops
                         if bad in [n for ns in op.outputs.values() for n in ns]), None)
        raise FatalError(f"check_nan_inf: variable {bad!r} contains NaN/Inf after the block ran",
                         op_context=op_error_context(producer) if producer is not None else None)

    def _interpret(self, block, env, scope, fetch_names, written_names=None):
        """The global block's ops on ``env`` (the feeds, on the device):
        the fetched tensors, written back into the scope. With
        ``written_names`` (a list, filled here) the written persistables
        are not written back but returned after the fetches, their names in
        ``written_names``. The one body of a CPU run, a first run and a
        capture."""
        def value_of(name):
            if name in env:
                return env[name]
            if scope.has(name):
                return scope.on(name, self.device)
            raise InvalidArgumentError(
                f"variable {name!r} is neither fed, computed by an earlier op, nor in the scope")

        written = {}  # persistable name -> its value after the run
        for op in block.ops:
            if op.type.removeprefix("grad::") in _BLOCK_OPS:
                raise UnimplementedError(
                    f"control-flow op {op.type!r} is not ported: the executor interprets "
                    "the global block only")
            attrs = {k: v for k, v in op.attrs.items() if not k.startswith("__")}
            in_names = op.inputs.get("X", [])
            out_names = op.outputs.get("Out", [])
            if op.type.startswith("grad::"):
                n_in = op.attrs["__n_fwd_in__"]
                results = run_grad_op(
                    op.type[len("grad::"):], attrs, [value_of(n) for n in in_names[:n_in]],
                    [env.get(n) if n else None for n in in_names[n_in:]],
                    [bool(n) for n in out_names])
            else:
                out = kernel(op.type)(*[value_of(n) for n in in_names], **attrs)
                results = list(out) if isinstance(out, (tuple, list)) else [out]
            for n, v in zip(out_names, results):
                if not n or v is None:
                    continue
                env[n] = v
                if block.has_var(n) and block.var(n).persistable:
                    written[n] = v
        fetched = [value_of(n) for n in fetch_names]
        if written_names is not None:
            written_names[:] = list(written)
            return fetched + list(written.values())
        self._write_back(scope, written)
        return fetched


def run_grad_op(fwd_type, attrs, fwd_in, out_grads, wanted):
    """The gradients a ``grad::<fwd_type>`` op computes: the registered
    forward kernel run again under autograd on ``fwd_in`` (the inputs
    ``wanted`` marks, if floating, require grad), then ``torch.autograd.grad``
    of its floating outputs with ``out_grads`` (None: zeros; an integer
    output takes none). One entry per forward input: its gradient, zeros
    where the output does not depend on it, None where it is not wanted or
    not floating (labels, indices)."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_() if want and x.dtype.is_floating_point else x
                  for x, want in zip(fwd_in, wanted)]
        out = kernel(fwd_type)(*inputs, **attrs)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        ys, cots = [], []
        for i, o in enumerate(outs):
            if not (o.dtype.is_floating_point and o.requires_grad):
                continue
            g = out_grads[i] if i < len(out_grads) else None
            ys.append(o)
            cots.append(torch.zeros_like(o) if g is None else g.to(o.dtype))
        diff = [x for x in inputs if x.requires_grad]
        grads = (torch.autograd.grad(ys, diff, cots, allow_unused=True) if ys and diff
                 else [None] * len(diff))
    it = iter(grads)
    results = []
    for x in inputs:
        if not x.requires_grad:
            results.append(None)
            continue
        g = next(it)
        results.append(torch.zeros_like(x) if g is None else g)
    return results


def _to_host(fetched):
    """The fetches as numpy arrays of their own (a CPU tensor's ``numpy()``
    would share the memory a later replay rewrites)."""
    return [t.to("cpu", copy=True).numpy() for t in fetched]
