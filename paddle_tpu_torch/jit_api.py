"""``paddle.jit``: ``to_static``, ``save``, ``load`` (``paddle_tpu/jit_api.py``).

- :func:`to_static` first rewrites the function, or a layer's bound
  forward (its ``__func__``, bound to the layer again), through the AST
  pass (:mod:`paddle_tpu_torch.dygraph_to_static`, ``paddle_tpu/jit_api.py:47-58``):
  value-dependent ``if``, ``while``, ``for ... in range``, ``break``,
  ``continue`` and ``return`` become calls of the runtime converters.
- A layer's forward then runs through ``framework.jit.eval_step`` (eval
  mode, no gradients); a function through a
  ``runtime.compiled.GraphStore`` of its own (:attr:`StaticFunction.store`).
  Every tensor of a call, also inside its tuples, lists and dicts, is an
  input of the graph; a signature is the tensors' shapes and dtypes and
  the values of the other arguments, which may be numbers, strings and
  ``None`` (anything else raises ``TypeError``: a graph would bake it in);
  a layer's keyword arguments are part of its ``eval_step`` signature.
  On the card one CUDA graph is captured per signature after an eager
  first run and replayed after; an ``if`` on a tensor runs both branches
  and selects on the device, so one graph replays either branch. A
  signature whose run reads values on the host (a ``while`` on a tensor,
  a ``print`` or an ``assert`` of one) is never captured: each later call
  runs it eagerly on the card (``GraphStore.run_eager``), and
  ``store.uncaptured`` counts those runs.
  On the CPU every call runs eagerly as a compiled step's body, with the
  same converters. Any other read of values on the host (``item()``,
  ``numpy()``) raises inside the compiled step
  (:class:`~paddle_tpu_torch.framework.tensor.Tensor`'s host reads refuse
  there).
- :func:`save` runs the layer's forward once in static mode over
  ``static.data`` feeds (``paddle_tpu/jit_api.py:120-168``); a
  ``to_static`` layer's through the converted forward, as the JAX package
  does. The mode-aware ``nn.functional`` appends the program, whose
  parameters and buffers are persistable variables under the layer's own
  names (``conv1.weight``, ``bn1._mean``). It writes the inference-model
  layout (``__model__``, ``__params__``), which
  ``static.load_inference_model``, ``inference.create_predictor`` and
  either package's :func:`load` read.
- :func:`load` returns a :class:`TranslatedLayer` running the saved
  program through the static executor.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .framework.tensor import Tensor, wrap
from .nn.layer_base import Layer

__all__ = ["InputSpec", "StaticFunction", "to_static", "save", "load", "TranslatedLayer"]


class InputSpec:
    """The name, shape and dtype of one model input; ``None`` (or -1)
    marks the batch axis, which serving fills with a bucket size."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    @classmethod
    def from_tensor(cls, t, name=None):
        return cls(list(t.shape), str(t.dtype).replace("torch.", ""), name)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"


def _device():
    from .framework.place import default_device

    return default_device()


class StaticFunction:
    """The ``@to_static`` wrapper of a function or a layer's forward, both
    rewritten by ``dygraph_to_static.convert_to_static``."""

    def __init__(self, function, input_spec=None):
        from .dygraph_to_static import convert_to_static
        from .runtime.compiled import GraphStore

        bound_self = getattr(function, "__self__", None)
        base = getattr(function, "__func__", function)
        transformed = convert_to_static(base)
        if transformed is not base:
            function = transformed.__get__(bound_self) if bound_self is not None else transformed
        self._function = function
        self._input_spec = input_spec
        self._step = None  # a layer's eval_step
        self.store = GraphStore("to_static")

    def __call__(self, *args, **kwargs):
        layer = getattr(self._function, "__self__", None)
        if isinstance(layer, torch.nn.Module):
            return self._call_layer(layer, args, kwargs)
        return self._call_function(args, kwargs)

    def _call_layer(self, layer, args, kwargs):
        from .framework import jit as fjit

        tensors, key, rebuild = _split(args, kwargs)
        if self._step is None:
            self._step = fjit.eval_step(layer, device=_device())
            self.store = self._step.store

        def fn(model, *xs):
            a, kw = rebuild([wrap(x) for x in xs])
            return self._function(*a, **kw)

        return wrap(self._step.run([t.detach() for t in tensors], key=key, fn=fn))

    def _call_function(self, args, kwargs):
        from .framework import jit as fjit
        from .framework import random as _random
        from .runtime.compiled import clone_outputs, compiled_step, precision_key

        device = _device()
        tensors, key, rebuild = _split(args, kwargs)
        tensors = [wrap(t.to(device)) for t in tensors]
        sig = (precision_key(),) + key + fjit._signature(tensors)

        def fn(*xs):
            a, kw = rebuild([wrap(x) for x in xs])
            return self._function(*a, **kw)

        store = self.store
        entry = None
        if fjit._captures(device) and not store.runs_uncaptured(sig):
            entry = store.find(sig)
            if entry is None:
                with store.capturing:
                    entry = store.lookup(sig)
                    if entry is None and not store.runs_uncaptured(sig):
                        inputs = [wrap(t.detach().clone()) for t in tensors]
                        with compiled_step():
                            out = store.first_run(
                                sig, device,
                                lambda: fjit._first_run(device, lambda: fn(*inputs)), inputs)
                            store.capture(sig, fn, inputs, _random.graph_generators(device))
                        return out
        if entry is None:
            # the CPU, or a signature whose runs read the host: eagerly at every call
            with compiled_step():
                return store.run_eager(sig, lambda: fn(*tensors), tensors)
        return wrap(store.replay(entry, *tensors, read=clone_outputs))


# the leaves of a to_static call that are constants of its signature, keyed by value
_CONSTANTS = (bool, int, float, str, type(None))


def _split(args, kwargs):
    """``(tensors, key, rebuild)`` of a ``to_static`` call: the tensors
    anywhere in its arguments (numpy arrays made tensors), which become a
    graph's inputs; the signature's key of everything else (the tree's
    structure and its ``bool``, ``int``, ``float``, ``str`` and ``None``
    leaves, by type and value), which a graph bakes in; and ``rebuild(xs)
    -> (args, kwargs)`` with ``xs`` in the tensors' places. Any other leaf
    (a layer, an object) raises ``TypeError``: a graph would bake it in, and
    its value has no key."""
    from .dygraph_to_static import _flatten, _unflatten

    leaves, spec = _flatten((tuple(args), dict(kwargs)))
    slots, tensors, key = [], [], []
    for i, v in enumerate(leaves):
        if isinstance(v, (np.ndarray, np.generic)):
            v = torch.from_numpy(np.array(v))
        if isinstance(v, torch.Tensor):
            slots.append(i)
            tensors.append(v)
        elif isinstance(v, _CONSTANTS):
            key.append((i, type(v).__name__, repr(v)))
        else:
            raise TypeError(f"a to_static function takes tensors, numpy arrays, Python "
                            f"numbers, strings and None (in tuples, lists and dicts), got "
                            f"{type(v).__name__}: a captured graph would bake it in")
    _keyed_spec(spec)

    def rebuild(xs):
        full = list(leaves)
        for i, x in zip(slots, xs):
            full[i] = x
        return _unflatten(spec, full)

    return tensors, (repr(spec),) + tuple(key), rebuild


def _keyed_spec(spec):
    """Raises ``TypeError`` unless every dict key in ``spec`` is one of
    :data:`_CONSTANTS`, so that the spec's ``repr`` keys its structure."""
    if spec is None:
        return
    _, keys, subs = spec
    for k in keys or ():
        if not isinstance(k, _CONSTANTS):
            raise TypeError(f"a to_static function's dict arguments take keys of "
                            f"{', '.join(t.__name__ for t in _CONSTANTS)}, got "
                            f"{type(k).__name__}")
    for sub in subs:
        _keyed_spec(sub)


def to_static(function=None, input_spec=None, **kwargs):
    """``@paddle.jit.to_static``: a function becomes a :class:`StaticFunction`;
    a layer keeps itself with its forward wrapped."""
    def deco(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = StaticFunction(fn.forward, input_spec)
            return fn
        return StaticFunction(fn, input_spec)

    return deco(function) if function is not None else deco


def save(layer, path, input_spec=None):
    """Capture ``layer`` (eval mode) as a static inference program over
    ``input_spec`` and write it to the directory ``path``. Returns the
    directory."""
    from . import static
    from .static.op_append import named_tensors

    if input_spec is None:
        raise ValueError("jit.save requires input_spec")
    call = layer
    if isinstance(getattr(layer, "forward", None), StaticFunction):
        call = layer.forward._function
    state = {}
    if isinstance(layer, torch.nn.Module):
        state = dict(layer.named_parameters())
        state.update(layer.named_buffers())
    was_training = getattr(layer, "training", False)
    if isinstance(layer, torch.nn.Module):
        layer.eval()
    prog, startup, feed_names = static.Program(), static.Program(), []
    try:
        with static.program_guard(prog, startup), named_tensors(state):
            static.enable_static()
            feeds = []
            for i, spec in enumerate(input_spec):
                name = spec.name or f"x{i}"
                feed_names.append(name)
                feeds.append(static.data(name, [-1 if d is None else d for d in spec.shape],
                                         spec.dtype))
            outs = call(*feeds)
            outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    finally:
        static.disable_static()
        if was_training:
            layer.train()
    scope = static.Scope()
    block = prog.global_block()
    for name, t in state.items():
        if name in block.vars:
            scope.set(name, t.detach().cpu().numpy())
    dirname = path if os.path.isdir(path) or not os.path.splitext(path)[1] else \
        os.path.dirname(path)
    static.save_inference_model(dirname, feed_names, outs, None, main_program=prog,
                                scope=scope)
    return dirname


class TranslatedLayer(Layer):
    """``jit.load``'s result: a layer running a saved inference program on
    the default place (the card unless ``set_device("cpu")``)."""

    def __init__(self, dirname):
        super().__init__()
        from . import static

        self._exe = static.Executor(_device())
        self._scope = static.Scope()
        self._program, self._feed_names, self._fetch_names = static.load_inference_model(
            dirname, self._exe, scope=self._scope)

    def forward(self, *args):
        feed = {name: a.detach() if isinstance(a, torch.Tensor) else np.asarray(a)
                for name, a in zip(self._feed_names, args)}
        outs = self._exe.run(self._program, feed=feed, fetch_list=self._fetch_names,
                             scope=self._scope, return_numpy=False)
        outs = [wrap(o) if isinstance(o, torch.Tensor) and not isinstance(o, Tensor) else o
                for o in outs]
        return outs[0] if len(outs) == 1 else tuple(outs)


def load(path):
    return TranslatedLayer(path)
