"""``paddle.jit``: ``to_static``, ``save``, ``load`` (``paddle_tpu/jit_api.py``).

- :func:`to_static` of a ``Layer`` routes its forward through
  ``framework.jit.eval_step``: on the card one CUDA graph is captured per
  input signature and replayed after (eval mode, no gradients), on the CPU
  the forward runs eagerly as a compiled step's body.
- :func:`to_static` of a function captures it once per input signature
  into a ``runtime.compiled.GraphStore`` and replays the graph after. A
  function that reads values on the host (``if x.sum() > 0:``, ``item()``)
  raises when it is captured (:class:`~paddle_tpu_torch.framework.tensor.Tensor`'s
  host reads refuse inside a compiled step), and is never run eagerly in
  its place. Python control flow that depends on values needs the AST
  pass of the JAX package (``dygraph_to_static.py``), which is not ported.
- :func:`save` runs the layer's forward once in static mode over
  ``static.data`` feeds (``paddle_tpu/jit_api.py:120-168``): the
  mode-aware ``nn.functional`` appends the program, whose parameters and
  buffers are persistable variables under the layer's own names
  (``conv1.weight``, ``bn1._mean``). It writes the inference-model layout
  (``__model__``, ``__params__``), which ``static.load_inference_model``,
  ``inference.create_predictor`` and either package's :func:`load` read.
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
    """The ``@to_static`` wrapper of a function or a layer's forward."""

    def __init__(self, function, input_spec=None):
        from .runtime.compiled import GraphStore

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

        if self._step is None:
            fn = self._function
            self._step = fjit.eval_step(layer, fn=lambda m, *a: fn(*a, **kwargs),
                                        device=_device())
            self.store = self._step.store
        return wrap(self._step(*[a.detach() if isinstance(a, torch.Tensor) else a
                                 for a in args]))

    def _call_function(self, args, kwargs):
        from .framework import jit as fjit
        from .framework import random as _random
        from .runtime.compiled import clone_outputs, compiled_step, precision_key

        device = _device()
        batch = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a for a in args]
        batch = [wrap(b.to(device)) if isinstance(b, torch.Tensor) else b for b in batch]
        if not fjit._captures(device):
            with compiled_step():
                return self._function(*batch, **kwargs)
        sig = (precision_key(), repr(sorted(kwargs.items()))) + fjit._signature(batch)
        entry = self.store.find(sig)
        if entry is None:
            with self.store.capturing:
                entry = self.store.lookup(sig)
                if entry is None:
                    inputs = [wrap(b.detach().clone()) for b in batch]
                    fn = lambda *x: self._function(*[wrap(t) for t in x], **kwargs)  # noqa: E731
                    with compiled_step():
                        out = self.store.first_run(
                            sig, device, lambda: fjit._first_run(device, lambda: fn(*inputs)),
                            inputs)
                        self.store.capture(sig, fn, inputs, _random.graph_generators(device))
                    return out
        return wrap(self.store.replay(entry, *batch, read=clone_outputs))


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
