"""Predictors (``paddle_tpu/inference/predictor.py``).

Two predictors with the interface the serving stack uses
(``get_input_names``, ``get_output_names``, ``input_spec``, ``run(list of
numpy) -> list of numpy``, ``clone()``, ``store``): :class:`Predictor`
wraps an ``nn.Module`` and the ``InputSpec``s of its positional inputs;
:class:`ProgramPredictor`, which ``create_predictor(Config(dir))`` returns,
loads a saved static program (``static.io.save_inference_model`` or
``slim`` ``save_int8_model`` of either package), runs the load-time passes
and runs it with the static executor. Both run on the CUDA card unless
the caller passes ``device="cpu"``.

On the card both replay a CUDA graph per input signature (a serving
bucket): ``Predictor`` through ``framework.jit.eval_step``'s
:class:`~paddle_tpu_torch.framework.jit.EvalStepFn`, ``ProgramPredictor``
through its executor. ``store`` is that step's or executor's store of
graphs; a predictor and its clones share it, so N replicas capture each
bucket once (``paddle_tpu/inference/predictor.py:156-176``).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..device import resolve_device
from ..errors import InvalidArgumentError
from ..framework.jit import EvalStepFn
from ..jit_api import InputSpec

__all__ = ["Predictor", "Config", "ProgramPredictor", "create_predictor"]


class Predictor:
    """Runs ``module(*inputs)`` in eval mode without gradients, through an
    :class:`~paddle_tpu_torch.framework.jit.EvalStepFn`: on the card its
    first run of an input signature runs eagerly and is captured, later
    runs replay the graph.

    ``input_spec`` names and shapes the module's positional inputs;
    ``output_names`` names its outputs (a tensor or a tuple of them).
    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU. TF32 is switched off for matrix
    products and convolutions, so float32 stays float32 on the card.
    """

    def __init__(self, module, input_spec, output_names, device=None):
        self.device = resolve_device(device)
        self.input_spec = list(input_spec)
        names = [s.name for s in self.input_spec]
        if any(n is None for n in names) or len(set(names)) != len(names):
            raise InvalidArgumentError(f"every InputSpec needs a distinct name, got {names}")
        self._feed_names = names
        self._fetch_names = list(output_names)
        self._step = EvalStepFn(module.eval(), device=self.device)  # TF32 off
        self.module = self._step.model

    @property
    def store(self):
        """The graphs of this predictor and its clones."""
        return self._step.store

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def clone(self):
        """A replica sharing the module (and so its weights on the device)
        and the store of graphs: N clones serve N worker threads from one
        copy of the weights and one graph per bucket."""
        return copy.copy(self)

    def run(self, inputs):
        """``inputs``: numpy arrays in ``get_input_names()`` order. Returns
        numpy arrays in ``get_output_names()`` order."""
        if len(inputs) != len(self._feed_names):
            raise InvalidArgumentError(
                f"expected {len(self._feed_names)} inputs {self._feed_names}, got {len(inputs)}")
        return self._step.run([np.ascontiguousarray(a) for a in inputs], read=self._to_host)

    def _to_host(self, outs):
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        if len(outs) != len(self._fetch_names):
            raise InvalidArgumentError(
                f"module returned {len(outs)} outputs, expected {self._fetch_names}")
        return [o.to("cpu", copy=True).numpy() for o in outs]


class Config:
    """``AnalysisConfig`` surface: where the model lies and whether the
    load-time passes run."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self._model_dir = model_dir
        self._prog_file = prog_file
        self._params_file = params_file
        self._ir_optim = True

    def model_dir(self):
        return self._model_dir

    def switch_ir_optim(self, flag=True):
        """Toggle the load-time passes (constant folding + dead-op
        elimination)."""
        self._ir_optim = flag


class ProgramPredictor:
    """Serves a saved static program through the static executor.

    The parameters load into a scope of the predictor's own, on its device,
    with the dtypes they were saved in (int8 weights stay int8). ``clone()``
    shares program, scope and executor, so N replicas hold one copy of the
    weights and one graph per bucket. TF32 is switched off for matrix
    products and convolutions.
    """

    def __init__(self, config: Config, device=None):
        from ..static import io as static_io
        from ..static.executor import Executor, Scope
        from .passes import IrPassManager

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self._exe = Executor(device)
        self.device = self._exe.device
        self._scope = Scope()
        if config.model_dir() is None:
            raise InvalidArgumentError("Config names no model directory")
        self._program, self._feed_names, self._fetch_names = static_io.load_inference_model(
            config.model_dir(), self._exe, model_filename=config._prog_file,
            params_filename=config._params_file, scope=self._scope)
        self.pass_stats = {}
        if config._ir_optim:
            self.pass_stats = IrPassManager().apply(
                self._program, self._scope, self._feed_names, self._fetch_names, self.device)
        block = self._program.global_block()
        # the weights move to the device once, here, not on the first request
        for n in self._scope.var_names():
            self._scope.on(n, self.device)
        self.input_spec = [
            InputSpec([None if d in (-1, None) else d for d in block.var(n).shape],
                      block.var(n).dtype, n) for n in self._feed_names]

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    @property
    def store(self):
        """The executor's graphs, shared by this predictor's clones."""
        return self._exe.store

    def quant_metadata(self):
        """Scale metadata of a loaded int8 model (its ``__quant__.json``):
        bits, per-var scales, int8 weight names. None for a float model."""
        from ..slim.ptq import load_quant_metadata

        return load_quant_metadata(self.config.model_dir())

    def clone(self):
        """A replica sharing the program, the scope (and so the weights on
        the device) and the executor (and so its graphs)."""
        return copy.copy(self)

    def run(self, inputs):
        """``inputs``: numpy arrays in ``get_input_names()`` order. Returns
        numpy arrays in ``get_output_names()`` order."""
        if len(inputs) != len(self._feed_names):
            raise InvalidArgumentError(
                f"expected {len(self._feed_names)} inputs {self._feed_names}, got {len(inputs)}")
        return self._exe.run(self._program, feed=dict(zip(self._feed_names, inputs)),
                             fetch_list=self._fetch_names, scope=self._scope)


def create_predictor(config: Config, device=None) -> ProgramPredictor:
    return ProgramPredictor(config, device=device)
