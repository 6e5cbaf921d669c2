"""Predictors (``paddle_tpu/inference/predictor.py``).

Two predictors with the interface the serving stack uses
(``get_input_names``, ``get_output_names``, ``input_spec``, ``run(list of
numpy) -> list of numpy``, ``clone()``, ``store``): :class:`Predictor`
wraps an ``nn.Module`` and the ``InputSpec``s of its positional inputs;
:class:`ProgramPredictor`, which ``create_predictor(Config(dir))`` returns,
loads a saved static program (``static.io.save_inference_model`` or
``slim`` ``save_int8_model`` of either package), runs the load-time passes
(constant folding and dead-op elimination, ``paddle_tpu/inference/
predictor.py:118-130``) and runs it with the static executor, whose gates
verify it, rewrite its fusible chains onto the fused ops (and so the
hand-written kernels) and plan its memory at each new signature. Both run on the CUDA card unless
the caller passes ``device="cpu"``.

On the card both replay a CUDA graph per input signature (a serving
bucket): ``Predictor`` through ``framework.jit.eval_step``'s
:class:`~paddle_tpu_torch.framework.jit.EvalStepFn`, ``ProgramPredictor``
through its executor. ``store`` is that step's or executor's store of
graphs; a predictor and its clones share it, so N replicas capture each
bucket once (``paddle_tpu/inference/predictor.py:156-176``).

Paddle's inference surface (``paddle_tpu/inference/predictor.py:12-197``):
``Config`` (``AnalysisConfig``) says where the model lies, whether the
load-time passes run and, through ``disable_gpu()``, that the predictor
runs on the CPU (the card otherwise, ``enable_use_gpu(device_id=)`` naming
which); its switches with no effect on the port warn. A
``ProgramPredictor`` also has :class:`PredictorTensor` handles: stage each
input with ``get_input_handle(name).copy_from_cpu(array)``, call ``run()``
and read ``get_output_handle(name).copy_to_cpu()``. Each clone has handles
of its own.
"""
from __future__ import annotations

import copy
import warnings

import numpy as np
import torch

from ..device import resolve_device
from ..errors import InvalidArgumentError
from ..framework.jit import EvalStepFn
from ..jit_api import InputSpec

__all__ = ["Predictor", "Config", "PredictorTensor", "ProgramPredictor", "create_predictor"]


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


def _compat_noop(name, why):
    """A ``Config`` switch the port accepts and cannot act on warns instead
    of doing nothing silently."""
    warnings.warn(f"inference.Config.{name} has no effect on the port's runtime: {why}",
                  stacklevel=3)


class Config:
    """``AnalysisConfig`` surface (paddle_analysis_config.h): where the model
    lies, whether the load-time passes run, and the device: the card unless
    :meth:`disable_gpu` asks for the CPU."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self._model_dir = model_dir
        self._prog_file = prog_file
        self._params_file = params_file
        self._use_gpu = True
        self._device_id = None  # the current card
        self._ir_optim = True

    def set_model(self, model_dir, params_file=None):
        self._model_dir = model_dir
        self._params_file = params_file

    def model_dir(self):
        return self._model_dir

    def enable_use_gpu(self, memory_pool_mb=100, device_id=0):
        """Run on card ``device_id``. The memory pool is the caching
        allocator's, which sizes itself: ``memory_pool_mb`` is not kept."""
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        """Run on the CPU."""
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def device(self):
        """``"cpu"``, ``"cuda:<id>"``, or None for the current card."""
        if not self._use_gpu:
            return "cpu"
        return None if self._device_id is None else f"cuda:{self._device_id}"

    def switch_ir_optim(self, flag=True):
        """Toggle the load-time passes (constant folding + dead-op
        elimination)."""
        self._ir_optim = flag

    def enable_memory_optim(self, flag=True):
        _compat_noop("enable_memory_optim",
                     "each captured graph has its own memory pool, and the executor's "
                     "memory plan already reuses activations")

    def set_cpu_math_library_num_threads(self, n):
        _compat_noop("set_cpu_math_library_num_threads",
                     "torch's host threads are the process's (torch.set_num_threads)")

    def enable_tensorrt_engine(self, *a, **k):
        _compat_noop("enable_tensorrt_engine",
                     "there is no TensorRT; the program runs the port's kernels in a CUDA graph")

    def enable_mkldnn(self, *a, **k):
        _compat_noop("enable_mkldnn", "no MKLDNN on this runtime")


class PredictorTensor:
    """An input or output handle (PaddleTensor / ZeroCopyTensor): a host
    array staged for :meth:`ProgramPredictor.run` or read from it."""

    def __init__(self, name):
        self.name = name
        self._data = None

    def copy_from_cpu(self, arr):
        arr = np.asarray(arr)
        # sliced views and big-endian arrays (network or file decoders) are
        # caller data the feed copies into shape
        if not arr.dtype.isnative:
            arr = arr.astype(arr.dtype.newbyteorder("="))
        self._data = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        return np.asarray(self._data)

    def reshape(self, shape):
        if self._data is not None:
            self._data = self._data.reshape(shape)

    def shape(self):
        return list(self._data.shape) if self._data is not None else None


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
        self._new_handles()

    def _new_handles(self):
        self._inputs = {n: PredictorTensor(n) for n in self._feed_names}
        self._outputs = {n: PredictorTensor(n) for n in self._fetch_names}

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

    def get_input_handle(self, name):
        return self._inputs[name]

    get_input_tensor = get_input_handle

    def get_output_handle(self, name):
        return self._outputs[name]

    get_output_tensor = get_output_handle

    def clone(self):
        """A replica sharing the program, the scope (and so the weights on
        the device) and the executor (and so its graphs), with handles of
        its own."""
        new = copy.copy(self)
        new._new_handles()
        return new

    def run(self, inputs=None):
        """``run(inputs)``: ``inputs`` numpy arrays in ``get_input_names()``
        order; returns numpy arrays in ``get_output_names()`` order and
        touches no handle, so threads may share the predictor. ``run()``:
        the inputs staged in the input handles; the outputs go into the
        output handles and are returned too."""
        if inputs is None:
            feed = {n: self._inputs[n]._data for n in self._feed_names}
            for n, v in feed.items():
                if v is None:
                    raise InvalidArgumentError(f"input {n!r} not set: copy_from_cpu first")
            outs = self._exe.run(self._program, feed=feed, fetch_list=self._fetch_names,
                                 scope=self._scope)
            for n, o in zip(self._fetch_names, outs):
                self._outputs[n]._data = o
            return outs
        if len(inputs) != len(self._feed_names):
            raise InvalidArgumentError(
                f"expected {len(self._feed_names)} inputs {self._feed_names}, got {len(inputs)}")
        return self._exe.run(self._program, feed=dict(zip(self._feed_names, inputs)),
                             fetch_list=self._fetch_names, scope=self._scope)


def create_predictor(config: Config, device=None) -> ProgramPredictor:
    """A :class:`ProgramPredictor` of ``config``: on ``device`` when given,
    else where the config says (the card unless ``disable_gpu()``)."""
    return ProgramPredictor(config, device=config.device() if device is None else device)
