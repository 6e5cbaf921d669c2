"""The compiled training and inference steps (``paddle_tpu/framework/jit.py`` ``train_step``, ``eval_step``).

The JAX package traces a step once per batch signature into one compiled
XLA program and replays it (``TrainStepFn``, ``:250-312``, through the
shared ``CompiledStore``). The port's counterpart of "trace once, replay"
is a CUDA graph, kept in a store of captured steps
(``runtime/compiled.py``):

- ``jit=True`` on the card: the first call of a batch signature runs the
  step eagerly, on a side stream, as the real first step; that run also
  builds the kernels and the cuBLAS and cuDNN plans. The step is then
  captured into the store (capture runs nothing). Every later call of the
  signature copies the batch into the graph's static inputs, writes the lr
  and replays the graph. No step is run twice or thrown away. A step that
  cannot be captured, or a replay that fails, raises: nothing gives way to
  eager.
- ``jit=True`` on the CPU: the same step runs eagerly at every call, as
  the caller asked for the CPU; the CPU has no graphs.
- ``jit=False``: the eager sequence at every call.

With ``jit=True`` the optimizer takes its step count and lr, inside the
step, from tensors on the step's device (``Optimizer._use_device_scalars``,
``_scalars_on_device``), as the JAX compiled step traces its int32
``_global_step`` and float32 ``lr`` (``:155-173, 441``): AdamW's ``1 -
beta**t`` and ``lr * coeff`` are then float32 computations, as there, and
a replay reads the lr written before it. With ``jit=False``, and in the
optimizer's own ``step()`` outside a train step, they stay Python
numbers, the eager optimizer's.
Gradients live in the graph's memory pool; the step sets them to None only
at its start, where the capture records it, never between replays.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.utils.checkpoint

from ..device import resolve_device
from ..runtime.compiled import GraphStore, clone_outputs, compiled_step, precision_key
from . import random as _random

__all__ = ["TrainStepFn", "EvalStepFn", "train_step", "eval_step"]

# deterministic instance ids: a step's cache keys name it, as the JAX
# package's _step_fn_counter does
_instances = itertools.count()


def _set_precision():
    """float32 stays float32 on the card: no TF32 in matrix products or
    convolutions, and no reduced-precision reduction of bf16 products, so a
    bf16 product's split-K sums stay f32 as the JAX package's
    ``preferred_element_type=f32`` keeps them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _to_device(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device) if isinstance(x, torch.Tensor) else x


def _signature(batch):
    """The shapes and dtypes of a compiled step's inputs (all tensors)."""
    for b in batch:
        if not isinstance(b, torch.Tensor):
            raise TypeError(f"a compiled step takes tensors or numpy arrays, got {type(b)}")
    return tuple((tuple(b.shape), str(b.dtype)) for b in batch)


def _captures(device) -> bool:
    """Whether a compiled step on ``device`` captures graphs: on a CUDA
    device; the CPU runs the step eagerly."""
    return device.type == "cuda"


def _first_run(device, fn):
    """``fn()`` on a side stream, then the device synchronized: the eager
    first run of a signature before its capture (PyTorch's warm-up rule
    for graphs)."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    torch.cuda.synchronize(device)
    return out


class TrainStepFn:
    """``step(*batch) -> {"loss": tensor}``: one step of ``model`` on
    ``loss_fn(model, *batch)``: the gradients set to None, the forward and
    loss in train mode, the backward, the optimizer. Numpy or CPU inputs
    move to the step's device; the model moves there once, at
    construction, with TF32 off (:func:`_set_precision`). AMP is the
    caller's: ``loss_fn`` may run the model under ``amp.auto_cast``.

    ``recompute``: the forward runs under ``torch.utils.checkpoint`` (its
    activations recomputed in the backward, as ``jax.checkpoint``); the
    recomputed forward takes back the first forward's random draws
    (``framework.random.Tape``) and leaves the buffers as the first
    forward left them. ``grad_accum_steps = k``: each call adds its
    gradients to a buffer; every k-th call also applies the optimizer to
    the sum (divided by k with ``grad_accum_avg``) and zeroes the buffer,
    as the JAX step's ``lax.cond`` does (``:391-405``); compiled, the two
    kinds of call are two captured variants chosen by the call count.
    ``donate`` is accepted for the JAX signature and not kept: the state is
    updated in place, which is what donation buys there."""

    def __init__(self, model, optimizer, loss_fn, jit=True, donate=True, recompute=False,
                 grad_accum_steps=1, grad_accum_avg=True, device=None):
        self.device = resolve_device(device)
        _set_precision()
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.jit = bool(jit)
        self.recompute = bool(recompute)
        self.grad_accum_steps = int(grad_accum_steps)
        if self.grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        self.grad_accum_avg = bool(grad_accum_avg)
        if self.jit:
            optimizer._use_device_scalars(self.device)
        self._calls_in_window = 0  # calls since the optimizer last applied
        self._acc = self._k = None
        if self.grad_accum_steps > 1:
            self._acc = [torch.zeros_like(p) for p in optimizer._parameter_list]
            self._k = torch.tensor(float(self.grad_accum_steps), device=self.device)
        self.store = GraphStore("train_step")
        self._instance = next(_instances)

    def __call__(self, *batch):
        return self._step(batch, capture=self.jit and _captures(self.device))

    def eager(self, *batch):
        """One call of this step run eagerly, where ``__call__`` would
        replay a graph: the same arithmetic on the same state, the control
        a captured step is held against."""
        return self._step(batch, capture=False)

    def _step(self, batch, capture):
        batch = [_to_device(b, self.device) for b in batch]
        applies = self._calls_in_window + 1 >= self.grad_accum_steps
        variant = "step" if self.grad_accum_steps == 1 else ("apply" if applies else
                                                             "accumulate")
        if applies and self.jit:
            self.optimizer._write_lr()
        if capture:
            loss = self._compiled(variant, batch)
        elif self.jit:
            with compiled_step():
                loss = self._body(variant, batch)
        else:
            loss = self._body(variant, batch)
        self._calls_in_window = 0 if applies else self._calls_in_window + 1
        return {"loss": loss}

    def _compiled(self, variant, batch):
        opt = self.optimizer
        sig = ((self._instance, len(opt._parameter_list), variant, precision_key())
               + _signature(batch))
        entry = self.store.lookup(sig)
        if entry is not None:
            out = self.store.replay(entry, *batch, read=clone_outputs)
            if variant != "accumulate":
                opt._global_step += 1  # the host's count; the graph advanced the device's
            return out
        inputs = [b.clone() for b in batch]  # the graph's static inputs
        with compiled_step():
            loss = _first_run(self.device, lambda: self._body(variant, inputs))
            host_step = opt._global_step
            try:
                self.store.capture(sig, lambda *x: self._body(variant, x), inputs,
                                   _random.graph_generators(self.device))
            finally:
                opt._global_step = host_step  # the capture ran no step
        return loss

    def _body(self, variant, batch):
        """One step of ``variant`` ("step", "accumulate" or "apply") on
        ``batch``: the loss, detached."""
        opt = self.optimizer
        opt.clear_grad()
        self.model.train()
        loss = self._forward(batch)
        loss.backward()
        if variant == "step":
            with opt._scalars_on_device(self.jit):
                opt.step()
            return loss.detach()
        params = opt._parameter_list
        for p, acc in zip(params, self._acc):
            if p.grad is not None:
                acc.add_(p.grad.to(acc.dtype))
        if variant == "apply":
            for p, acc in zip(params, self._acc):
                if p.grad is not None:
                    p.grad = acc / self._k if self.grad_accum_avg else acc
            with opt._scalars_on_device(self.jit):
                opt.step()
            for acc in self._acc:
                acc.zero_()
        return loss.detach()

    def _forward(self, batch):
        if not self.recompute:
            return self.loss_fn(self.model, *batch)
        tape = _random.Tape()
        buffers = list(self.model.buffers())

        def run(*inputs):
            # the recomputation leaves the buffers (batch-norm statistics)
            # as the first forward left them
            saved = None if tape.draws is None else [b.clone() for b in buffers]
            try:
                with _random.taped(tape):
                    return self.loss_fn(self.model, *inputs)
            finally:
                if saved is not None:
                    for b, s in zip(buffers, saved):
                        b.copy_(s)

        return torch.utils.checkpoint.checkpoint(run, *batch, use_reentrant=False,
                                                 preserve_rng_state=False)

    def sync(self):
        """API parity with the JAX package, whose compiled step keeps its
        state apart from the model: here the model and optimizer are the
        state, updated in place, so there is nothing to write back."""
        return self


class EvalStepFn:
    """``step(*batch)``: ``fn(model, *batch)`` (default ``model(*batch)``)
    in eval mode without gradients, the model's training mode restored
    after. With ``jit=True`` on the card, one captured graph per input
    signature (shapes, dtypes and :func:`~paddle_tpu_torch.runtime.compiled.precision_key`),
    through a store of captured steps as the train step's; replays hand
    back copies of the outputs. Threads may call one step together (the
    clones of a ``Predictor`` do): a signature is captured once, and each
    replay answers its own input."""

    def __init__(self, model, fn=None, jit=True, device=None):
        self.device = resolve_device(device)
        _set_precision()
        self.model = model.to(self.device)
        self.fn = fn
        self.jit = bool(jit)
        self.store = GraphStore("eval_step")
        self._instance = next(_instances)

    def _run(self, batch):
        with torch.no_grad():
            return self.fn(self.model, *batch) if self.fn is not None else self.model(*batch)

    def __call__(self, *batch):
        return self.run(batch)

    def run(self, batch, read=None):
        """The step on ``batch`` (tensors or numpy arrays), its outputs
        passed through ``read`` (a copy to the host, say; by default a
        replay's outputs are cloned and an eager run's returned as they
        are). A captured signature's inputs may stay on the host: the
        replay copies them into its static buffers."""
        keep = (lambda out: out) if read is None else read
        was_training = self.model.training
        self.model.eval()
        try:
            if not (self.jit and _captures(self.device)):
                batch = [_to_device(b, self.device) for b in batch]
                if not self.jit:
                    return keep(self._run(batch))
                with compiled_step():
                    return keep(self._run(batch))
            batch = [torch.from_numpy(np.ascontiguousarray(b)) if isinstance(b, np.ndarray)
                     else b for b in batch]
            sig = (self._instance, precision_key()) + _signature(batch)
            entry = self.store.find(sig)
            if entry is None:
                with self.store.capturing:
                    entry = self.store.lookup(sig)
                    if entry is None:
                        inputs = [b.to(self.device, copy=True) for b in batch]
                        with compiled_step():
                            out = _first_run(self.device, lambda: self._run(inputs))
                            self.store.capture(sig, lambda *x: self._run(x), inputs,
                                               _random.graph_generators(self.device))
                        return keep(out)
            return self.store.replay(entry, *batch, read=read or clone_outputs)
        finally:
            if was_training:
                self.model.train()


def train_step(model, optimizer, loss_fn, jit=True, donate=True, recompute=False,
               grad_accum_steps=1, grad_accum_avg=True, device=None) -> TrainStepFn:
    """Build a train step; ``loss_fn(model, *batch) -> scalar loss``.
    ``device=None`` means the CUDA card and raises without one."""
    return TrainStepFn(model, optimizer, loss_fn, jit=jit, donate=donate, recompute=recompute,
                       grad_accum_steps=grad_accum_steps, grad_accum_avg=grad_accum_avg,
                       device=device)


def eval_step(model, fn=None, jit=True, device=None) -> EvalStepFn:
    """Build an inference step: ``step(*batch)`` returns ``fn(model,
    *batch)`` (default: the model's forward) in eval mode. ``device=None``
    means the CUDA card and raises without one."""
    return EvalStepFn(model, fn=fn, jit=jit, device=device)
