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

The optimizer's accumulators are made when the step is built, as the JAX
step's ``init_opt_state`` makes them (``:205-248``), so the state has its
full shape from the start.

``FLAGS_check_nan_inf`` (``:445-518``): with the flag on, a call runs the
``checked`` variant of the step, a graph of its own, in which every op
(and every hand-written kernel) is tested for NaN (``framework/nan_inf.py``).
The state (parameters, buffers, accumulators, the device step count) is
copied aside before the step; after it the host reads the verdict, and a
NaN under ``check_nan_inf_action=raise`` copies the state back and raises
``FatalError`` naming the first op that made one: the model and the
optimizer are then as they were before the step, as the JAX step, which
does not donate its state there, leaves them.

Checkpoints (``:562-576``): :meth:`TrainStepFn.save_checkpoint` and
:meth:`TrainStepFn.load_checkpoint` write and read the JAX step's state
layout (``distributed/checkpoint.py``) under its leaf names
(:meth:`TrainStepFn.state_leaves`); a load copies into the live tensors, so
no graph is captured again.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.utils.checkpoint

from ..device import resolve_device
from ..errors import FatalError
from ..flags import flag
from ..monitor import flight_recorder as _flight
from ..runtime.compiled import GraphStore, clone_outputs, compiled_step, precision_key
from . import nan_inf
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
        optimizer._init_accumulators()
        # parameters the loss never reads (no gradient after the first
        # backward): the JAX step's frozen ones (_freeze_unused_params)
        self._unused = None
        # the checked variant's verdict on the device, the names of its ops
        # (per signature) and the copy of the state it restores from
        self._nan_found = torch.zeros((), dtype=torch.bool, device=self.device)
        self._nan_first = torch.zeros((), dtype=torch.int64, device=self.device)
        self._nan_names = []
        self._names_of = {}
        self._saved = None

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
        checked = bool(flag("check_nan_inf"))
        if checked:
            saved = self._save_state()
        if capture:
            loss = self._compiled(variant, batch, checked)
        elif self.jit:
            with compiled_step():
                loss = self.store.run_eager(self._sig(variant, batch, checked),
                                            lambda: self._run(variant, batch, checked), batch)
        else:
            loss = self._run(variant, batch, checked)
        if checked:
            self._judge(saved)
        self._calls_in_window = 0 if applies else self._calls_in_window + 1
        # the hang watchdog's progress: the step's host boundary, no device sync
        _flight.notify_progress("train_step")
        return {"loss": loss}

    def _sig(self, variant, batch, checked):
        return ((self._instance, len(self.optimizer._parameter_list), variant, checked,
                 precision_key()) + _signature(batch))

    def _compiled(self, variant, batch, checked=False):
        opt = self.optimizer
        sig = self._sig(variant, batch, checked)
        entry = self.store.lookup(sig)
        if entry is not None:
            out = self.store.replay(entry, *batch, read=clone_outputs)
            self._nan_names = self._names_of.get(sig, [])
            if variant != "accumulate":
                opt._global_step += 1  # the host's count; the graph advanced the device's
            return out
        inputs = [b.clone() for b in batch]  # the graph's static inputs
        with compiled_step():
            loss = self.store.first_run(
                sig, self.device,
                lambda: _first_run(self.device, lambda: self._run(variant, inputs, checked)),
                inputs)
            host_step, names = opt._global_step, self._nan_names
            try:
                self.store.capture(sig, lambda *x: self._run(variant, x, checked), inputs,
                                   _random.graph_generators(self.device))
                self._names_of[sig] = self._nan_names
            finally:
                opt._global_step = host_step  # the capture ran no step
                self._nan_names = names  # the verdict read next is the first run's
        return loss

    def _run(self, variant, batch, checked):
        """:meth:`_body`, under :class:`~paddle_tpu_torch.framework.nan_inf.NanCheck`
        when ``checked``, its verdict then written into the step's two
        device scalars."""
        if not checked:
            return self._body(variant, batch)
        with nan_inf.NanCheck() as check:
            loss = self._body(variant, batch)
        check.verdict_into(self._nan_found, self._nan_first)
        self._nan_names = check.names
        return loss

    def _state_tensors(self):
        """Every tensor of the step's state: parameters, buffers,
        accumulators, the device step count and the gradient-merge
        buffers."""
        opt = self.optimizer
        ts = {id(t): t for t in (*self.model.parameters(), *opt._parameter_list,
                                 *self.model.buffers())}
        for accs in opt._accumulators.values():
            ts.update((id(a), a) for a in accs)
        for t in (opt._step_t, *(self._acc or ())):
            if t is not None:
                ts[id(t)] = t
        return list(ts.values())

    def _save_state(self):
        """Copy the state aside (into buffers kept between calls) for a
        checked step; returns what :meth:`_restore` takes."""
        live = self._state_tensors()
        if self._saved is None or len(self._saved[0]) != len(live) or any(
                a is not b for a, b in zip(self._saved[0], live)):
            self._saved = (live, [torch.empty_like(t) for t in live])
        with torch.no_grad():
            torch._foreach_copy_(self._saved[1], live)
        return self.optimizer._global_step

    def _restore(self, host_step):
        with torch.no_grad():
            torch._foreach_copy_(self._saved[0], self._saved[1])
        self.optimizer._global_step = host_step

    def _judge(self, host_step):
        """After a checked step: one read of the verdict; on a NaN, the
        ``check_nan_inf_action`` policy, the state restored unless it is
        ``warn``."""
        if not bool(self._nan_found):
            return
        op = self._nan_names[int(self._nan_first)]
        detail = (f"non-finite value produced inside the train step: nan generated by "
                  f"primitive: {op}.")
        try:
            action = nan_inf.nan_event_action("train_step", detail)
        except Exception:
            self._restore(host_step)
            raise
        if action is not None:
            self._restore(host_step)
            raise FatalError(f"check_nan_inf: {detail}")

    def _body(self, variant, batch):
        """One step of ``variant`` ("step", "accumulate" or "apply") on
        ``batch``: the loss, detached."""
        opt = self.optimizer
        opt.clear_grad()
        self.model.train()
        loss = self._forward(batch)
        loss.backward()
        if self._unused is None:
            self._unused = {n for n, p in self.model.named_parameters()
                            if p.requires_grad and p.grad is None}
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

    def state_leaves(self):
        """``[(name, tensor)]``: the step's state under the leaf names of
        the JAX step's state pytree (``jax.tree_util.keystr`` of
        ``TrainStepFn.state``), in its flattening order: ``['buffers'][n]``,
        ``['frozen'][n]`` (parameters that do not require grad, then those
        the loss never reads), ``['gm']`` (gradient merge), ``['opt']
        ['accums'][acc][i]`` and ``['opt']['step']``, ``['params'][n]``.
        The step count and the merge count are int32 0-dim tensors made
        from the host's counts; the rest are the live tensors."""
        def key(*ks):
            return "".join(f"[{k!r}]" for k in ks)

        opt = self.optimizer
        named = list(self.model.named_parameters())
        unused = self._unused or set()
        frozen = ([(n, p) for n, p in named if not p.requires_grad]
                  + [(n, p) for n, p in named if p.requires_grad and n in unused])
        params = [(n, p) for n, p in named if p.requires_grad and n not in unused]
        out = [(key("buffers", n), b) for n, b in self.model.named_buffers()]
        out += [(key("frozen", n), p) for n, p in frozen]
        if self._acc is not None:
            acc_of = {id(p): a for p, a in zip(opt._parameter_list, self._acc)}
            out += [(key("gm", "acc", n), acc_of[id(p)]) for n, p in params]
            out.append((key("gm", "count"),
                        torch.tensor(self._calls_in_window, dtype=torch.int32)))
        for name in sorted(opt._accumulators):
            out += [(key("opt", "accums", name, i), a)
                    for i, a in enumerate(opt._accumulators[name])]
        out.append((key("opt", "step"), torch.tensor(opt._global_step, dtype=torch.int32)))
        out += [(key("params", n), p) for n, p in params]
        return out

    def load_state_leaves(self, flat):
        """Copy ``flat`` (leaf name -> array or tensor, every name of
        :meth:`state_leaves` and no other, each of its shape) into the live
        state, and set the host and device step counts (and the merge
        count) from it. Raises ``KeyError`` or ``ValueError`` before
        anything is written."""
        leaves = self.state_leaves()
        names = [n for n, _ in leaves]
        missing, extra = sorted(set(names) - set(flat)), sorted(set(flat) - set(names))
        if missing or extra:
            raise KeyError(f"missing={missing[:5]} extra={extra[:5]}")
        for name, t in leaves:
            if tuple(np.shape(flat[name])) != tuple(t.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(np.shape(flat[name]))} != "
                                 f"live state shape {tuple(t.shape)}")
        opt = self.optimizer
        with torch.no_grad():
            for name, t in leaves:
                v = flat[name]
                v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
                if name == "['opt']['step']":
                    opt._global_step = int(v)
                    if opt._step_t is not None:
                        opt._step_t.fill_(opt._global_step)
                elif name == "['gm']['count']":
                    self._calls_in_window = int(v)
                else:
                    t.copy_(v)

    def save_checkpoint(self, path, step=None, async_=None, keep=None):
        """Snapshot the step's state (``distributed/checkpoint.py``; async
        by default, ``FLAGS_checkpoint_async``)."""
        from ..distributed import checkpoint as _ckpt

        return _ckpt.save_train_step(self, path, step=step, async_=async_, keep=keep)

    def load_checkpoint(self, path):
        """Restore a snapshot written by ``save_checkpoint`` (of either
        package) into the live state; returns the manifest."""
        from ..distributed import checkpoint as _ckpt

        return _ckpt.restore_train_step(self, path)


class EvalStepFn:
    """``step(*batch)``: ``fn(model, *batch)`` (default ``model(*batch)``)
    in eval mode without gradients, the model's training mode restored
    after. With ``jit=True`` on the card, one captured graph per input
    signature (shapes, dtypes and :func:`~paddle_tpu_torch.runtime.compiled.precision_key`),
    through a store of captured steps as the train step's; replays hand
    back copies of the outputs. Threads may call one step together (the
    clones of a ``Predictor`` do): a signature is captured once, and each
    replay answers its own input. A signature whose first run read values
    on the host (a ``to_static`` forward's ``while`` on a tensor, its
    ``print`` or ``assert``: ``runtime.compiled.host_read``) is never
    captured: each later call runs ``fn`` eagerly on the device
    (``GraphStore.run_eager``: no capture lock, no copy of the inputs, no
    device synchronize), and ``store.uncaptured`` counts the runs."""

    def __init__(self, model, fn=None, jit=True, device=None):
        self.device = resolve_device(device)
        _set_precision()
        self.model = model.to(self.device)
        self.fn = fn
        self.jit = bool(jit)
        self.store = GraphStore("eval_step")
        self._instance = next(_instances)

    def _run(self, batch, fn=None):
        fn = fn or self.fn
        with torch.no_grad():
            return fn(self.model, *batch) if fn is not None else self.model(*batch)

    def __call__(self, *batch):
        return self.run(batch)

    def run(self, batch, read=None, key=(), fn=None):
        """The step on ``batch`` (tensors or numpy arrays), its outputs
        passed through ``read`` (a copy to the host, say; by default a
        replay's outputs are cloned and an eager run's returned as they
        are). A captured signature's inputs may stay on the host: the
        replay copies them into its static buffers. ``fn`` (``fn(model,
        *batch)``) replaces the step's own for this call, and ``key`` is
        the part of the signature that only it sees (the constants a
        ``to_static`` forward takes beside its tensors), which a captured
        graph bakes in."""
        keep = (lambda out: out) if read is None else read
        was_training = self.model.training
        self.model.eval()
        try:
            if not self.jit:
                return keep(self._run([_to_device(b, self.device) for b in batch], fn))
            batch = [torch.from_numpy(np.ascontiguousarray(b)) if isinstance(b, np.ndarray)
                     else b for b in batch]
            sig = (self._instance, precision_key()) + tuple(key) + _signature(batch)
            store = self.store
            entry = None
            if _captures(self.device) and not store.runs_uncaptured(sig):
                entry = store.find(sig)
                if entry is None:
                    with store.capturing:
                        entry = store.lookup(sig)
                        if entry is None and not store.runs_uncaptured(sig):
                            inputs = [b.to(self.device, copy=True) for b in batch]
                            with compiled_step():
                                out = store.first_run(
                                    sig, self.device,
                                    lambda: _first_run(self.device,
                                                       lambda: self._run(inputs, fn)),
                                    inputs)
                                store.capture(sig, lambda *x: self._run(x, fn), inputs,
                                              _random.graph_generators(self.device))
                            return keep(out)
            if entry is None:
                # the CPU, or a signature whose runs read the host: eagerly at every call
                batch = [_to_device(b, self.device) for b in batch]
                with compiled_step():
                    return keep(store.run_eager(sig, lambda: self._run(batch, fn), batch))
            return store.replay(entry, *batch, read=read or clone_outputs)
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
