"""Static-graph executor (``paddle_tpu/static/executor.py``): an interpreter, captured once per signature on the card.

Before a program runs, :meth:`Executor.run` passes it through the three
gates of the JAX executor (``:769-826``), in its order: the verifier
(``FLAGS_program_verify``, ``Program.verify``), the IR optimizer
(``FLAGS_ir_opt_level``, ``analysis.optimize_program``: the fusions onto
the fused registry ops and so onto the hand-written kernels, dead-op
elimination, remat at level 2) and the memory budget
(``FLAGS_memory_budget_check``, ``analysis.check_memory_budget`` against
the card's memory). They run before anything is interpreted or captured,
and the capture signature keys on the program they hand back, an
optimized clone cached per program version (or the program itself where
nothing was rewritten), so each verdict is a dictionary lookup at a
replay. After a signature's first run on the card the measured peak closes
the memory plan (``analysis.note_actual``). The interpreter frees each
value of the global block after its last read (:func:`_last_reads`), the
liveness the memory plan assumes.

The interpreter (:class:`_BlockRunner`) walks the program's global block
op by op, looks each op up in the registry and keeps the values in a
dictionary; a control-flow op runs its sub-blocks the same way. The JAX
executor lowers a whole block to one compiled module
per (plan key, fetch names, feed names, feed shapes and dtypes,
persistables) through its ``CompiledStore`` (``:699-760, 860-890``). On
the card the port interprets the first run of each signature eagerly and
captures that interpretation into a CUDA graph over static feed buffers
(``runtime/compiled.py`` ``GraphStore("executor")``, one per executor);
later runs of the signature copy their feeds in and replay it. The
signature is the program's ``_identity_token`` and ``_version``, the fetch
and feed names, each feed's shape and dtype after the block's cast, the
TF32 settings and the scope's identity and generation (which covers the
values sub-blocks read from the scope too). The capture registers the
device's generator, so random ops draw anew at every replay. A capture or
replay that fails raises ``CaptureError``; nothing runs eagerly in its
place. On the CPU every run is the interpreter.

Scope values are torch tensors on the executor's device: the CUDA card
unless the caller names another (no card and no name raises), and a value
set from the host moves there once, when it is first read, not per run. A
graph reads the scope's tensors where they lay at its capture, so
replacing a value (:meth:`Scope.set` of a name already there, or
:meth:`Scope.clear`) starts a new generation and the next run captures
again.

An op's inputs are its ``X`` slot, or, where its ``__in_slots__``
attribute names slots, those slots' variables concatenated in that order;
its outputs likewise ``Out`` or ``__out_slots__`` (``:111-130``, the
reference's named io slots). The interpreter and a ``grad::`` op read them
so, so a program the JAX package wrote with named slots runs in the port
with its gradient.

Control flow (``:357-660``): ``scan`` runs its body ``length`` times;
``cond`` runs both branches and selects with ``torch.where`` on the
predicate, which stays on the card; both are captured with the program. A
``while`` reads its predicate on the host once per iteration, so a program
that holds one (in any block) is interpreted on the card at every run,
never captured, and each such run adds one to ``store.uncaptured``. So is
a program whose first run read values on the host through an op
(``runtime.compiled.host_read``: ``print``, ``py_func``, ``tree_conv``, the
greedy NMS family): the store leaves its signature uncaptured, and each
later run is interpreted and counted the same way.
Persistables a sub-block writes (batch norm's running statistics) thread
out to the enclosing op, a loop's carried from iteration to iteration, a
``cond``'s selected like its outputs, so the untaken branch's writes do not
land; a write in a while's condition block raises.

Training programs (``append_backward``, the static optimizers): a
``grad::<type>`` op re-runs the registered forward kernel on its inputs
under autograd and takes ``torch.autograd.grad`` with the out-gradients
(:func:`run_grad_op`), as the JAX executor takes ``jax.vjp``
(``:568-614``); a ``grad::cond`` or ``grad::scan`` re-runs the whole op
over its sub-blocks the same way, and a ``grad::while`` raises. A random
op's draws are kept per op and per loop iteration for the run, and the
re-run of the forward takes them back: the gradient of a dropout sees the
forward's mask. A value an op writes to a persistable variable (a
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

import contextlib
import itertools

import numpy as np
import torch

from ..analysis import memory as _memory
from ..analysis import optimizer as _iropt
from ..analysis.verifier import op_in_names, op_out_names
from ..device import resolve_device
from ..errors import (FatalError, InvalidArgumentError, NotFoundError, UnimplementedError,
                      op_error_context)
from ..flags import flag
from ..framework import nan_inf
from ..framework import random as _random
from ..framework.dtype import torch_dtype
from ..framework.jit import _captures, _first_run, _signature
from ..framework.place import to_torch_device
from ..monitor import flight_recorder as _flight
from ..monitor import tracing as _tracing
from ..monitor.opprof import op_scope_name
from ..ops.registry import kernel
from ..profiler import RecordEvent, bump_counter
from ..runtime.compiled import GraphStore, clone_outputs, compiled_step, precision_key
from .control_flow import BLOCK_ATTR_KEYS
from .program import OpDesc, default_main_program, default_startup_program

__all__ = ["Scope", "global_scope", "Executor", "run_grad_op"]

_BLOCK_OPS = ("while", "cond", "scan")
_OFF = ("", "0", "off", "false", "no")

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
    """Runs programs on ``place`` (``None``: the CUDA card, or raise; a
    place, a ``torch.device`` or a name such as ``"cpu"`` or ``"gpu:0"``);
    on the card through :attr:`store`, a graph per signature."""

    def __init__(self, place=None):
        self.device = resolve_device(None if place is None else to_torch_device(place))
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.store = GraphStore("executor")  # shared by a predictor's clones
        self._written_of = {}  # sig -> names of the written values a scanned graph returns
        self._while_of = {}  # (program token, version) -> whether it holds an unbounded while
        self._drops_of = {}  # (program token, version, fetches) -> names freed after each op

    def run_startup(self, startup_program=None, scope=None):
        """Run the startup program (``paddle_tpu/static/executor.py:1101-1123``):
        an ``init_param`` op draws a parameter not yet in the scope with
        its initializer; any other registered op runs on the device on the
        scope's values and sets its outputs, a random one drawing from the
        device's default generator."""
        startup_program = startup_program or default_startup_program()
        scope = scope or global_scope()
        for op in startup_program.global_block().ops:
            out_names = op_out_names(op)
            if op.type == "init_param":
                if not scope.has(out_names[0]):
                    scope.set(out_names[0],
                              op.attrs["initializer"](op.attrs["shape"], op.attrs["dtype"]))
                continue
            attrs = {k: v for k, v in op.attrs.items() if not k.startswith("__")}
            if op.attrs.get("__rng__"):
                attrs["generator"] = _random.default_generator(self.device)
            with torch.device(self.device):
                out = kernel(op.type)(*[scope.on(n, self.device)
                                        for n in op_in_names(op)], **attrs)
            for n, v in zip(out_names, list(out) if isinstance(out, (tuple, list)) else [out]):
                if n:
                    scope.set(n, v)

    @torch.no_grad()
    def run(self, program=None, feed=None, fetch_list=None, scope=None, return_numpy=True):
        """Run ``program``'s global block on ``feed`` (name -> array or
        tensor) and return the fetched values, numpy arrays on the host
        unless ``return_numpy=False`` (then tensors on the device, copies
        of a graph's outputs).

        Telemetry, as the JAX executor's (``:769-1000``): ``RecordEvent``
        phases (the three gates, ``executor::feed``, then
        ``executor::compile_and_run`` with ``executor::jit_compile`` for a
        signature's first run, ``executor::run`` with
        ``executor::dispatch`` for a replay); ``executor_run_begin`` and
        ``executor_run_end`` (or ``executor_run_error``) flight events with
        the cache dispositions, which also tag the current trace span; the
        watchdog's progress clock fed at the run's end."""
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        fetch_names = [v if isinstance(v, str) else v.name for v in (fetch_list or [])]
        block = program.global_block()
        names = list(feed)
        with RecordEvent("executor::feed"):
            values = []
            for name, value in feed.items():
                dtype = torch_dtype(block.var(name).dtype) if block.has_var(name) else None
                if not isinstance(value, torch.Tensor):
                    value = np.asarray(value)  # a 0-d feed stays 0-d
                    value = torch.from_numpy(np.ascontiguousarray(value).reshape(value.shape))
                values.append(value.to(dtype=dtype))
        program, mem_plan = self.gate(program, names, fetch_names,
                                      {n: tuple(v.shape) for n, v in zip(names, values)})
        program_id = f"{program._identity_token}@v{program._version}"
        try:
            out = self._run(program, mem_plan, names, values, fetch_names, scope, return_numpy)
        except Exception as e:
            _flight.record_event("executor_run_error", program=program_id,
                                 error=f"{type(e).__name__}: {e}"[:500])
            raise
        _flight.record_event("executor_run_end", program=program_id, ok=True)
        _flight.notify_progress("executor_run")
        return out

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Run ``program`` over a Dataset's batches (``io.InMemoryDataset``,
        ``io.QueueDataset``; fluid/executor.py:1597 train_from_dataset), one
        :meth:`run` a batch: the parse workers stream fixed-shape batches,
        which the DataLoader's prefetcher copies to this executor's device
        ahead of use, so one signature is captured and the rest replay.
        Fetched values print every ``print_period`` batches (or each with
        ``debug``). Returns the number of batches run."""
        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset")
        program = program or default_main_program()
        scope = scope or global_scope()
        if thread:
            dataset.set_thread(thread)
        fetch_list = fetch_list or []
        fetch_names = [v if isinstance(v, str) else v.name for v in fetch_list]
        labels = fetch_info or fetch_names
        feed_names = dataset._feed_names()
        n = 0
        batches = (dataset._iter_device_batches(device=self.device)
                   if hasattr(dataset, "_iter_device_batches")
                   else dataset._iter_batches())
        for batch in batches:
            feed = dict(zip(feed_names, batch))
            fetches = self.run(program, feed=feed, fetch_list=fetch_list, scope=scope)
            n += 1
            if fetch_list and (debug or n % print_period == 0):
                msg = ", ".join(f"{lbl}={np.asarray(v).ravel()[:4]}"
                                for lbl, v in zip(labels, fetches))
                print(f"[train_from_dataset] batch {n}: {msg}")
        return n

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """The inference twin of :meth:`train_from_dataset`
        (fluid/executor.py:1658): the same loop over a program without
        optimizer ops."""
        return self.train_from_dataset(program, dataset, scope, thread, debug, fetch_list,
                                       fetch_info, print_period)

    def _dispositions(self, program, fetch_names, disposition):
        """The run's plan-cache disposition (whether this executor planned
        the program's value lifetimes for these fetches before) beside its
        graph disposition, as a flight event and trace-span tags."""
        plan = ("hit" if (program._identity_token, program._version, tuple(fetch_names))
                in self._drops_of else "miss")
        bump_counter(f"executor::plan_cache_{plan}")
        program_id = f"{program._identity_token}@v{program._version}"
        cache_key = disposition[1]
        _flight.record_event("executor_run_begin", program=program_id, plan_cache=plan,
                             jit_cache=disposition[0], cache_key=cache_key)
        _tracing.annotate(program=program_id, plan_cache=plan, jit_cache=disposition[0],
                          cache_key=cache_key)

    def _run(self, program, mem_plan, names, values, fetch_names, scope, return_numpy):
        """The body of :meth:`run` after the gates: interpret, capture or
        replay."""
        block = program.global_block()
        for cname, cval in program._constants.items():
            if not scope.has(cname):
                scope.set(cname, cval)
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

        uncapturable = self._uncapturable(program)
        if uncapturable or not _captures(self.device):
            self.store.uncaptured += uncapturable
            self._dispositions(program, fetch_names, ("uncaptured", None))
            with RecordEvent("executor::run"):
                out = interpret(*[v.to(self.device) for v in values])
            return scanned(out) if scan else read(out)
        sig = ((program._identity_token, program._version, tuple(fetch_names), tuple(names))
               + _signature(values) + (precision_key(), scope._token, scope._generation, scan))
        store = self.store
        entry = store.find(sig)
        if entry is None and store.runs_uncaptured(sig):
            # a signature whose first run read the host (a host-side op, an
            # NMS) is interpreted at every run
            self._dispositions(program, fetch_names, ("uncaptured", store.key_of(sig)))
            inputs = [v.to(self.device) for v in values]
            with RecordEvent("executor::run"):
                out = store.run_eager(sig, lambda: interpret(*inputs), inputs)
            return scanned(out) if scan else read(out)
        if entry is None:
            with store.capturing:
                entry = store.lookup(sig)
                if entry is None:
                    self._dispositions(program, fetch_names, ("miss", store.key_of(sig)))
                    inputs = [v.to(self.device, copy=True) for v in values]
                    with RecordEvent("executor::compile_and_run"), \
                            RecordEvent("executor::jit_compile"), compiled_step():
                        with self._measured(sig, mem_plan):
                            out = store.first_run(
                                sig, self.device,
                                lambda: _first_run(self.device, lambda: interpret(*inputs)),
                                inputs)
                        store.capture(sig, interpret, inputs,
                                      _random.graph_generators(self.device))
                    self._written_of[sig] = list(written_names)
                    return scanned(out) if scan else read(out)
        self._dispositions(program, fetch_names, ("hit", entry.cache_key))
        with RecordEvent("executor::run"), RecordEvent("executor::dispatch"):
            if scan:
                written_names[:] = self._written_of[sig]
                return scanned(store.replay(entry, *values, read=clone_outputs))
            return store.replay(entry, *values, read=read)

    def gate(self, program, feed_names, fetch_names, feed_shapes):
        """The three gates of :meth:`run`, in the JAX executor's order
        (``paddle_tpu/static/executor.py:769-826``): verify the program as
        written (``FLAGS_program_verify``: off | on | strict), optimize it
        (``FLAGS_ir_opt_level``), plan its memory against the card's
        (``FLAGS_memory_budget_check``: off | warn | strict). Returns (the
        program to run, its memory plan or None). Each verdict is cached on
        the program per version, so a replay pays lookups only."""
        feed_names = sorted(feed_names)
        verify_level = str(flag("program_verify")).strip().lower()
        if verify_level not in _OFF:
            with RecordEvent("executor::program_verify"):
                program.verify(feed_names=feed_names, fetch_list=fetch_names,
                               level="strict" if verify_level == "strict" else "on")
        try:
            ir_level = int(str(flag("ir_opt_level")).strip() or "0")
        except ValueError:
            ir_level = 0
        if ir_level > 0:
            with RecordEvent("executor::ir_opt"):
                program = _iropt.optimize_program(program, feed_names, fetch_names,
                                                  level=ir_level, feed_shapes=feed_shapes,
                                                  device=self.device).program
        mem_plan = None
        budget_level = str(flag("memory_budget_check")).strip().lower()
        if budget_level not in _OFF:
            with RecordEvent("executor::memory_plan"):
                mem_plan = _memory.check_memory_budget(
                    program, feed_names, fetch_names, feed_shapes=feed_shapes,
                    level="strict" if budget_level == "strict" else "warn",
                    budget_bytes=_memory.hbm_budget_bytes(self.device))
        return program, mem_plan

    @contextlib.contextmanager
    def _measured(self, sig, plan):
        """On the card, the device's peak allocation over the block:
        closes ``plan`` against it (``analysis.note_actual``)."""
        if plan is None or self.device.type != "cuda":
            yield
            return
        torch.cuda.reset_peak_memory_stats(self.device)
        before = torch.cuda.memory_allocated(self.device)
        yield
        actual, transient = _memory.measured_peak(
            before, torch.cuda.max_memory_allocated(self.device), plan)
        _memory.note_actual(_memory.MeasuredRun(sig, "executor", actual, transient), plan)

    def _uncapturable(self, program):
        """Whether ``program`` holds an unbounded ``while`` (looked up once
        per program state)."""
        key = (program._identity_token, program._version)
        if key not in self._while_of:
            self._while_of[key] = _holds_unbounded_while(program)
        return self._while_of[key]

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
        ``written_names``. The one body of a CPU run, a first run, a
        capture and an uncaptured run."""
        written = {}  # persistable name -> its value after the run
        runner = _BlockRunner(block.program, scope, self.device,
                              stamps=torch.autograd._profiler_enabled())
        key = (block.program._identity_token, block.program._version, tuple(fetch_names))
        drops = self._drops_of.get(key)
        if drops is None:
            drops = self._drops_of[key] = _last_reads(block, set(fetch_names))
        runner.exec_block(block, env, written, (), drops)
        fetched = [runner.value(env, n) for n in fetch_names]
        if written_names is not None:
            written_names[:] = list(written)
            return fetched + list(written.values())
        self._write_back(scope, written)
        return fetched


class _BlockRunner:
    """One run of a program's blocks (``paddle_tpu/static/executor.py``
    ``_BlockRunner``, ``:357-660``), eagerly on the executor's device.

    ``path`` is the tuple of the enclosing loops' iteration indices: a
    random op's draws are recorded under ``(path, __rng_id__)`` in a
    :class:`~paddle_tpu_torch.framework.random.Tape`, and a gradient op
    that re-runs the forward under the same key takes them back, as the
    JAX executor hands a ``grad::`` op the forward's key
    (``_op_key(base_key, op, it)``, ``:104-108``)."""

    def __init__(self, program, scope, device, stamps=False):
        self.program = program
        self.scope = scope
        self.device = device
        self.tapes = {}
        # under a profiler, each op runs inside its opprof stamp's range
        # (monitor/opprof.py): what attribute_trace folds kernels onto
        self.stamps = stamps

    def value(self, env, name):
        if name in env:
            return env[name]
        if self.scope.has(name):
            return self.scope.on(name, self.device)
        raise InvalidArgumentError(
            f"variable {name!r} is neither fed, computed by an earlier op, nor in the scope")

    def exec_block(self, block, env, written, path, drops=None):
        """``block``'s ops on ``env`` (updated in place); each persistable
        an op writes goes into ``written`` (None: such a write raises, as
        in a while's condition block). ``drops`` (op index -> names) are
        taken out of ``env`` after the op, each value after its last
        read."""
        for i, op in enumerate(block.ops):
            if self.stamps:
                with torch.profiler.record_function(op_scope_name(op.type, block.idx, i)):
                    results = self._exec_op(op, env, written, path)
            else:
                results = self._exec_op(op, env, written, path)
            for n, v in zip(op_out_names(op), results):
                if not n or v is None:
                    continue
                env[n] = v
                if block.has_var(n) and block.var(n).persistable:
                    if written is None:
                        raise NotImplementedError(
                            f"op {op.type!r} writes persistable var {n!r} inside a "
                            "while-condition block; stateful updates belong in the loop body")
                    written[n] = v
            for n in (drops.get(i, ()) if drops else ()):
                env.pop(n, None)

    def _exec_op(self, op, env, written, path):
        attrs = {k: v for k, v in op.attrs.items() if not k.startswith("__")}
        in_names = op_in_names(op)
        if op.type in _BLOCK_OPS:
            return getattr(self, f"_run_{op.type}")(op, env, written, path)
        if not op.type.startswith("grad::"):
            with self._rng(op, attrs, path):
                out = kernel(op.type)(*[self.value(env, n) for n in in_names], **attrs)
            return list(out) if isinstance(out, (tuple, list)) else [out]
        fwd_type = op.type[len("grad::"):]
        n_in = op.attrs["__n_fwd_in__"]
        fwd_in = [self.value(env, n) for n in in_names[:n_in]]
        out_grads = [env.get(n) if n else None for n in in_names[n_in:]]
        wanted = [bool(n) for n in op_out_names(op)]
        if fwd_type == "while":
            raise RuntimeError(
                "while_loop is not reverse-differentiable (unbounded trip count); build "
                "trainable loops with paddle_tpu_torch.static.nn.scan instead")
        if fwd_type in _BLOCK_OPS:
            fwd_op = OpDesc(fwd_type, {"X": in_names[:n_in]}, {"Out": []}, op.attrs)

            def forward(*xs):
                local = dict(env)
                local.update(zip(in_names[:n_in], xs))
                return getattr(self, f"_run_{fwd_type}")(fwd_op, local, {}, path)
        else:
            def forward(*xs):
                with self._rng(op, attrs, path):
                    return kernel(fwd_type)(*xs, **attrs)
        return _vjp(forward, fwd_in, out_grads, wanted)

    @contextlib.contextmanager
    def _rng(self, op, attrs, path):
        """A random op draws from the device's generator, recorded under
        its key (or handed back, when the key was drawn before)."""
        if not op.attrs.get("__rng__"):
            yield
            return
        attrs["generator"] = _random.default_generator(self.device)
        key = (path, op.attrs.get("__rng_id__", id(op)))
        with _random.taped(self.tapes.setdefault(key, _random.Tape())):
            yield

    # -- the control-flow ops (``:402-513``) ----------------------------------------

    def _merge_writes(self, env, written, sub_written, op):
        if sub_written and written is None:
            raise NotImplementedError(
                f"op {op.type!r} writes persistable vars {sorted(sub_written)} inside a "
                "while-condition block; stateful updates belong in the loop body")
        env.update(sub_written)
        if written is not None:
            written.update(sub_written)

    def _run_scan(self, op, env, written, path):
        attrs = op.attrs
        n_c, n_s = attrs["__n_carry__"], attrs["__n_seq__"]
        in_names = op.inputs["X"]
        body = self.program.blocks[attrs["__body_block__"]]
        carry = [self.value(env, n) for n in in_names[:n_c]]
        seqs = [self.value(env, n) for n in in_names[n_c:n_c + n_s]]
        length = seqs[0].shape[0] if seqs else attrs["__length__"]
        sub, sub_written = dict(env), {}  # persistable writes ride along as carries
        ys = []
        for it in range(length):
            sub.update(zip(attrs["__carry_formals__"], carry))
            sub.update(zip(attrs["__seq_formals__"], [s[it] for s in seqs]))
            self.exec_block(body, sub, sub_written, path + (it,))
            carry = [sub[n] for n in attrs["__carry_outs__"]]
            ys.append([sub[n] for n in attrs["__y_outs__"]])
        self._merge_writes(env, written, sub_written, op)
        return carry + [torch.stack(y) for y in zip(*ys)]

    def _run_while(self, op, env, written, path):
        """The unbounded loop: the predicate is read on the host once per
        iteration (the program runs uncaptured)."""
        attrs = op.attrs
        cond_blk = self.program.blocks[attrs["__cond_block__"]]
        body = self.program.blocks[attrs["__body_block__"]]
        carry = [self.value(env, n) for n in op.inputs["X"][:attrs["__n_loop__"]]]
        sub, sub_written = dict(env), {}
        it = 0
        while True:
            sub.update(zip(attrs["__cond_formals__"], carry))
            self.exec_block(cond_blk, sub, None, path + (it,))
            if not bool(sub[attrs["__cond_out__"]].reshape(())):
                break
            sub.update(zip(attrs["__body_formals__"], carry))
            self.exec_block(body, sub, sub_written, path + (it,))
            carry = [sub[n] for n in attrs["__body_outs__"]]
            it += 1
        self._merge_writes(env, written, sub_written, op)
        return carry

    def _run_cond(self, op, env, written, path):
        """Both branches run and every output and every persistable either
        branch writes is selected on the device predicate (the untaken
        branch's writes do not land). A branch that holds an unbounded
        while would run its loop even when not taken, so there the
        predicate is read on the host and only the taken branch runs: such
        a program runs uncaptured anyway."""
        attrs = op.attrs
        pred = self.value(env, op.inputs["X"][0]).reshape(()).to(torch.bool)
        branches = [(self.program.blocks[attrs["__true_block__"]], attrs["__true_outs__"]),
                    (self.program.blocks[attrs["__false_block__"]], attrs["__false_outs__"])]
        if _holds_unbounded_while(self.program, [b.idx for b, _ in branches]):
            blk, outs = branches[0] if bool(pred) else branches[1]
            sub, sub_written = dict(env), {}
            self.exec_block(blk, sub, sub_written, path)
            self._merge_writes(env, written, sub_written, op)
            return [sub[n] for n in outs]
        runs = []
        for blk, outs in branches:
            sub, sub_written = dict(env), {}
            self.exec_block(blk, sub, sub_written, path)
            runs.append(([sub[n] for n in outs], sub_written))
        (t_outs, t_w), (f_outs, f_w) = runs
        selected = {}
        for n in sorted(set(t_w) | set(f_w)):
            t = t_w[n] if n in t_w else self.value(env, n)
            f = f_w[n] if n in f_w else self.value(env, n)
            selected[n] = torch.where(pred, t, f)
        self._merge_writes(env, written, selected, op)
        return [torch.where(pred, t, f) for t, f in zip(t_outs, f_outs)]


# a control-flow op's attributes naming what its sub-blocks hand back: a
# branch or a body may hand back an enclosing block's name as it is
_SUB_OUT_ATTRS = ("__cond_out__", "__body_outs__", "__carry_outs__", "__y_outs__",
                  "__true_outs__", "__false_outs__")


def _block_reads(program, op, seen):
    """The names ``op`` reads: its inputs and, for a control-flow op (or
    its ``grad::`` replay, which carries the forward's attributes), every
    name read in its sub-blocks, nested ones included."""
    names = [n for ns in op.inputs.values() for n in ns if n]
    subs = [v for k, v in op.attrs.items()
            if k in BLOCK_ATTR_KEYS and isinstance(v, int) and 0 < v < len(program.blocks)]
    if subs:
        for k in _SUB_OUT_ATTRS:
            v = op.attrs.get(k) or ()
            names.extend([v] if isinstance(v, str) else [n for n in v if n])
    for v in subs:
        if v not in seen:
            seen.add(v)
            for sub in program.blocks[v].ops:
                names.extend(_block_reads(program, sub, seen))
    return names


def _last_reads(block, keep):
    """op index -> the names of ``block`` to free after that op: each name
    the block reads or writes, after the last op that touches it (its last
    read, or its write when nothing reads it later); names in ``keep`` (the
    fetches) stay. What the memory planner's intervals assume
    (``analysis/memory.py``)."""
    last = {}
    for i, op in enumerate(block.ops):
        for n in _block_reads(block.program, op, set()):
            last[n] = i
        for n in (n for ns in op.outputs.values() for n in ns if n):
            last[n] = i
    drops = {}
    for n, i in last.items():
        if n not in keep:
            drops.setdefault(i, []).append(n)
    return drops


def _holds_unbounded_while(program, block_idxs=(0,)):
    """Whether the blocks (and the blocks nested in them) hold a ``while``
    op: a loop whose trip count the host must read, so a run of them
    cannot be captured."""
    stack, seen = list(block_idxs), set()
    while stack:
        bi = stack.pop()
        if bi in seen:
            continue
        seen.add(bi)
        for op in program.blocks[bi].ops:
            if op.type == "while":
                return True
            stack.extend(v for k, v in op.attrs.items()
                         if k in BLOCK_ATTR_KEYS and isinstance(v, int))
    return False


def run_grad_op(fwd_type, attrs, fwd_in, out_grads, wanted):
    """The gradients a ``grad::<fwd_type>`` op computes: the registered
    forward kernel run again under autograd on ``fwd_in`` (the inputs
    ``wanted`` marks, if floating, require grad), then ``torch.autograd.grad``
    of its floating outputs with ``out_grads`` (None: zeros; an integer
    output takes none). One entry per forward input: its gradient, zeros
    where the output does not depend on it, None where it is not wanted or
    not floating (labels, indices)."""
    return _vjp(lambda *xs: kernel(fwd_type)(*xs, **attrs), fwd_in, out_grads, wanted)


def _vjp(forward, fwd_in, out_grads, wanted):
    """:func:`run_grad_op` over any ``forward(*inputs)``: a kernel, or a
    control-flow op run again over its sub-blocks."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_() if want and x.dtype.is_floating_point else x
                  for x, want in zip(fwd_in, wanted)]
        out = forward(*inputs)
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
