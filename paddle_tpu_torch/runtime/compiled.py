"""Captured steps: the store of CUDA graphs behind ``train_step(jit=True)`` and ``eval_step``.

Counterpart of ``paddle_tpu/runtime/compiled.py`` ``CompiledStore``
(``:136-340``). Where the JAX package compiles a step once per batch
signature and replays the executable, the port captures the step's kernel
launches once per signature into a ``torch.cuda.CUDAGraph`` and replays
the graph, so a step costs the host one graph launch instead of thousands
of kernel launches from Python:

- **Store:** a :class:`GraphStore` keeps :class:`CapturedStep` entries in
  least-recently-used order, keyed by any hashable signature the caller
  derives (instance, parameter count, variant, input shapes and dtypes),
  each with a stable ``cache_key`` of the form ``<label>#<hex>``.
- **Bound:** ``FLAGS_compiled_cache_capacity``, read at insert time.
- **Counters:** ``hits``, ``misses`` and ``evictions`` of each store, and
  ``uncaptured``: the runs its owner made without a graph because they
  cannot be captured (a static program holding an unbounded ``while``,
  whose trip count the host reads, or a step whose body read values on
  the host).
- **Uncaptured signatures:** a step body may read device values on the
  host through :func:`host_read` (the ``to_static`` converters of a
  ``while`` on a tensor, ``print`` and ``assert``). The store's first run
  of a signature notes such reads (:meth:`GraphStore.first_run`); the
  signature is then never captured: :meth:`GraphStore.capture` records
  nothing for it, a lookup finds no entry and counts no miss, and callers
  that see :meth:`GraphStore.runs_uncaptured` run each later call eagerly
  on the device through :meth:`GraphStore.run_eager` (no capture lock, no
  copy of the inputs, no device synchronize), where each run that reads the
  host adds one to ``uncaptured``. A host read while a graph records raises
  :class:`CaptureError`.
- **Entry:** the graph (which owns its private memory pool), its static
  input buffers (the caller's batch is copied into them before each
  replay), its outputs (rewritten by each replay, so callers hand back
  copies) and a lock: copying in, replaying and reading the outputs out
  are one unit, so threads that replay one entry (the clones of a
  predictor, which share its store) each get the answer to their own
  input.
- **One capture at a time:** a caller that finds no entry takes the
  store's ``capturing`` lock and looks again (:meth:`GraphStore.find`,
  then :meth:`GraphStore.lookup` under the lock), so N threads that miss
  one signature together capture it once. Captures run in
  ``thread_local`` error mode: other threads' replays and copies go on
  during a capture.
- **No demote-to-eager:** where the JAX store demotes a failed AOT
  dispatch to ``jax.jit``, a capture that fails raises
  :class:`CaptureError`, and so does a failed replay. A step that cannot be
  captured is an error on the card; it never quietly runs eagerly. The
  store remembers a refused signature: a later lookup of it raises before
  anything runs.
- **Launch accounting:** the kernel wrappers count launches
  (``ops/cuda`` :func:`~paddle_tpu_torch.ops.cuda.counts`). Capture records
  the launches and launches nothing, so the store takes back what the
  wrappers counted on the capture's stream
  (:func:`~paddle_tpu_torch.ops.cuda.tallied`; the backward's kernels
  too, which the autograd engine launches from its own thread), keeps it,
  and adds it again at each replay, which launches those kernels: the
  counts stay those of executed steps, also while other threads launch
  and replay.

- **Telemetry** (``paddle_tpu/runtime/compiled.py:221-339``): the eager
  first run of a signature (:meth:`GraphStore.first_run`) is counted
  (``monitor.cost_model.count_work``), and the capture keeps the count as
  the entry's :class:`~paddle_tpu_torch.monitor.cost_model.CostRecord`;
  each replay adds it to the executed-work ledger (``note_run``) and
  tags the current trace span with the entry's ``cache_key``. A capture
  is the goodput ledger's ``compile`` phase and the registry's compile
  event, and records a ``runtime_compile`` flight event (a refused one
  ``runtime_capture_refused``, the counterpart of the JAX store's
  ``runtime_demote``; an eviction ``runtime_cache_evict``). On the CPU,
  where a compiled step runs eagerly at every call, :meth:`GraphStore.run_eager`
  counts a signature's first call and books every call.

:class:`CompileWatch` counts the captures a store makes after a warmup
(``paddle_tpu/runtime/compiled.py:411-461``): a serving pool captures
every bucket at warmup and then expects none, and each capture after it
is a flight event.

While a step body runs for a compiled step (its first, eager run and its
capture) :func:`in_compiled_step` is true: a host decision inside it, such
as ``GradScaler``'s found-inf test, raises there, as a Python ``bool`` of a
tracer raises in the JAX step; only :func:`host_read` reads the host there,
and it leaves the signature uncaptured.
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
import threading
import time

import torch

from ..errors import PreconditionNotMetError
from ..flags import flag
from ..monitor import cost_model as _cost
from ..monitor import flight_recorder as _flight
from ..monitor import goodput as _goodput
from ..monitor import registry as _registry
from ..monitor import tracing as _tracing
from ..ops import cuda as _kernels
from ..profiler import bump_counter

__all__ = ["CaptureError", "CapturedStep", "GraphStore", "CompiledStore", "CompiledEntry",
           "CompileWatch", "any_deleted", "cache_capacity", "compiled_step", "in_compiled_step",
           "host_read", "noting_host_reads", "clone_outputs", "precision_key"]


_log = logging.getLogger(__name__)


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph, or its replay
    failed."""


def cache_capacity() -> int:
    """The bound of every store (``FLAGS_compiled_cache_capacity``), read
    at insert time so ``set_flags`` applies to live stores."""
    return max(1, int(flag("compiled_cache_capacity")))


def any_deleted(arrays) -> bool:
    """Whether any tensor of ``arrays`` has had its storage released
    (resized to no bytes) while it still has elements: the port's
    counterpart of a donated JAX array (``paddle_tpu/runtime/compiled.py``
    ``any_deleted``). Entries that are not tensors, and tensors on
    ``meta``, are skipped."""
    for t in arrays:
        if (isinstance(t, torch.Tensor) and t.device.type != "meta" and t.numel() > 0
                and t.untyped_storage().nbytes() == 0):
            return True
    return False


_region = threading.local()


@contextlib.contextmanager
def compiled_step():
    """Mark the body of a compiled step (its eager first run and its
    capture) for :func:`in_compiled_step`."""
    prev = getattr(_region, "on", False)
    _region.on = True
    try:
        yield
    finally:
        _region.on = prev


def in_compiled_step() -> bool:
    """Whether a compiled step's body is running on this thread."""
    return getattr(_region, "on", False)


def _recording() -> bool:
    """Whether a graph records on this thread (a store's capture, or any
    CUDA stream capture in progress)."""
    if getattr(_region, "recording", False):
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def host_read(what):
    """A sanctioned read of device values on the host inside a compiled
    step (``what``: the ``to_static`` converter that reads). Raises
    :class:`CaptureError` while a graph records, where the value would be
    baked into every replay; otherwise it is noted for the enclosing
    :func:`noting_host_reads`, and the store's first run of the signature
    then leaves it uncaptured."""
    if _recording():
        raise CaptureError(f"{what} reads a value on the host while a CUDA graph records: "
                           "the value would be baked into every replay")
    reads = getattr(_region, "reads", None)
    if reads is not None:
        reads.append(what)


@contextlib.contextmanager
def noting_host_reads():
    """Collect the :func:`host_read` calls of the body (this thread) into
    the list it yields; an enclosing collection sees them too."""
    prev = getattr(_region, "reads", None)
    _region.reads = reads = []
    try:
        yield reads
    finally:
        _region.reads = prev
        if prev is not None:
            prev.extend(reads)


def precision_key() -> tuple:
    """The settings a captured cuBLAS or cuDNN call bakes in: TF32 in
    matrix products and in convolutions. Part of every signature, so a
    graph captured with TF32 off never replays for a caller who switched it
    on."""
    return (bool(torch.backends.cuda.matmul.allow_tf32), bool(torch.backends.cudnn.allow_tf32))


def clone_outputs(out):
    """``out`` with every tensor in it (alone, in a tuple, list or dict)
    copied: a replay rewrites the captured outputs in place."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(clone_outputs(o) for o in out)
    if isinstance(out, dict):
        return {k: clone_outputs(v) for k, v in out.items()}
    return out


def _nbytes(tree) -> int:
    """The bytes of every tensor in ``tree`` (a tensor, a sequence or a
    dict of them)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_nbytes(t) for t in tree.values())
    return 0


class CapturedStep:
    """One captured step: ``graph`` replays it on ``inputs`` (static
    buffers) into ``outputs``; ``counts`` are the kernel launches one
    replay makes; ``record`` is its cost sheet (None when its first run
    was not counted); ``lock`` makes a replay and the read of its outputs
    one unit."""

    __slots__ = ("sig", "cache_key", "graph", "inputs", "outputs", "counts", "record", "lock")

    def __init__(self, sig, cache_key, graph, inputs, outputs, counts, record=None):
        self.sig = sig
        self.cache_key = cache_key
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.counts = counts
        self.record = record
        self.lock = threading.Lock()


class CompiledEntry(CapturedStep):
    """:class:`CapturedStep` under the JAX package's ``CompiledEntry``
    constructor: ``jitted`` is the entry's graph (its inputs, outputs and
    launch counts filled by a capture), ``meta`` whatever the caller attaches
    and ``refresh_gen`` the JAX package's rebuild count."""

    __slots__ = ("meta", "refresh_gen")

    def __init__(self, sig, cache_key, jitted, meta, refresh_gen=0):
        super().__init__(sig, cache_key, jitted, [], None, {})
        self.meta = meta
        self.refresh_gen = refresh_gen


class GraphStore:
    """LRU store of :class:`CapturedStep` entries. ``label`` prefixes the
    cache keys and names the cost records."""

    hit_counter, miss_counter = "graph::cache_hit", "graph::cache_miss"

    def __init__(self, label):
        self.label = label
        self._entries: dict = {}
        self._refused: dict = {}  # sig -> why its capture failed
        self._lock = threading.Lock()
        self.capturing = threading.RLock()  # held from a miss to its capture
        self.hits = self.misses = self.evictions = self.uncaptured = 0
        self._counted: dict = {}  # sig -> (work count, memory) of its first run, until captured
        self._eager_records: dict = {}  # sig -> the record of an eagerly run signature
        self._uncapturable: set = set()  # the signatures whose runs read the host

    def __len__(self):
        return len(self._entries)

    def entries(self) -> dict:
        """Snapshot of sig -> entry, least recently used first."""
        with self._lock:
            return dict(self._entries)

    def key_of(self, sig) -> str:
        """The stable ``<label>#<hex>`` name of ``sig``."""
        return f"{self.label}#{hashlib.sha1(repr(sig).encode()).hexdigest()[:10]}"

    def _capacity(self) -> int:
        return cache_capacity()

    def _cost_label(self) -> str:
        return self.label

    def lookup(self, sig):
        """The entry of ``sig`` (made the most recently used), counted as a
        hit, or None, counted as a miss. Raises :class:`CaptureError` if a
        capture of ``sig`` failed before: the caller runs nothing."""
        return self._get(sig, count_miss=True)

    def find(self, sig):
        """:meth:`lookup` that counts no miss: the look before a caller
        takes :attr:`capturing` and looks again with :meth:`lookup`."""
        return self._get(sig, count_miss=False)

    def runs_uncaptured(self, sig) -> bool:
        """Whether ``sig``'s runs read values on the host, so that it is
        never captured (:func:`host_read`)."""
        with self._lock:
            return sig in self._uncapturable

    def _get(self, sig, count_miss):
        with self._lock:
            if sig in self._uncapturable:
                return None  # runs eagerly at every call: not a miss
            if sig in self._refused:
                raise CaptureError(f"{self.key_of(sig)}: its capture failed before "
                                   f"({self._refused[sig]}); it is not run eagerly instead")
            entry = self._entries.pop(sig, None)
            if entry is None:
                self.misses += count_miss
                if count_miss:
                    bump_counter(self.miss_counter)
                return None
            self._entries[sig] = entry
            self.hits += 1
        bump_counter(self.hit_counter)
        return entry

    def _insert(self, entry):
        with self._lock:
            self._entries.pop(entry.sig, None)
            self._entries[entry.sig] = entry
            cap = self._capacity()
            evicted = []
            while len(self._entries) > cap:
                evicted.append(self._entries.pop(next(iter(self._entries))))
                self.evictions += 1
        for old in evicted:
            # the next call of that signature captures again: churn from an
            # undersized store shows here (FLAGS_compiled_cache_capacity)
            _flight.record_event("runtime_cache_evict", label=self.label,
                                 cache_key=old.cache_key, capacity=cap)

    def first_run(self, sig, device, run, inputs=()):
        """``run()``, the eager first run of ``sig`` before its capture
        (``framework/jit.py`` ``_first_run``), with its work counted
        (``monitor.cost_model.count_work``); the next :meth:`capture` of
        ``sig`` keeps the count as the entry's cost record, with the step's
        input and output bytes (its temporaries are not measured: reading
        them would reset the allocator's peak other readers hold).

        A run that reads values on the host (:func:`host_read`) leaves
        ``sig`` uncaptured (:meth:`runs_uncaptured`): its count becomes the
        record of an eagerly run signature, :meth:`capture` records nothing,
        and callers send its later calls to :meth:`run_eager` (a caller
        that comes here again is sent there too)."""
        if self.runs_uncaptured(sig):
            return self.run_eager(sig, run, inputs)
        with _cost.count_work() as work, noting_host_reads() as reads:
            out = run()
        mem = {"argument_size_in_bytes": _nbytes(list(inputs)),
               "output_size_in_bytes": _nbytes(out)}
        if not reads:
            with self._lock:
                self._counted[sig] = (work, mem)
            return out
        self._record_eager(sig, work, mem)
        with self._lock:
            self._uncapturable.add(sig)
            self.uncaptured += 1
        _flight.record_event("runtime_uncaptured", label=self.label, cache_key=self.key_of(sig),
                             host_reads=sorted(set(reads)))
        return out

    def run_eager(self, sig, fn, inputs=()):
        """``fn()`` for a signature that runs eagerly at every call (a
        compiled step on the CPU, or an uncaptured signature on the card):
        its first call is counted into a cost record
        (``monitor.cost_model``), and every call is one run of it; a call
        whose body read the host (:func:`host_read`) adds one to
        :attr:`uncaptured`, as it would on the card."""
        with self._lock:
            rec = self._eager_records.get(sig)
        reads = []
        try:
            with (_cost.count_work() if rec is None else contextlib.nullcontext()) as work, \
                    noting_host_reads() as reads:
                out = fn()
        finally:
            if reads:
                with self._lock:
                    self.uncaptured += 1
        if rec is None:
            self._record_eager(sig, work, {"argument_size_in_bytes": _nbytes(list(inputs)),
                                           "output_size_in_bytes": _nbytes(out)})
        else:
            _cost.note_run(rec)
        return out

    def _record_eager(self, sig, work, mem):
        """The cost record of the eagerly run ``sig`` from its first run's
        count, booked as one run."""
        key = self.key_of(sig)
        rec = _cost.capture(self._cost_label(), cost=work, mem=mem, key=key, cache_key=key)
        with self._lock:
            self._eager_records[sig] = rec
        _cost.note_run(rec)
        return rec

    def capture(self, sig, fn, inputs, generators=()):
        """Capture ``fn(*inputs)`` into a new graph, its own memory pool,
        with ``generators`` registered (they then advance at each replay),
        and store it under ``sig``. ``inputs`` are the static buffers later
        replays copy their arguments into. Nothing runs: the caller has run
        the step itself first, which also built the kernels and library
        plans. Raises :class:`CaptureError` if the capture fails, and
        remembers ``sig`` as refused. The capture runs in ``thread_local``
        error mode: another thread's CUDA calls during it (a replay, a copy
        to the host) neither fail nor spoil it. A signature whose runs read
        the host (:meth:`first_run`) is not captured: returns None."""
        if self.runs_uncaptured(sig):
            return None
        key = self.key_of(sig)
        graph = torch.cuda.CUDAGraph()
        # a stream of its own: captures of two stores may record at once
        stream = torch.cuda.Stream() if torch.cuda.is_available() else None
        t0 = time.perf_counter()
        try:
            with _goodput.span("compile"), _kernels.tallied(stream) as counts:
                for gen in generators:
                    graph.register_generator_state(gen)
                with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                    _region.recording = True
                    try:
                        outputs = fn(*inputs)
                    finally:
                        _region.recording = False
        except Exception as e:
            why = f"{type(e).__name__}: {e}"
            with self._lock:
                self._refused[sig] = why
                self._counted.pop(sig, None)
            _flight.record_event("runtime_capture_refused", label=self.label, cache_key=key,
                                 error=why[:500])
            raise CaptureError(f"{key}: the step could not be captured into a CUDA graph "
                               f"({why}); it is not run eagerly instead") from e
        finally:
            _kernels.add_counts(counts, -1)  # the capture launched nothing
        _registry.note_compile_event(self.label, time.perf_counter() - t0)
        with self._lock:
            counted = self._counted.pop(sig, None)
        record = None
        if counted is not None:
            work, mem = counted
            record = _cost.capture(self._cost_label(), cost=work, mem=mem, key=key, cache_key=key)
            _cost.note_run(record)  # the first run was a real step
        _flight.record_event("runtime_compile", label=self.label, cache_key=key,
                             flops=record.flops if record else 0.0)
        entry = CapturedStep(sig, key, graph, list(inputs), outputs, counts, record)
        self._insert(entry)
        return entry

    def replay(self, entry, *args, read=None):
        """Copy ``args`` (on the card or the host) into the entry's static
        inputs, replay its graph, count its launches and return
        ``read(outputs)``, all under the entry's lock; ``read`` copies the
        outputs out (:func:`clone_outputs`, or to the host). Without
        ``read``, the entry's outputs themselves, which the next replay
        overwrites. Raises :class:`CaptureError` if the replay fails."""
        if len(args) != len(entry.inputs):
            raise ValueError(f"{entry.cache_key}: {len(args)} inputs, captured with "
                             f"{len(entry.inputs)}")
        with entry.lock:
            for buf, a in zip(entry.inputs, args):
                if a is not buf:
                    buf.copy_(a, non_blocking=True)
            try:
                entry.graph.replay()
            except Exception as e:
                raise CaptureError(f"{entry.cache_key}: the replay failed "
                                   f"({type(e).__name__}: {e})") from e
            _kernels.add_counts(entry.counts)
            out = entry.outputs if read is None else read(entry.outputs)
        rec = entry.record
        _cost.note_run(rec)
        if rec is not None:
            _tracing.annotate(cache_key=entry.cache_key, flops=rec.flops,
                              cost_bytes=rec.bytes_accessed)
        else:
            _tracing.annotate(cache_key=entry.cache_key)
        return out


class CompiledStore(GraphStore):
    """:class:`GraphStore` under the JAX package's ``CompiledStore``
    constructor (``paddle_tpu/runtime/compiled.py:136-155``): the cost
    records go under ``cost_label`` (``label`` by default), ``capacity``
    bounds the store in place of ``FLAGS_compiled_cache_capacity``, and a
    lookup bumps ``hit_counter`` / ``miss_counter``."""

    def __init__(self, label, *, cost_label=None, capacity=None, hit_counter=None,
                 miss_counter=None):
        super().__init__(label)
        self.cost_label = cost_label or label
        self.capacity = capacity
        self.hit_counter = hit_counter or GraphStore.hit_counter
        self.miss_counter = miss_counter or GraphStore.miss_counter

    def _capacity(self) -> int:
        return cache_capacity() if self.capacity is None else max(1, int(self.capacity))

    def _cost_label(self) -> str:
        return self.cost_label


class CompileWatch:
    """Captures after a warmup (``paddle_tpu/runtime/compiled.py``
    ``CompileWatch``): :meth:`arm` after warmup snapshots ``read()`` (a
    store's ``misses``); any growth after it is an unexpected capture,
    which :meth:`note` counts into :attr:`noted` and the registry counter
    ``metric``, logs and records as the flight event ``event``. ``note``
    is an atomic read-compare-bump: workers that see the same capture
    count it once."""

    def __init__(self, read, metric="serving/unexpected_compiles",
                 event="serving_unexpected_compile"):
        from ..monitor import counter

        self._read = read
        self._event = event
        self._baseline = None
        self._seen = 0
        self.noted = 0
        self._metric = counter(metric)
        self._lock = threading.Lock()

    def arm(self):
        self._baseline = self._read()
        self._seen = 0
        return self

    @property
    def armed(self) -> bool:
        return self._baseline is not None

    def extra(self) -> int:
        """Captures since :meth:`arm`: steady state keeps this 0."""
        if self._baseline is None:
            raise PreconditionNotMetError("extra_compiles() before warmup(): nothing to compare")
        return self._read() - self._baseline

    def note(self, **fields):
        """Count and log any growth since the last note (nothing when
        flat)."""
        with self._lock:
            extra = self.extra()
            grew = extra - self._seen
            if grew <= 0:
                return
            self._seen = extra
            self.noted += grew
            self._metric.inc(grew)
            _flight.record_event(self._event, total=extra, **fields)
        _log.warning("unexpected graph capture after warmup (%d in all): %s", extra, fields)
