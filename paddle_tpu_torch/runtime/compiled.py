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
- **Counters:** ``hits``, ``misses`` and ``evictions`` of each store.
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

:class:`CompileWatch` counts the captures a store makes after a warmup
(``paddle_tpu/runtime/compiled.py:411-461``): a serving pool captures
every bucket at warmup and then expects none.

While a step body runs for a compiled step (its first, eager run and its
capture) :func:`in_compiled_step` is true: a host decision inside it, such
as ``GradScaler``'s found-inf test, raises there, as a Python ``bool`` of a
tracer raises in the JAX step.
"""
from __future__ import annotations

import contextlib
import hashlib
import logging
import threading

import torch

from ..errors import PreconditionNotMetError
from ..flags import flag
from ..ops import cuda as _kernels

__all__ = ["CaptureError", "CapturedStep", "GraphStore", "CompileWatch", "cache_capacity",
           "compiled_step", "in_compiled_step", "clone_outputs", "precision_key"]


_log = logging.getLogger(__name__)


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph, or its replay
    failed."""


def cache_capacity() -> int:
    """The bound of every store (``FLAGS_compiled_cache_capacity``), read
    at insert time so ``set_flags`` applies to live stores."""
    return max(1, int(flag("compiled_cache_capacity")))


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


class CapturedStep:
    """One captured step: ``graph`` replays it on ``inputs`` (static
    buffers) into ``outputs``; ``counts`` are the kernel launches one
    replay makes; ``lock`` makes a replay and the read of its outputs one
    unit."""

    __slots__ = ("sig", "cache_key", "graph", "inputs", "outputs", "counts", "lock")

    def __init__(self, sig, cache_key, graph, inputs, outputs, counts):
        self.sig = sig
        self.cache_key = cache_key
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.counts = counts
        self.lock = threading.Lock()


class GraphStore:
    """LRU store of :class:`CapturedStep` entries. ``label`` prefixes the
    cache keys."""

    def __init__(self, label):
        self.label = label
        self._entries: dict = {}
        self._refused: dict = {}  # sig -> why its capture failed
        self._lock = threading.Lock()
        self.capturing = threading.RLock()  # held from a miss to its capture
        self.hits = self.misses = self.evictions = 0

    def __len__(self):
        return len(self._entries)

    def entries(self) -> dict:
        """Snapshot of sig -> entry, least recently used first."""
        with self._lock:
            return dict(self._entries)

    def key_of(self, sig) -> str:
        """The stable ``<label>#<hex>`` name of ``sig``."""
        return f"{self.label}#{hashlib.sha1(repr(sig).encode()).hexdigest()[:10]}"

    def lookup(self, sig):
        """The entry of ``sig`` (made the most recently used), counted as a
        hit, or None, counted as a miss. Raises :class:`CaptureError` if a
        capture of ``sig`` failed before: the caller runs nothing."""
        return self._get(sig, count_miss=True)

    def find(self, sig):
        """:meth:`lookup` that counts no miss: the look before a caller
        takes :attr:`capturing` and looks again with :meth:`lookup`."""
        return self._get(sig, count_miss=False)

    def _get(self, sig, count_miss):
        with self._lock:
            if sig in self._refused:
                raise CaptureError(f"{self.key_of(sig)}: its capture failed before "
                                   f"({self._refused[sig]}); it is not run eagerly instead")
            entry = self._entries.pop(sig, None)
            if entry is None:
                self.misses += count_miss
                return None
            self._entries[sig] = entry
            self.hits += 1
            return entry

    def _insert(self, entry):
        with self._lock:
            self._entries.pop(entry.sig, None)
            self._entries[entry.sig] = entry
            cap = cache_capacity()
            while len(self._entries) > cap:
                self._entries.pop(next(iter(self._entries)))
                self.evictions += 1

    def capture(self, sig, fn, inputs, generators=()):
        """Capture ``fn(*inputs)`` into a new graph, its own memory pool,
        with ``generators`` registered (they then advance at each replay),
        and store it under ``sig``. ``inputs`` are the static buffers later
        replays copy their arguments into. Nothing runs: the caller has run
        the step itself first, which also built the kernels and library
        plans. Raises :class:`CaptureError` if the capture fails, and
        remembers ``sig`` as refused. The capture runs in ``thread_local``
        error mode: another thread's CUDA calls during it (a replay, a copy
        to the host) neither fail nor spoil it."""
        key = self.key_of(sig)
        graph = torch.cuda.CUDAGraph()
        # a stream of its own: captures of two stores may record at once
        stream = torch.cuda.Stream() if torch.cuda.is_available() else None
        try:
            with _kernels.tallied(stream) as counts:
                for gen in generators:
                    graph.register_generator_state(gen)
                with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                    outputs = fn(*inputs)
        except Exception as e:
            why = f"{type(e).__name__}: {e}"
            with self._lock:
                self._refused[sig] = why
            raise CaptureError(f"{key}: the step could not be captured into a CUDA graph "
                               f"({why}); it is not run eagerly instead") from e
        finally:
            _kernels.add_counts(counts, -1)  # the capture launched nothing
        entry = CapturedStep(sig, key, graph, list(inputs), outputs, counts)
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
            return entry.outputs if read is None else read(entry.outputs)


class CompileWatch:
    """Captures after a warmup (``paddle_tpu/runtime/compiled.py``
    ``CompileWatch``): :meth:`arm` after warmup snapshots ``read()`` (a
    store's ``misses``); any growth after it is an unexpected capture,
    which :meth:`note` counts into :attr:`noted` and logs, where the JAX
    package bumps a monitor counter and records a flight event (the port
    has neither yet). ``note`` is an atomic read-compare-bump: workers
    that see the same capture count it once."""

    def __init__(self, read):
        self._read = read
        self._baseline = None
        self._seen = 0
        self.noted = 0
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
        _log.warning("unexpected graph capture after warmup (%d in all): %s", extra, fields)
