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
  replay) and its outputs (rewritten by each replay, so callers hand back
  copies).
- **No demote-to-eager:** where the JAX store demotes a failed AOT
  dispatch to ``jax.jit``, a capture that fails raises
  :class:`CaptureError`, and so does a failed replay. A step that cannot be
  captured is an error on the card; it never quietly runs eagerly. The
  store remembers a refused signature: a later lookup of it raises before
  anything runs.
- **Launch accounting:** the kernel wrappers count launches
  (``ops/cuda`` :func:`~paddle_tpu_torch.ops.cuda.counts`). Capture records
  the launches and launches nothing, so the store takes back what the
  wrappers counted during it, keeps it, and adds it again at each replay,
  which launches those kernels: the counts stay those of executed steps.

While a step body runs for a compiled step (its first, eager run and its
capture) :func:`in_compiled_step` is true: a host decision inside it, such
as ``GradScaler``'s found-inf test, raises there, as a Python ``bool`` of a
tracer raises in the JAX step.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading

import torch

from ..flags import flag
from ..ops import cuda as _kernels

__all__ = ["CaptureError", "CapturedStep", "GraphStore", "cache_capacity", "compiled_step",
           "in_compiled_step", "clone_outputs"]


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
    replay makes."""

    __slots__ = ("sig", "cache_key", "graph", "inputs", "outputs", "counts")

    def __init__(self, sig, cache_key, graph, inputs, outputs, counts):
        self.sig = sig
        self.cache_key = cache_key
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.counts = counts


class GraphStore:
    """LRU store of :class:`CapturedStep` entries. ``label`` prefixes the
    cache keys."""

    def __init__(self, label):
        self.label = label
        self._entries: dict = {}
        self._refused: dict = {}  # sig -> why its capture failed
        self._lock = threading.Lock()
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
        with self._lock:
            if sig in self._refused:
                raise CaptureError(f"{self.key_of(sig)}: its capture failed before "
                                   f"({self._refused[sig]}); it is not run eagerly instead")
            entry = self._entries.pop(sig, None)
            if entry is None:
                self.misses += 1
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
        remembers ``sig`` as refused."""
        key = self.key_of(sig)
        before = _kernels.counts()
        graph = torch.cuda.CUDAGraph()
        try:
            for gen in generators:
                graph.register_generator_state(gen)
            with torch.cuda.graph(graph):
                outputs = fn(*inputs)
        except Exception as e:
            why = f"{type(e).__name__}: {e}"
            with self._lock:
                self._refused[sig] = why
            raise CaptureError(f"{key}: the step could not be captured into a CUDA graph "
                               f"({why}); it is not run eagerly instead") from e
        finally:
            after = _kernels.counts()
            counts = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            _kernels.add_counts(counts, -1)  # the capture launched nothing
        entry = CapturedStep(sig, key, graph, list(inputs), outputs, counts)
        self._insert(entry)
        return entry

    def replay(self, entry, *args):
        """Copy ``args`` into the entry's static inputs, replay its graph
        and count its launches; returns the entry's outputs (which the next
        replay overwrites). Raises :class:`CaptureError` if the replay
        fails."""
        if len(args) != len(entry.inputs):
            raise ValueError(f"{entry.cache_key}: {len(args)} inputs, captured with "
                             f"{len(entry.inputs)}")
        for buf, a in zip(entry.inputs, args):
            if a is not buf:
                buf.copy_(a, non_blocking=True)
        try:
            entry.graph.replay()
        except Exception as e:
            raise CaptureError(f"{entry.cache_key}: the replay failed "
                               f"({type(e).__name__}: {e})") from e
        _kernels.add_counts(entry.counts)
        return entry.outputs
