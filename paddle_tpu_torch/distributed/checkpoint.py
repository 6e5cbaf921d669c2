"""Crash-consistent training checkpoints in the JAX package's layout (``paddle_tpu/distributed/checkpoint.py``), at world size 1.

A snapshot directory is the JAX package's, byte for byte apart from the
manifest's ``time``, so either package loads the other's::

    step_12/
      MANIFEST.json      format, step, world, mesh_shape, time, entries{name:
                         {shape, dtype, spec}}, files{name: {crc32, size}}
      shard_r0.pdshard   dumps({"rank": 0, "pieces": {name: [(global_index,
                         array)]}}) (``framework/serialization.py``)
      rank_0.json        the rank's commit record (its shard's crc32, size)

The files are written into ``<path>.tmp``, each fsynced, and published by
one ``os.replace`` after the manifest: a save killed midway leaves a
manifest-less ``.tmp`` that :func:`sweep_tmp` removes and
:func:`latest_checkpoint` never takes, and a published snapshot whose
checksums fail raises :class:`CheckpointCorruptError` and is skipped.
``keep`` rotates the newest intact siblings of the same name prefix.

The state is a flat ``{leaf name: tensor}`` (a train step's
:meth:`~paddle_tpu_torch.framework.jit.TrainStepFn.state_leaves`, named as
``jax.tree_util.keystr`` names the JAX step's pytree). The capture copies
every leaf to the host on the caller's thread; with ``async_`` (default
``FLAGS_checkpoint_async``) the serialize, fsync and publish run on one
FIFO writer thread, and :func:`wait_pending` waits for them and raises the
first failure. :func:`restore_train_step` copies into the step's live
tensors, so captured graphs stay valid.

``FLAGS_fault_injection``'s ``mid_save`` point (``distributed/chaos.py``)
sits between the shard file and the commit record, as in the JAX writer.
:func:`detach_refs` and :func:`submit` serve ``incubate.auto_checkpoint``'s
epoch snapshots, which ride the same writer thread.

Not ported: a world size above 1, ``shardings`` and ``mesh`` (resharding
goes with ``torch.distributed``, ROADMAP.md Queue A item 9), and the
goodput and flight-recorder hooks.
"""
from __future__ import annotations

import functools
import json
import os
import queue
import re
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from ..errors import UnimplementedError
from ..flags import flag
from ..framework import serialization as _ser

__all__ = ["CheckpointError", "CheckpointCorruptError", "save", "save_train_step",
           "restore_train_step", "load", "validate", "latest_checkpoint", "sweep_tmp",
           "wait_pending", "write_bytes", "write_manifest", "AsyncSaver", "MANIFEST",
           "detach_refs", "submit"]

MANIFEST = "MANIFEST.json"
FORMAT_VERSION = 1
_RANK, _WORLD = 0, 1


class CheckpointError(RuntimeError):
    pass


class CheckpointCorruptError(CheckpointError):
    """A snapshot that must be skipped: torn, checksum-failing, or
    manifest-less."""


def _unported(what):
    return UnimplementedError(
        f"checkpoint {what}: only world size 1 is ported; sharded and multi-rank "
        "checkpoints come with torch.distributed (ROADMAP.md Queue A item 9)")


# -- low-level durable writes -------------------------------------------------


def write_bytes(path, data: bytes):
    """Write + fsync; returns (crc32, size) for the manifest."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return zlib.crc32(data) & 0xFFFFFFFF, len(data)


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse a directory fsync; the rename is still atomic
    finally:
        os.close(fd)


def write_manifest(dirpath, files, **meta):
    """Write + fsync the manifest that makes a snapshot loadable; the
    caller publishes (renames) only after this returns."""
    manifest = {"format": FORMAT_VERSION, **meta, "files": files}
    write_bytes(os.path.join(dirpath, MANIFEST),
                json.dumps(manifest, sort_keys=True).encode("utf-8"))
    _fsync_dir(dirpath)
    return manifest


# -- save -----------------------------------------------------------------------


def _host_copy(leaf):
    """A leaf (tensor, array or number) as a numpy array of its own."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def detach_refs(obj):
    """``obj`` (a state dict, nested) with every tensor replaced by a host
    copy of its current value, made here on the caller's thread: training
    updates the live tensors in place afterwards, and the writer thread
    reads the copies."""
    if isinstance(obj, torch.Tensor):
        return _host_copy(obj)
    if isinstance(obj, dict):
        return {k: detach_refs(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(detach_refs(v) for v in obj)
    return obj


def save(path, state, shardings=None, *, step=None, mesh=None, keep=None, async_=None):
    """Snapshot ``state`` (``{leaf name: tensor}`` or a list of pairs) to
    ``path``. The host copy of every leaf is made here; with ``async_``
    (default ``FLAGS_checkpoint_async``) the write is queued on the writer
    thread and its pending handle returned (:func:`wait_pending`)."""
    if shardings is not None or mesh is not None:
        raise _unported("shardings/mesh")
    if async_ is None:
        async_ = bool(flag("checkpoint_async"))
    items = list(state.items() if isinstance(state, dict) else state)
    names = [n for n, _ in items]
    leaves = [_host_copy(leaf) for _, leaf in items]
    meta = {"step": -1 if step is None else int(step), "world": _WORLD, "mesh_shape": None,
            "time": time.time()}
    job = functools.partial(_write_snapshot, str(path), names, leaves, meta, keep)
    if async_:
        return _SAVER.submit(job, label=str(path))
    job()
    return None


def _write_snapshot(final, names, leaves, meta, keep):
    """Writer body: the shard file and commit record into ``<final>.tmp``,
    then the manifest, then one atomic rename."""
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    entries, pieces = {}, {}
    for name, leaf in zip(names, leaves):
        shape = [int(d) for d in leaf.shape]
        entries[name] = {"shape": shape, "dtype": str(leaf.dtype), "spec": []}
        pieces[name] = [([[0, d] for d in shape], leaf)]
    shard_name = f"shard_r{_RANK}.pdshard"
    crc, size = write_bytes(os.path.join(tmp, shard_name),
                            _ser.dumps({"rank": _RANK, "pieces": pieces}))
    from . import chaos

    chaos.inject("mid_save")
    frag = {"rank": _RANK, "world": _WORLD, "file": shard_name, "crc32": crc, "size": size}
    write_bytes(os.path.join(tmp, f"rank_{_RANK}.json"), json.dumps(frag).encode("utf-8"))
    _fsync_dir(tmp)
    write_manifest(tmp, {shard_name: {"crc32": crc, "size": size}}, **meta, entries=entries)
    if os.path.exists(final):
        shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    _fsync_dir(os.path.dirname(final) or ".")
    if keep:
        _rotate(final, int(keep))


_STEP_DIR = re.compile(r"^(.*?)(\d+)$")


def _rotate(final, keep):
    """Drop the oldest sibling snapshots (same name prefix before the
    number, e.g. ``step_*``) beyond ``keep``; only intact
    (manifest-bearing) ones count."""
    parent = os.path.dirname(os.path.abspath(final))
    m = _STEP_DIR.match(os.path.basename(final))
    if not m:
        return
    prefix = m.group(1)
    found = []
    for d in os.listdir(parent):
        dm = _STEP_DIR.match(d)
        if dm is None or dm.group(1) != prefix:
            continue
        if os.path.isfile(os.path.join(parent, d, MANIFEST)):
            found.append((int(dm.group(2)), d))
    for _, d in sorted(found)[:-keep]:
        shutil.rmtree(os.path.join(parent, d), ignore_errors=True)


# -- validate / load -------------------------------------------------------------


def _read_manifest(path):
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise CheckpointCorruptError(f"{path}: no {MANIFEST} (torn save)") from None
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(f"{path}: unreadable manifest: {e}") from e
    if not isinstance(manifest, dict) or "files" not in manifest:
        raise CheckpointCorruptError(f"{path}: malformed manifest")
    return manifest


def _read_checked(path, fname, meta):
    try:
        with open(os.path.join(path, fname), "rb") as f:
            data = f.read()
    except FileNotFoundError:
        raise CheckpointCorruptError(f"{path}: missing file {fname}") from None
    crc = zlib.crc32(data) & 0xFFFFFFFF
    if crc != int(meta["crc32"]) or len(data) != int(meta["size"]):
        raise CheckpointCorruptError(
            f"{path}/{fname}: checksum/size mismatch (crc {crc:#x} != "
            f"{int(meta['crc32']):#x} or size {len(data)} != {meta['size']})")
    return data


def validate(path):
    """The manifest, after checking that every listed file is present with
    its CRC32 and size; raises :class:`CheckpointCorruptError` otherwise."""
    manifest = _read_manifest(path)
    for fname, meta in manifest["files"].items():
        _read_checked(path, fname, meta)
    return manifest


def _assemble(name, entry, pieces):
    """One global host array from its pieces."""
    shape = tuple(int(d) for d in entry["shape"])
    if not pieces:
        raise CheckpointCorruptError(f"{name}: no shard data in any file")
    dtype = np.dtype(entry["dtype"])
    if shape == ():
        return np.asarray(pieces[0][1], dtype=dtype).reshape(())
    buf = np.zeros(shape, dtype)
    covered = 0
    for idx, data in pieces:
        sl = tuple(slice(a, b) for a, b in idx)
        buf[sl] = np.asarray(data, dtype=dtype).reshape([b - a for a, b in idx])
        covered += int(np.prod([b - a for a, b in idx]))
    if covered < int(np.prod(shape)):
        raise CheckpointCorruptError(f"{name}: shards cover {covered} of "
                                     f"{int(np.prod(shape))} elements (missing rank file?)")
    return buf


def load(path):
    """Read and verify a snapshot (of any world size): ``(flat, manifest)``,
    ``flat`` mapping leaf name -> global numpy array."""
    manifest = _read_manifest(path)
    pieces = {}
    for fname, meta in manifest["files"].items():
        data = _read_checked(path, fname, meta)
        if not fname.endswith(".pdshard"):
            continue
        for name, ps in _ser.loads(data, return_numpy=True)["pieces"].items():
            pieces.setdefault(name, []).extend(ps)
    flat = {name: _assemble(name, entry, pieces.get(name, []))
            for name, entry in manifest.get("entries", {}).items()}
    return flat, manifest


def sweep_tmp(parent):
    """Remove torn ``*.tmp`` snapshot directories under ``parent``; returns
    their paths."""
    removed = []
    try:
        listing = os.listdir(parent)
    except FileNotFoundError:
        return removed
    for d in listing:
        full = os.path.join(parent, d)
        if d.endswith(".tmp") and os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
            removed.append(full)
    return removed


def latest_checkpoint(parent, prefix="step_"):
    """The newest intact ``<prefix>N`` snapshot under ``parent``, newest
    first, skipping corrupt or manifest-less ones: ``(path, manifest)`` or
    ``(None, None)``."""
    try:
        listing = os.listdir(parent)
    except FileNotFoundError:
        return None, None
    candidates = []
    for d in listing:
        if not d.startswith(prefix) or d.endswith(".tmp"):
            continue
        try:
            candidates.append((int(d[len(prefix):]), d))
        except ValueError:
            continue
    for _, d in sorted(candidates, reverse=True):
        full = os.path.join(parent, d)
        try:
            return full, validate(full)
        except CheckpointCorruptError:
            continue
    return None, None


# -- train-step integration ----------------------------------------------------------


def save_train_step(step_obj, path, step=None, async_=None, keep=None):
    """Snapshot a train step's state (:meth:`TrainStepFn.state_leaves`)."""
    return save(path, step_obj.state_leaves(), step=step, keep=keep, async_=async_)


def restore_train_step(step_obj, path):
    """Load a snapshot into a live train step (copied into its tensors);
    raises :class:`CheckpointError` when a leaf name is missing or extra or
    a shape differs. Returns the manifest."""
    flat, manifest = load(path)
    if int(manifest.get("world") or 1) != _WORLD:
        raise _unported(f"from a world of {manifest.get('world')}")
    try:
        step_obj.load_state_leaves(flat)
    except (KeyError, ValueError) as e:
        raise CheckpointError(f"{path} does not match this train step's state: {e}") from e
    return manifest


# -- background writer -------------------------------------------------------------


class _Pending:
    def __init__(self, label):
        self.label = label
        self.error = None
        self._done = threading.Event()

    @property
    def done(self):
        return self._done.is_set()

    def wait(self, timeout=None, raise_error=True):
        if not self._done.wait(timeout):
            raise CheckpointError(f"checkpoint save {self.label!r} still pending after "
                                  f"{timeout}s")
        if raise_error and self.error is not None:
            raise self.error
        return self


class AsyncSaver:
    """One FIFO writer thread, started at the first submit: snapshots
    publish in submission order (rotation and resume depend on it)."""

    def __init__(self):
        self._q = queue.Queue()
        self._lock = threading.Lock()
        self._thread = None
        self._pending = []

    def submit(self, fn, label=""):
        p = _Pending(label)
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="ptt-ckpt-writer",
                                                daemon=True)
                self._thread.start()
            # an errored pending stays until a wait_pending() raises it
            self._pending = [x for x in self._pending if not x.done or x.error is not None]
            self._pending.append(p)
        self._q.put((fn, p))
        return p

    def _run(self):
        while True:
            fn, p = self._q.get()
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — surfaced by wait_pending
                p.error = e
            finally:
                p._done.set()

    def wait_pending(self, timeout=None, raise_errors=True):
        """Wait for every submitted save; with ``raise_errors`` re-raise the
        first failure (or a timeout). Saves still running at the timeout
        stay pending."""
        with self._lock:
            pending, self._pending = self._pending, []
        first, unfinished = None, []
        for p in pending:
            if not p._done.wait(timeout):
                unfinished.append(p)
                continue
            if first is None and p.error is not None:
                first = p.error
        if unfinished:
            with self._lock:
                self._pending = unfinished + self._pending
        if raise_errors:
            if first is not None:
                raise first
            if unfinished:
                raise CheckpointError(f"{len(unfinished)} checkpoint saves still pending after "
                                      f"{timeout}s (first: {unfinished[0].label!r})")
        return first


_SAVER = AsyncSaver()


def wait_pending(timeout=None, raise_errors=True):
    """Block until every queued save is durable (or failed)."""
    return _SAVER.wait_pending(timeout=timeout, raise_errors=raise_errors)


def submit(fn, label=""):
    """Queue durable-write work on the shared FIFO writer thread, so epoch
    and step snapshots publish in one order."""
    return _SAVER.submit(fn, label)
