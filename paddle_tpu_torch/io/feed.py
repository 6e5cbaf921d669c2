"""Dataset/DataFeed ingestion (``paddle_tpu/io/feed.py``): the file-list pipeline.

Reference parity: python/paddle/fluid/dataset.py (DatasetFactory :37,
InMemoryDataset :328 with load_into_memory/local_shuffle/global_shuffle,
QueueDataset :632 streaming) over the C++ runtime
paddle/fluid/framework/data_set.cc + data_feed.cc (MultiSlotDataFeed text
format: per line, per slot: count then values).

The parse loop is the port's copy of the native C++ parser
(``_native/datafeed.cpp``, a two-pass tokenizer over the file's bytes),
fanned out over worker processes that send their pools back over the
DataLoader's shared-memory rings; without ``g++`` a Python tokenizer parses
the same format. Batches are numpy arrays of fixed shapes: each sparse slot
padded with 0 or cut to its declared width, as the JAX package's, so a
captured step sees one signature. ``Executor.train_from_dataset`` runs the
program over the batches, copied to the executor's device ahead of use
(``io.dataloader._DevicePrefetcher``).
"""
from __future__ import annotations

import glob as _glob
import multiprocessing as mp
import os
import subprocess

import numpy as np

__all__ = ["DatasetFactory", "DatasetBase", "InMemoryDataset",
           "QueueDataset"]


class DatasetFactory:
    """fluid.DatasetFactory parity: create_dataset by class name."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")


def _parse_bytes(buf, slot_is_float):
    """Native parser with a pure-python fallback."""
    from .. import _native

    if _native.datafeed_available():
        return _native.multislot_parse(buf, slot_is_float)
    # fallback: python tokenizer (same format, ~20x slower)
    counts, ints, floats = [], [], []
    for line in buf.decode().splitlines():
        toks = line.split()
        if not toks:
            continue
        i = 0
        for s, is_f in enumerate(slot_is_float):
            cnt = int(toks[i]); i += 1
            counts.append(cnt)
            for _ in range(cnt):
                (floats if is_f else ints).append(
                    float(toks[i]) if is_f else int(toks[i]))
                i += 1
        if i != len(toks):
            raise ValueError(f"malformed MultiSlot line: {line!r}")
    n_slots = len(slot_is_float)
    return (np.asarray(counts, np.int64).reshape(-1, n_slots),
            np.asarray(ints, np.int64), np.asarray(floats, np.float32))


def _read_file(path, pipe_command=None):
    if pipe_command and pipe_command not in ("cat", "cat ", ""):
        with open(path, "rb") as f:
            out = subprocess.run(
                pipe_command, shell=True, stdin=f,
                capture_output=True, check=True,
            )
        return out.stdout
    with open(path, "rb") as f:
        return f.read()


def _parse_worker(files, slot_is_float, pipe_command, ring_name):
    """Worker process: parse assigned files, push per-file pools onto its
    OWN ring (the ShmRing is single-producer single-consumer — one ring
    per worker, exactly like the DataLoader's transport)."""
    ring = None
    try:
        from .. import _native

        ring = _native.ShmRing(ring_name, owner=False)
        for path in files:
            buf = _read_file(path, pipe_command)
            pools = _parse_bytes(buf, slot_is_float)
            ring.put(("data", pools))
        ring.put(("done", None))
        ring.close(unlink=False)
    except Exception as e:  # propagate the failure to the consumer
        if ring is not None:
            try:
                ring.put(("error", f"{type(e).__name__}: {e}"))
                ring.close(unlink=False)
            except Exception:
                pass


class DatasetBase:
    """Shared Dataset surface (fluid/dataset.py DatasetBase :64)."""

    def __init__(self):
        self._batch_size = 1
        self._thread_num = 1
        self._filelist = []
        self._use_vars = []
        self._pipe_command = None
        self._fleet = None
        self._seed = None

    # -- configuration (reference method names) -----------------------------
    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self._thread_num = max(1, int(thread_num))

    def set_filelist(self, filelist):
        out = []
        for f in filelist:
            hits = sorted(_glob.glob(f)) if any(c in f for c in "*?[") else [f]
            out.extend(hits or [f])
        self._filelist = out

    def set_use_var(self, var_list):
        """Declare the slot order/dtypes/widths from program data vars
        (dataset.py set_use_var — builds the data_feed.proto slot list)."""
        self._use_vars = list(var_list)

    def set_pipe_command(self, pipe_command):
        self._pipe_command = pipe_command

    def set_hdfs_config(self, fs_name, fs_ugi):  # accepted for parity
        self._hdfs = (fs_name, fs_ugi)

    def desc(self):
        slots = ", ".join(
            f"{getattr(v, 'name', v)}:{self._slot_kind(v)}"
            for v in self._use_vars
        )
        return (f"{type(self).__name__}(batch={self._batch_size}, "
                f"threads={self._thread_num}, files={len(self._filelist)}, "
                f"slots=[{slots}])")

    # -- slot plumbing -------------------------------------------------------
    @staticmethod
    def _slot_kind(v):
        d = str(getattr(v, "dtype", "int64"))
        return "float" if ("float" in d or "double" in d) else "int"

    def _slot_spec(self):
        if not self._use_vars:
            raise ValueError("call set_use_var(...) before reading data")
        is_float = [self._slot_kind(v) == "float" for v in self._use_vars]
        widths = []
        for v in self._use_vars:
            shape = list(getattr(v, "shape", None) or [1])
            w = 1
            for d in shape[1:] if len(shape) > 1 else shape[-1:]:
                if d is not None and int(d) > 0:
                    w *= int(d)
            widths.append(max(1, w))
        return is_float, widths

    def _pools_iter(self):
        """Yield (file_idx, (counts, ints, floats)) per file, parsed by
        worker processes over the shm ring (DataLoader's transport).

        file_idx is the file's position in the filelist. With thread>1 the
        rings drain in timing-dependent order, but worker w emits exactly
        one pool per assigned file, in order — so the consumer recovers
        the deterministic index as w + seq_w * n_workers. InMemoryDataset
        reassembles in file order; without this, every trainer would hold
        a differently-ordered memory and a positional global_shuffle
        partition would silently drop/duplicate instances."""
        is_float, _ = self._slot_spec()
        if not self._filelist:
            return
        from .. import _native

        n_workers = min(self._thread_num, len(self._filelist))
        if n_workers <= 1 or not _native.available():
            for idx, path in enumerate(self._filelist):
                yield idx, _parse_bytes(
                    _read_file(path, self._pipe_command), is_float)
            return

        # one SPSC ring per worker (shm_ring.cpp's contract); the consumer
        # round-robins over them
        rings = [
            _native.ShmRing(capacity=(256 << 20) // n_workers)
            for _ in range(n_workers)
        ]
        ctx = mp.get_context("fork")
        procs = []
        for w in range(n_workers):
            files = self._filelist[w::n_workers]
            p = ctx.Process(
                target=_parse_worker,
                args=(files, is_float, self._pipe_command, rings[w].name),
                daemon=True,
            )
            p.start()
            procs.append(p)
        live = set(range(n_workers))
        seq = [0] * n_workers  # per-worker pool count -> global file index
        try:
            while live:
                progressed = False
                for w in sorted(live):
                    if rings[w].empty():
                        if not procs[w].is_alive():
                            # died without a done/error record (segfault,
                            # kill): drain anything left, then fail fast
                            # instead of a 120s timeout
                            if rings[w].empty():
                                raise RuntimeError(
                                    f"dataset parse worker {w} exited "
                                    f"(code {procs[w].exitcode}) without "
                                    "completing"
                                )
                        continue
                    kind, payload = rings[w].get(timeout=30.0)
                    progressed = True
                    if kind == "done":
                        live.discard(w)
                    elif kind == "error":
                        raise RuntimeError(
                            f"dataset parse worker {w}: {payload}"
                        )
                    else:
                        file_idx = w + seq[w] * n_workers
                        seq[w] += 1
                        yield file_idx, payload
                if live and not progressed:
                    import time as _time

                    _time.sleep(0.002)
        finally:
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
            for r in rings:
                r.close(unlink=True)

    def _split_instances(self, pools):
        """Pool arrays -> list of per-instance per-slot value arrays."""
        counts, ints, floats = pools
        is_float, _ = self._slot_spec()
        out = []
        ii = fi = 0
        for r in range(counts.shape[0]):
            inst = []
            for s, is_f in enumerate(is_float):
                c = int(counts[r, s])
                if is_f:
                    inst.append(floats[fi:fi + c])
                    fi += c
                else:
                    inst.append(ints[ii:ii + c])
                    ii += c
            out.append(inst)
        return out

    def _assemble_batch(self, instances):
        """Fixed-shape batch per slot: [B, width], pad 0 / truncate (the
        XLA static-shape stand-in for the reference's LoDTensor slots)."""
        is_float, widths = self._slot_spec()
        batch = []
        for s, (is_f, w) in enumerate(zip(is_float, widths)):
            dt = np.float32 if is_f else np.int64
            arr = np.zeros((len(instances), w), dt)
            for r, inst in enumerate(instances):
                vals = inst[s][:w]
                arr[r, :len(vals)] = vals
            batch.append(arr)
        return batch

    def _feed_names(self):
        return [getattr(v, "name", str(v)) for v in self._use_vars]

    def _iter_device_batches(self, depth=2, device=None):
        """Batches on ``device``: ``depth`` copies kept in flight by the
        DataLoader's ``_DevicePrefetcher``, so the run of batch N overlaps
        the copy of batch N+1."""
        from .dataloader import _DevicePrefetcher

        return iter(_DevicePrefetcher(iter(self._iter_batches()),
                                      depth=depth, device=device))

    # subclasses provide _iter_batches()


class InMemoryDataset(DatasetBase):
    """fluid.InMemoryDataset (dataset.py:328): parse everything into host
    memory once, then shuffle/iterate without touching the files again."""

    def __init__(self):
        super().__init__()
        self._memory = []
        self._shuffled = None

    def load_into_memory(self):
        # reassemble in file order so every trainer holding the same
        # filelist holds the same instance ordering, no matter how the
        # worker rings interleave — global_shuffle's positional partition
        # depends on this. Only out-of-order pools are buffered (the
        # drain-order backlog), not the whole dataset twice.
        self._memory = []
        pending = {}
        next_idx = 0
        for idx, pools in self._pools_iter():
            pending[idx] = pools
            while next_idx in pending:
                self._memory.extend(
                    self._split_instances(pending.pop(next_idx)))
                next_idx += 1
        for idx in sorted(pending):  # gaps only if a tail file was empty
            self._memory.extend(self._split_instances(pending.pop(idx)))
        self._shuffled = None

    def local_shuffle(self):
        rng = np.random.RandomState(self._seed)
        order = rng.permutation(len(self._memory))
        self._shuffled = [self._memory[i] for i in order]

    def global_shuffle(self, fleet=None, thread_num=12):
        """Cross-trainer shuffle — decentralized redesign of the
        reference's PS-mediated global shuffle (data_set.cc GlobalShuffle).

        PRECONDITION (differs from the reference!): with multiple
        trainers, every trainer must have loaded the SAME FULL filelist.
        All trainers then draw the same permutation seed and each keeps
        the 1/trainer_num partition hashed to its id — same global
        coverage as the reference's instance exchange, with the file reads
        replacing the PS network hop. Feeding per-trainer DISJOINT
        filelists here would silently drop (n-1)/n of the corpus, so that
        layout is rejected loudly: shard via global_shuffle, not via the
        filelist. With one trainer this degenerates to local_shuffle.
        """
        trainer_id, trainer_num = 0, 1
        if fleet is not None:
            trainer_id = getattr(fleet, "worker_index", lambda: 0)()
            trainer_num = getattr(fleet, "worker_num", lambda: 1)()
        seed = self._seed if self._seed is not None else 12345
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(self._memory))
        if trainer_num > 1:
            sizes = None
            allgather = getattr(fleet, "_all_gather", None)
            if callable(allgather):
                try:
                    sizes = allgather(len(self._memory))
                except Exception:
                    sizes = None
            if sizes is not None and len(set(int(s) for s in sizes)) > 1:
                raise RuntimeError(
                    "global_shuffle requires every trainer to load the "
                    "same full filelist (got per-trainer sizes "
                    f"{sizes}); see InMemoryDataset.global_shuffle docs"
                )
            order = [i for i in order if i % trainer_num == trainer_id]
        self._shuffled = [self._memory[i] for i in order]

    def release_memory(self):
        self._memory = []
        self._shuffled = None

    def get_memory_data_size(self, fleet=None):
        return len(self._memory)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._shuffled if self._shuffled is not None
                   else self._memory)

    def set_shuffle_seed(self, seed):
        self._seed = int(seed)

    def _iter_batches(self):
        data = self._shuffled if self._shuffled is not None else self._memory
        b = self._batch_size
        for i in range(0, len(data) - b + 1, b):
            yield self._assemble_batch(data[i:i + b])


class QueueDataset(DatasetBase):
    """fluid.QueueDataset (dataset.py:632): single-pass streaming — files
    are parsed by the workers while training consumes batches; nothing is
    retained."""

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset is single-pass streaming; use InMemoryDataset "
            "for shuffles (fluid/dataset.py:664 raises the same way)"
        )

    def global_shuffle(self, fleet=None):
        raise NotImplementedError(
            "QueueDataset does not support global shuffle "
            "(fluid/dataset.py:678)"
        )

    def _iter_batches(self):
        b = self._batch_size
        pending = []
        for _idx, pools in self._pools_iter():
            pending.extend(self._split_instances(pools))
            while len(pending) >= b:
                yield self._assemble_batch(pending[:b])
                pending = pending[b:]
