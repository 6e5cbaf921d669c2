"""DataLoader with multiprocess workers and a prefetch to the card (``paddle_tpu/io/dataloader.py``).

Workers are forked processes that index the dataset and collate numpy
batches; they never touch CUDA (a sample on the card raises there). A batch
travels back over the worker's shared-memory ring (``_native/shm_ring.cpp``)
or, when the ring is unavailable or the batch larger than the ring's 64 MiB,
pickled through the ``multiprocessing`` queue, as in the JAX package; the
registry counters ``io/ring_batches`` and ``io/queue_batches`` count which
transport carried each batch.

With ``use_buffer_reader`` (the default) a :class:`_DevicePrefetcher` keeps
``prefetch_factor`` batches in flight. On the card its fill thread copies
each collated batch into pinned host memory, enqueues the copy to the card
with ``non_blocking=True`` on a side CUDA stream and records an event; the
consumer's ``__next__`` makes its current stream (the stream a train step's
replay copies from) wait on that event and marks each tensor used there
(``record_stream``), so the caching allocator cannot hand the memory to a
later batch while the step still reads it. A pinned block returns to
PyTorch's host allocator only after the copy that read it has completed.
On the CPU (``places=CPUPlace()``, or ``set_device("cpu")``) batches are
CPU tensors and nothing is pinned. ``FLAGS_io_prefetch_overlap`` off
refills inline in ``__next__``, as the JAX flag does.

Workers inherit the parent's numpy random state and do not reseed, as the
JAX package's workers: random transforms repeat across workers.
"""
from __future__ import annotations

import atexit
import itertools
import multiprocessing as mp
import os
import queue as queue_mod
import threading
import time
import weakref

import numpy as np
import torch

from ..monitor import record_input_wait_ms, registry as _mon
from ..monitor import flight_recorder as _flight
from ..profiler import RecordEvent
from .dataset import IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]

# stop sentinel must survive pickling across the process boundary (an
# object() loses identity in the worker), so use None
_MP_STOP = None
RING_CAPACITY = 64 << 20

_in_worker = False  # set in a forked worker process


def default_collate_fn(batch):
    """Stack samples into numpy batch arrays (fluid/dataloader/collate.py)."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return type(sample)(
            default_collate_fn([s[i] for s in batch])
            for i in range(len(sample))
        )
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, torch.Tensor):
        if _in_worker and any(s.device.type != "cpu" for s in batch):
            raise RuntimeError(
                "DataLoader worker got a sample on the card: workers are forked "
                "processes and must not touch CUDA; return numpy arrays or CPU "
                "tensors from the dataset")
        return np.stack([s.detach().to("cpu").numpy() for s in batch])
    return np.asarray(batch)


def _worker_loop(dataset, index_queue, data_queue, collate_fn, ring_name,
                 ring_capacity):
    """Worker process body (reader.py:870 _reader_process_loop): results
    go over the shared-memory ring when it is there, else (and for errors)
    through the queue."""
    global _in_worker
    _in_worker = True
    ring = None
    if ring_name:
        try:
            from .._native import ShmRing

            ring = ShmRing(ring_name, capacity=ring_capacity, owner=False)
        except Exception:
            ring = None
    try:
        while True:
            task = index_queue.get()
            if task is None:
                break
            seq, indices = task
            try:
                batch = collate_fn([dataset[i] for i in indices])
                if ring is not None:
                    try:
                        ring.put((seq, batch))
                        data_queue.put((seq, ring_name, None))  # ready signal
                        continue
                    except ValueError:  # batch larger than the ring
                        pass
                data_queue.put((seq, batch, None))
            except Exception as e:  # propagate to main process
                data_queue.put((seq, None, e))
    except KeyboardInterrupt:
        pass
    finally:
        if ring is not None:
            ring.close(unlink=False)


class _MultiprocessIter:
    def __init__(self, loader):
        self.loader = loader
        ds = loader.dataset
        self.batches = list(iter(loader.batch_sampler))
        ctx = mp.get_context("fork")
        self.index_queue = ctx.Queue()
        self.data_queue = ctx.Queue(maxsize=loader.num_workers * loader.prefetch_factor)
        # one shared-memory ring per worker (SPSC); None disables
        self.rings = {}
        ring_names = [None] * loader.num_workers
        if loader.use_shared_memory:
            try:
                from .._native import ShmRing, available

                if available():
                    for i in range(loader.num_workers):
                        name = f"/ptt_dl_{os.getpid()}_{id(self) & 0xFFFF}_{i}"
                        self.rings[name] = ShmRing(name, capacity=RING_CAPACITY, owner=True)
                    ring_names = list(self.rings.keys())
            except Exception:
                self.rings = {}
        self.workers = [
            ctx.Process(
                target=_worker_loop,
                args=(ds, self.index_queue, self.data_queue,
                      loader.collate_fn, ring_names[i], RING_CAPACITY),
                daemon=True,
            )
            for i in range(loader.num_workers)
        ]
        for w in self.workers:
            w.start()
        _flight.record_event(
            "dataloader_workers_start", workers=len(self.workers),
            pids=[w.pid for w in self.workers],
            batches=len(self.batches), shm_rings=len(self.rings))
        atexit.register(self.shutdown)
        self._send = 0
        self._recv = 0
        self._reorder = {}
        for _ in range(loader.num_workers * loader.prefetch_factor):
            self._dispatch()

    def _dispatch(self):
        if self._send < len(self.batches):
            self.index_queue.put((self._send, self.batches[self._send]))
            self._send += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._recv >= len(self.batches):
            self.shutdown()
            raise StopIteration
        if self._recv not in self._reorder:
            with RecordEvent("dataloader::worker_wait"):
                t0 = time.perf_counter()
                while self._recv not in self._reorder:
                    seq, batch, err = self.data_queue.get()
                    if err is not None:
                        self.shutdown()
                        raise err
                    if isinstance(batch, str) and batch in self.rings:
                        # ready-signal: payload sits in that worker's ring
                        seq, batch = self.rings[batch].get()
                        _mon.counter("io/ring_batches").inc()
                    else:
                        _mon.counter("io/queue_batches").inc()
                    self._reorder[seq] = batch
                _mon.histogram("io/worker_wait_ms").observe(
                    (time.perf_counter() - t0) * 1e3)
        batch = self._reorder.pop(self._recv)
        self._recv += 1
        self._dispatch()
        return batch

    def shutdown(self):
        if self.workers:
            _flight.record_event(
                "dataloader_workers_stop", workers=len(self.workers),
                delivered=getattr(self, "_recv", 0),
                dispatched=getattr(self, "_send", 0))
        for _ in self.workers:
            try:
                self.index_queue.put(_MP_STOP)
            except Exception:
                pass
        for w in self.workers:
            w.join(timeout=1)
            if w.is_alive():
                w.terminate()
        self.workers = []
        for ring in getattr(self, "rings", {}).values():
            try:
                ring.close(unlink=True)
            except Exception:
                pass
        self.rings = {}


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _host_tensor(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x


class _Staged:
    """A batch whose copies to the card were enqueued on a side stream:
    the tensors on the card, the event recorded after the copies, and the
    pinned host tensors the copies read (held until the consumer lands it)."""

    __slots__ = ("batch", "event", "pinned")

    def __init__(self, batch, event, pinned):
        self.batch, self.event, self.pinned = batch, event, pinned


class _ToDevice:
    """The copy to ``device``: numpy leaves become tensors; on a CUDA device
    they are pinned and copied on a side stream (:meth:`stage`, the fill
    thread), then made safe for the consumer's stream (:meth:`land`)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                       else None)

    def stage(self, batch):
        if self.stream is None:
            return _tree_map(lambda x: _host_tensor(x).to(self.device)
                             if isinstance(x, (np.ndarray, torch.Tensor)) else x, batch)
        pinned = []

        def pin(x):
            x = _host_tensor(x)
            if not isinstance(x, torch.Tensor):
                return x
            if x.device.type == "cpu":
                x = x.pin_memory()
                pinned.append(x)
            return x

        host = _tree_map(pin, batch)
        with torch.cuda.stream(self.stream):
            dev = _tree_map(lambda x: x.to(self.device, non_blocking=True)
                            if isinstance(x, torch.Tensor) else x, host)
            event = torch.cuda.Event()
            event.record(self.stream)
        return _Staged(dev, event, pinned)

    def land(self, item):
        if not isinstance(item, _Staged):
            return item
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(item.event)

        def mark(x):
            if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                x.record_stream(cur)
            return x

        return _tree_map(mark, item.batch)


class _DevicePrefetcher:
    """buffered_reader.cc's role: keep ``depth`` batches already staged for
    ``device``, the upstream fetch and the copy overlapping the consumer's
    step. With ``FLAGS_io_prefetch_overlap`` a background thread owns the
    upstream ``next()`` and the copy's enqueue, double-buffered through a
    bounded queue; off, ``__next__`` refills inline. ``device=None``
    hands the upstream batches on as they are. Shared by the DataLoader's
    buffer reader and ``Executor.train_from_dataset``."""

    _DONE = object()

    def __init__(self, it, depth=2, device=None):
        from ..flags import flag

        self.it = it
        self.depth = max(1, int(depth))
        self.copy = _ToDevice(device) if device is not None else None
        self._overlap = bool(flag("io_prefetch_overlap"))
        if self._overlap:
            self._q = queue_mod.Queue(maxsize=self.depth)
            self._stop = threading.Event()
            self._done = False
            # the fill thread closes only over (it, copy, q, stop), never
            # self, so an abandoned prefetcher can be collected and its
            # finalizer stop the thread
            self._thread = threading.Thread(
                target=_prefetch_fill_loop,
                args=(self.it, self.copy, self._q, self._stop, self._DONE),
                name="ptt-h2d-prefetch", daemon=True)
            self._thread.start()
            self._finalizer = weakref.finalize(self, self._stop.set)
        else:
            self.buf = []
            self._fill()

    def close(self, join=False):
        """Stop the background fill (idempotent); ``join`` waits for the
        thread to end."""
        if self._overlap:
            self._stop.set()
            if join and self._thread is not threading.current_thread():
                self._thread.join()

    def _fill(self):
        while len(self.buf) < self.depth:
            try:
                self.buf.append(_prefetch_prepare(self.it, self.copy))
            except StopIteration:
                return

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        if self._overlap:
            if self._done:
                raise StopIteration
            while True:
                try:
                    item = self._q.get(timeout=0.1)
                    break
                except queue_mod.Empty:
                    # after close() the fill thread puts nothing more
                    if self._stop.is_set():
                        self._done = True
                        raise StopIteration
            if item is self._DONE:
                self._done = True
                self.close()
                raise StopIteration
            if isinstance(item, BaseException):
                self._done = True
                self.close()
                raise item
        else:
            if not self.buf:
                raise StopIteration
            item = self.buf.pop(0)
            self._fill()
        batch = self.copy.land(item) if self.copy is not None else item
        _mon.counter("io/batches").inc()
        record_input_wait_ms((time.perf_counter() - t0) * 1e3)
        return batch


def _prefetch_prepare(it, copy):
    """One upstream fetch and the copy's enqueue (both prefetcher paths)."""
    with RecordEvent("dataloader::prefetch_fill"):
        batch = next(it)
    if copy is not None:
        with RecordEvent("dataloader::h2d"):
            batch = copy.stage(batch)
    return batch


def _prefetch_fill_loop(it, copy, q, stop, done_sentinel):
    """_DevicePrefetcher's background fill; exceptions travel to the
    consumer through the queue."""

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    tail = done_sentinel
    try:
        while not stop.is_set():
            try:
                item = _prefetch_prepare(it, copy)
            except StopIteration:
                break
            except BaseException as e:  # surface on the consumer side
                tail = e
                break
            if not put(item):
                return  # consumer abandoned the iterator
    finally:
        put(tail)


class _AccountedIter:
    """Input-wait accounting for the unbuffered path; attribute access
    reaches the multiprocess iterator underneath."""

    def __init__(self, it):
        self._it = it

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self._it)
        _mon.counter("io/batches").inc()
        record_input_wait_ms((time.perf_counter() - t0) * 1e3)
        return batch

    def __getattr__(self, name):
        return getattr(self._it, name)


def _loader_device(places):
    from ..framework.place import default_device, to_torch_device

    if places is None:
        return default_device()
    if isinstance(places, (list, tuple)):
        places = places[0]
    return to_torch_device(places)


class DataLoader:
    """paddle.io.DataLoader (fluid/reader.py:123). Buffered batches land on
    ``places`` (default: the :func:`~paddle_tpu_torch.set_device` choice,
    else the card; raises with neither); ``use_buffer_reader=False`` yields
    the collated numpy batches."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None):
        self.dataset = dataset
        self.places = places
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.return_list = return_list
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self._prefetcher = None
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last,
            )

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _single_iter(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        _flight.record_event(
            "dataloader_epoch",
            workers=self.num_workers if not self._iterable_mode else 0,
            iterable=self._iterable_mode,
            buffered=self.use_buffer_reader)
        device = _loader_device(self.places) if self.use_buffer_reader else None
        # the previous epoch's fill thread ends before workers are forked:
        # a lock it held at the fork would stay held in every worker
        prev = self._prefetcher() if self._prefetcher is not None else None
        if prev is not None:
            prev.close(join=True)
        if self.num_workers > 0 and not self._iterable_mode:
            it = iter(_MultiprocessIter(self))
        else:
            it = self._single_iter()
        if self.use_buffer_reader:
            pf = _DevicePrefetcher(it, depth=self.prefetch_factor, device=device)
            self._prefetcher = weakref.ref(pf)
            return iter(pf)
        return _AccountedIter(it)
