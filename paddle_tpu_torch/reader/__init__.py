"""Reader decorator library (paddle.reader; ``paddle_tpu/reader``, host code copied for the port).

Reference parity: python/paddle/reader/decorator.py:36 (cache), :60
(map_readers), :102 (shuffle), :151 (chain), :216 (compose), :276
(buffered), :319 (firstn), :364 (xmap_readers), :457
(multiprocess_reader). A "reader" is a zero-arg callable returning an
iterator of samples; decorators wrap readers into new readers — the book-
style data-pipeline idiom that predates DataLoader.

Notes: these run on the host and feed the DataLoader /
Dataset paths; buffered/xmap use threads + queues (the host side is IO
bound, the GIL is released in file/np ops), and xmap's ordered mode uses
a condition variable instead of the reference's spin-wait
(decorator.py:414 ``while order != out_order[0]: pass`` burns a core).
"""
from __future__ import annotations

import itertools
import random as _random
from queue import Queue
from threading import Condition, Thread

__all__ = [
    "cache", "map_readers", "shuffle", "chain", "compose", "buffered",
    "firstn", "xmap_readers", "multiprocess_reader", "ComposeNotAligned",
]


class ComposeNotAligned(ValueError):
    pass


def cache(reader):
    """Materialize ``reader()`` once; replay from memory afterwards."""
    all_data = tuple(reader())

    def __impl__():
        return iter(all_data)

    return __impl__


def map_readers(func, *readers):
    """Reader yielding ``func(*samples)`` over the zipped input readers."""

    def reader():
        rs = [r() for r in readers]
        for e in map(func, *rs):
            yield e

    return reader


def shuffle(reader, buf_size):
    """Shuffle within a sliding buffer of ``buf_size`` samples."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            _random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers back to back (format unchanged)."""

    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, **kwargs):
    """Zip readers side by side, flattening tuple outputs.

    ``check_alignment=True`` (default) raises ComposeNotAligned when the
    readers have different lengths; False silently truncates to the
    shortest.
    """
    check_alignment = kwargs.pop("check_alignment", True)
    if kwargs:
        raise TypeError(f"unexpected kwargs {sorted(kwargs)}")

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(map(make_tuple, outputs), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned (different "
                        "lengths); pass check_alignment=False to truncate")
                yield sum(map(make_tuple, outputs), ())

    return reader


class _End:
    pass


class _Raise:
    """Error marker forwarded from a worker thread to the consumer —
    a reader that dies must raise, never silently truncate the stream."""

    def __init__(self, exc):
        self.exc = exc


def buffered(reader, size):
    """Prefetch up to ``size`` samples on a background thread."""

    end = _End()

    def read_worker(it, q):
        try:
            for d in it:
                q.put(d)
        except Exception as e:
            q.put(_Raise(e))
        finally:
            q.put(end)

    def data_reader():
        q = Queue(maxsize=size)
        t = Thread(target=read_worker, args=(reader(), q), daemon=True)
        t.start()
        e = q.get()
        while e is not end:
            if isinstance(e, _Raise):
                raise RuntimeError("buffered reader source failed") from e.exc
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    """Limit the reader to its first ``n`` samples."""

    def firstn_reader():
        return itertools.islice(reader(), n)

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Map samples with ``process_num`` worker threads.

    ``order=True`` preserves the source order (condition-variable
    hand-off — no spin-wait).
    """
    end = _End()

    def data_reader():
        in_q = Queue(buffer_size)
        out_q = Queue(buffer_size)

        def read_worker():
            try:
                for i, sample in enumerate(reader()):
                    in_q.put((i, sample))
            except Exception as e:
                out_q.put(_Raise(e))
            finally:
                in_q.put(end)

        cond = Condition()
        state = {"next": 0}

        def handle_worker():
            while True:
                item = in_q.get()
                if item is end:
                    in_q.put(end)  # wake the other workers
                    out_q.put(end)
                    return
                idx, sample = item
                try:
                    r = mapper(sample)
                except Exception as e:
                    # a dying worker must still release ordered peers
                    # waiting for this index and deliver its end marker
                    if order:
                        with cond:
                            state["next"] = max(state["next"], idx + 1)
                            cond.notify_all()
                    out_q.put(_Raise(e))
                    out_q.put(end)
                    return
                if order:
                    with cond:
                        while state["next"] != idx:
                            cond.wait()
                        out_q.put(r)
                        state["next"] += 1
                        cond.notify_all()
                else:
                    out_q.put(r)

        Thread(target=read_worker, daemon=True).start()
        for _ in range(process_num):
            Thread(target=handle_worker, daemon=True).start()
        finished = 0
        while finished < process_num:
            e = out_q.get()
            if e is end:
                finished += 1
            elif isinstance(e, _Raise):
                raise RuntimeError("xmap_readers worker failed") from e.exc
            else:
                yield e

    return data_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Run several readers in worker PROCESSES, merging their outputs.

    decorator.py:457 — the reference forks one process per reader and
    multiplexes over a multiprocessing queue/pipe; samples interleave in
    arrival order. Requires the readers (and their samples) to be
    picklable.
    """
    import multiprocessing as mp

    if len(readers) < 1:
        raise ValueError("readers number must be greater than 0")

    def queue_reader():
        ctx = mp.get_context("fork")
        q = ctx.Queue(queue_size)

        def worker(r):
            try:
                for s in r():
                    q.put(s)
            except Exception as e:  # propagate loudly, never hang
                q.put(("__mp_reader_error__", f"{type(e).__name__}: {e}"))
            finally:
                q.put(None)

        procs = [ctx.Process(target=worker, args=(r,), daemon=True)
                 for r in readers]
        for p in procs:
            p.start()
        finished = 0
        while finished < len(readers):
            sample = q.get()
            if sample is None:
                finished += 1
            elif (isinstance(sample, tuple) and len(sample) == 2
                  and sample[0] == "__mp_reader_error__"):
                raise RuntimeError(f"multiprocess_reader worker: {sample[1]}")
            else:
                yield sample
        for p in procs:
            p.join(timeout=5.0)

    return queue_reader
