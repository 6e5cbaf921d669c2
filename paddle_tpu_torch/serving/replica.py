"""Replica pool: worker threads serving one shared module (``paddle_tpu/serving/replica.py``).

Each worker pulls assembled batches from a :class:`DynamicBatcher` and runs
them on a ``Predictor.clone()``; the clones share one module and one store
of graphs, so N workers hold one copy of the weights on the card and one
graph per bucket. Warmup runs one zero-filled batch of every bucket before
traffic, which on the card captures that bucket's graph, then arms a
:class:`~paddle_tpu_torch.runtime.compiled.CompileWatch` over the
predictor's store: a capture after warmup (a feed off the bucket ladder, a
program or weight replaced) is counted as unexpected
(:meth:`ReplicaPool.extra_compiles`, ``/statz`` ``compiles``, the
``serving/unexpected_compiles`` counter that ``/loadz`` reads). Each
dispatch's time observes ``serving/dispatch_ms``. ``/healthz`` gates on
warmup.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..errors import InvalidArgumentError
from ..flags import flag
from ..monitor import histogram
from ..monitor import tracing as _tracing
from ..profiler import RecordEvent
from ..runtime.compiled import CompileWatch

__all__ = ["ReplicaPool", "predictor_input_specs"]


def predictor_input_specs(predictor) -> dict:
    """Per-feed ``(feature_shape, dtype)`` from the predictor's
    ``InputSpec``s: the leading (batch) axis is stripped; the rest must be
    static so warmup can build bucket-shaped batches."""
    specs = {}
    for spec in predictor.input_spec:
        if len(spec.shape) < 1:
            raise InvalidArgumentError(
                f"feed {spec.name!r} needs a leading batch axis, got {spec.shape!r}")
        feat = spec.shape[1:]
        if any(d is None or int(d) < 0 for d in feat):
            raise InvalidArgumentError(
                f"feed {spec.name!r} has dynamic feature dims {spec.shape!r}; "
                "only the leading batch axis may be dynamic for serving")
        specs[spec.name] = (tuple(int(d) for d in feat), np.dtype(spec.dtype))
    return specs


class ReplicaPool:
    """Worker threads dispatching a batcher's batches on Predictor clones."""

    def __init__(self, predictor, batcher, replicas=None):
        n = int(replicas if replicas is not None else flag("serving_replicas"))
        if n <= 0:
            raise InvalidArgumentError(f"serving replica count must be positive, got {n}")
        self.batcher = batcher
        self.replicas = n
        self._preds = [predictor] + [predictor.clone() for _ in range(n - 1)]
        self._specs = predictor_input_specs(predictor)
        # admission checks feature shapes, so a bad request never joins a batch
        batcher.input_specs = dict(self._specs)
        self._threads = []
        self._stop = threading.Event()
        self._live = threading.Event()  # cleared = paused
        self._live.set()
        self.warmed = False
        self._store = store = predictor.store  # the clones share it
        self._watch = CompileWatch(lambda: store.misses)
        self._h_dispatch = histogram("serving/dispatch_ms")

    def _synthetic_feed(self, bucket):
        return {name: np.zeros((bucket,) + feat, dtype=dtype)
                for name, (feat, dtype) in self._specs.items()}

    def warmup(self):
        """Run one zero batch of every bucket on a clone of replica 0 (the
        clones share its graphs), then arm the capture watch: any later
        capture is unexpected. Idempotent."""
        if self.warmed:
            return self
        pred = self._preds[0].clone()
        names = pred.get_input_names()
        for bucket in self.batcher.buckets:
            feed = self._synthetic_feed(bucket)
            pred.run([feed[n] for n in names])
        self._watch.arm()
        self.warmed = True
        return self

    def extra_compiles(self) -> int:
        """Captures since warmup: steady-state serving keeps this 0."""
        return self._watch.extra()

    def captures(self) -> int:
        """Graphs the shared store has captured, warmup included (``/loadz``
        ``jit_misses``)."""
        return self._store.misses

    def unexpected_compiles(self) -> int:
        """Captures after warmup that the workers noted."""
        return self._watch.noted

    def start(self):
        if self._threads:
            return self
        self._stop.clear()
        for i, pred in enumerate(self._preds):
            t = threading.Thread(target=self._worker, args=(i, pred),
                                 name=f"ptt-serving-replica-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _worker(self, idx, pred):
        names = pred.get_input_names()
        batcher = self.batcher
        while True:
            self._live.wait()
            if self._stop.is_set() and not (batcher.closed and batcher.queue_depth()):
                break
            batch = batcher.next_batch(timeout=0.05)
            if batch is None:
                if batcher.closed:
                    break  # closed and drained
                continue
            # one dispatch span for the whole co-batch, current while the
            # executor runs (it tags the span with the cache disposition
            # and the step's FLOPs), then fanned into every member's trace
            dsp = _tracing.begin_span("serving::dispatch", bucket=batch.bucket,
                                      rows=batch.rows, requests=len(batch.requests),
                                      replica=idx)
            try:
                with RecordEvent("serving::dispatch"), _tracing.use_span(dsp):
                    outs = pred.run([batch.feed[n] for n in names])
            except Exception as e:  # noqa: BLE001 — the worker must survive
                dsp.set_error(f"{type(e).__name__}: {e}")
                _tracing.record_fanin(dsp, [r.trace for r in batch.requests])
                batcher.fail(batch, e)
                continue
            dsp.end()
            _tracing.record_fanin(dsp, [r.trace for r in batch.requests])
            self._h_dispatch.observe((time.monotonic() - batch.t_ready) * 1e3)
            if self.warmed:
                self._note_unexpected_compiles(idx, batch.bucket)
            batcher.complete(batch, outs)

    def _note_unexpected_compiles(self, replica_idx, bucket):
        """The bucket ladder's bound broke (a feed escaped the buckets, or
        the program or a weight changed): count it, once however many
        workers see it."""
        self._watch.note(replica=replica_idx, bucket=bucket)

    def pause(self):
        """Stop handing out batches; in-flight dispatches finish and queued
        requests wait, so the bounded queue pushes back."""
        self._live.clear()
        self.batcher.pause()

    def resume(self):
        self.batcher.resume()
        self._live.set()

    @property
    def alive(self) -> int:
        return sum(t.is_alive() for t in self._threads)

    def stop(self, drain=True, timeout=10.0):
        """Stop the workers; ``drain=True`` lets them flush what is queued."""
        self.batcher.close(drain=drain)
        self._stop.set()
        self._live.set()  # a paused pool must still be able to exit
        for t in self._threads:
            t.join(timeout)
        self._threads = [t for t in self._threads if t.is_alive()]
