"""Step-level training monitor (``paddle_tpu/monitor/training_monitor.py``).

Where did the step's wall time go: compute, input wait, or a capture?

:class:`TrainingMonitor` wraps each step (context manager or
begin/end pair), aggregates a window of steps, and every
``FLAGS_monitor_interval`` steps emits one parseable log line:

    [monitor:train] step=300 step_ms=12.41 examples_per_sec=10312.9
    input_wait_ratio=0.031 plan_cache_hit_rate=1.000
    jit_cache_hit_rate=1.000 compiles=0 hbm_peak_bytes=123456
    mfu=0.1832 hbm_bw_util=0.2170 roofline=compute-bound

Every field also lands in the metrics registry (histograms/gauges), so
the Prometheus dump and the periodic line can never disagree.

A step's wall time is what the caller's ``with`` covers: the monitor adds
no device sync of its own, so a captured step that only enqueues a replay
reads as its host time unless the body reads a result (a training loop
reads the loss as a float). ``mfu``, ``hbm_bw_util`` and ``roofline``
divide the window's executed work (``cost/executed_flops`` and
``cost/executed_bytes``, fed by each replay's :func:`cost_model.note_run`)
by the window's wall time and the card's peaks. ``compiles`` counts the
window's graph captures; ``jit_cache_hit_rate`` is the captured-step
stores' hits over lookups.
"""
from __future__ import annotations

import time
import weakref

from .. import profiler
from ..flags import flag
from . import cost_model as _cost
from . import goodput as _goodput
from . import registry as _reg
from . import tracing as _tracing

__all__ = ["TrainingMonitor", "record_input_wait_ms", "active_monitor"]

# most recently constructed monitor (weak: a dropped monitor must not be
# kept alive by telemetry)
_active = [None]


def active_monitor():
    """The live TrainingMonitor (latest constructed wins), or None."""
    ref = _active[0]
    return ref() if ref is not None else None


def record_input_wait_ms(ms: float):
    """Account time a consumer spent blocked waiting on input (called by
    the DataLoader/prefetcher wait paths); feeds the monitor's
    input-wait ratio and the goodput ledger's ``input_wait`` phase.

    The canonical series is the COUNTER ``io/input_wait_ms_total``
    (monotone accumulation — the prometheus type the add-only semantics
    always were); the same value still mirrors into the legacy gauge
    ``io/input_wait_ms`` because external readers (kernel smoke, fused-
    kernel tests) fetch that name by kind — a same-name kind migration
    would TypeError at every such site."""
    ms = float(ms)
    _reg.counter("io/input_wait_ms_total").inc(ms)
    # deprecated back-compat alias; remove once nothing reads the gauge
    _reg.gauge("io/input_wait_ms").add(ms)
    led = _goodput.active_ledger()
    if led is not None:
        led.note_phase("input_wait", ms / 1e3)


def _cache_rate(hits, misses):
    total = hits + misses
    return hits / total if total else 1.0


def _fmt_util(v: float) -> str:
    """Utilization ratio for the log line: fixed-point in the normal
    range, scientific below it (a CPU smoke's 4e-5 MFU must not print as
    an indistinguishable 0.0000)."""
    return f"{v:.4f}" if (v == 0.0 or v >= 1e-3) else f"{v:.2e}"


class _StepSpan:
    def __init__(self, mon, examples, global_step=None):
        self._mon = mon
        self._examples = examples
        self._global_step = global_step

    def __enter__(self):
        self._mon.step_begin()
        return self._mon

    def __exit__(self, *exc):
        if exc[0] is None:
            self._mon.step_end(examples=self._examples,
                               global_step=self._global_step)
        else:
            # a failed step must not pollute the aggregates OR leave the
            # begun-state armed (a stale _t_begin would let a later bare
            # step_end() "succeed" with a bogus wall time)
            self._mon.step_abort()
        return False


class TrainingMonitor:
    """Aggregate per-step wall time, examples/sec, input-wait ratio,
    executor cache hit rates, compile events, and the HBM watermark.

    Usage::

        mon = monitor.TrainingMonitor("train")
        for batch in loader:
            with mon.step(examples=len(batch)):
                train_step(batch)

    ``interval`` defaults to ``FLAGS_monitor_interval`` read at each
    step-end (so set_flags takes effect mid-run); 0 silences the line
    but aggregation continues.
    """

    def __init__(self, name="train", interval=None, devices=None,
                 log_fn=None):
        self.name = name
        self._interval = interval
        self._devices = devices
        self._log_fn = log_fn or print
        self.step_count = 0
        self.last_line = None
        self._step_ms = _reg.histogram(f"monitor/{name}/step_ms")
        self._examples = _reg.counter(f"monitor/{name}/examples")
        self._steps = _reg.counter(f"monitor/{name}/steps")
        # lifetime goodput ledger: one env var (FLAGS_goodput_dir) turns
        # it on for any monitored run; None when the flag is unset
        _goodput.maybe_start_from_flags()
        # graph captures (registry-fed through the compile-event
        # listener) expose capture storms in the periodic line
        _reg.install_jax_listeners()
        self._t_begin = None
        self._span = None
        self._tscope = None
        self._closed = False
        self._reset_window()
        _active[0] = weakref.ref(self)

    # -- window bookkeeping -------------------------------------------------

    def _counter_basis(self):
        c = profiler.counters()
        return {
            "plan_hit": c.get("executor::plan_cache_hit", 0),
            "plan_miss": c.get("executor::plan_cache_miss", 0),
            "jit_hit": c.get("graph::cache_hit", 0),
            "jit_miss": c.get("graph::cache_miss", 0),
            "compiles": self._compile_events(),
            "input_wait_ms": _reg.counter("io/input_wait_ms_total").value,
            # executed-work ledger (cost_model.note_run): differencing it
            # over the window gives the window's FLOPs/bytes for MFU
            "flops": _reg.counter("cost/executed_flops").value,
            "bytes": _reg.counter("cost/executed_bytes").value,
        }

    @staticmethod
    def _compile_events():
        total = 0
        for name, m in _reg.all_metrics().items():
            if name.startswith("graph/") and "compile" in name \
                    and m.kind == "counter":
                total += m.value
        return total

    def _reset_window(self):
        self._win_t0 = time.perf_counter()
        self._win_steps = 0
        self._win_examples = 0
        self._win_step_ms = 0.0
        self._win_basis = self._counter_basis()

    # -- step API -----------------------------------------------------------

    def step(self, examples=None, global_step=None):
        """Context manager wrapping one training step. ``global_step``
        (the run's global step index, surviving restarts) drives the
        goodput ledger's lost-work attribution on resume."""
        return _StepSpan(self, examples, global_step=global_step)

    def step_begin(self):
        led = _goodput.active_ledger()
        if led is not None:
            led.step_begin()
        self._span = profiler.RecordEvent(
            f"monitor::{self.name}::step").begin()
        # step-scoped trace: everything the step touches (executor runs,
        # flight-recorder events, a NaN or watchdog dump) can cite this
        # trace_id; retention rides the same tail sampler as serving
        # (aborted steps are flagged errored and always kept)
        self._tscope = _tracing.start_trace(
            f"train::{self.name}::step", step=self.step_count + 1)
        self._tscope.__enter__()
        self._t_begin = time.perf_counter()
        return self

    def _trace_end(self, error=None):
        ts, self._tscope = self._tscope, None
        if ts is None:
            return
        if error is not None and ts.span:
            ts.span.set_error(error)
        ts.__exit__(None, None, None)

    def step_abort(self):
        """Discard an in-flight step (the body raised): drop its span,
        disarm the begin-state, and count it separately. The step's wall
        time does NOT vanish — it lands in the goodput ledger's
        ``aborted`` badput, and a flight event names the step, so an
        abort storm is visible in both the lifetime accounting and the
        post-mortem dump."""
        dt_ms = (0.0 if self._t_begin is None
                 else (time.perf_counter() - self._t_begin) * 1e3)
        self._t_begin = None
        if self._span is not None:
            self._span = None  # never end()ed: the span is not recorded
        self._trace_end(error="step aborted")
        _reg.counter(f"monitor/{self.name}/aborted_steps").inc()
        _reg.counter(f"monitor/{self.name}/aborted_step_ms").inc(dt_ms)
        led = _goodput.active_ledger()
        if led is not None:
            led.step_abort()
        from . import flight_recorder as _flight

        _flight.record_event(
            "step_aborted", monitor=self.name,
            step=self.step_count + 1, ms=round(dt_ms, 3))

    def step_end(self, examples=None, global_step=None):
        """Close the step; returns the log line if this step emitted one
        (None otherwise)."""
        if self._t_begin is None:
            raise RuntimeError("step_end() without step_begin()")
        dt_ms = (time.perf_counter() - self._t_begin) * 1e3
        self._t_begin = None
        if self._span is not None:
            self._span.end()
            self._span = None
        self._trace_end()
        led = _goodput.active_ledger()
        if led is not None:
            # global_step stays None when the caller doesn't thread one:
            # lost-work attribution needs a restart-surviving index, and
            # guessing from the per-life step_count would misfile fresh
            # post-resume steps as recomputation
            led.step_commit(global_step=global_step)
        self.step_count += 1
        self._steps.inc()
        self._step_ms.observe(dt_ms)
        self._win_steps += 1
        self._win_step_ms += dt_ms
        if examples:
            self._examples.inc(int(examples))
            self._win_examples += int(examples)
        interval = (self._interval if self._interval is not None
                    else flag("monitor_interval"))
        if interval and self.step_count % interval == 0:
            return self._emit()
        return None

    # -- reporting ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Current-window aggregates as plain data (the line's fields)."""
        now = time.perf_counter()
        wall_s = max(now - self._win_t0, 1e-9)
        basis = self._win_basis
        cur = self._counter_basis()
        input_wait_ms = cur["input_wait_ms"] - basis["input_wait_ms"]
        steps = self._win_steps
        flops_d = cur["flops"] - basis["flops"]
        bytes_d = cur["bytes"] - basis["bytes"]
        peaks = _cost.device_peaks()
        return {
            "step": self.step_count,
            "step_ms": (self._win_step_ms / steps) if steps else 0.0,
            "steps_per_sec": steps / wall_s,
            "examples_per_sec": self._win_examples / wall_s,
            "input_wait_ratio": min(input_wait_ms / (wall_s * 1e3), 1.0),
            "plan_cache_hit_rate": _cache_rate(
                cur["plan_hit"] - basis["plan_hit"],
                cur["plan_miss"] - basis["plan_miss"]),
            "jit_cache_hit_rate": _cache_rate(
                cur["jit_hit"] - basis["jit_hit"],
                cur["jit_miss"] - basis["jit_miss"]),
            "compiles": cur["compiles"] - basis["compiles"],
            "hbm_peak_bytes": _reg.hbm_watermark_bytes(self._devices),
            # hardware-utilization accounting (cost_model): window FLOPs/
            # bytes over wall time, normalized by the chip's peaks — 0.0
            # until a compile was cost-captured (nothing to claim yet)
            "mfu": _cost.mfu(flops_d / wall_s, peaks),
            "hbm_bw_util": _cost.hbm_bw_util(bytes_d / wall_s, peaks),
            "roofline": _cost.roofline_class(flops_d, bytes_d, peaks),
        }

    def _emit(self):
        s = self.snapshot()
        _reg.gauge(f"monitor/{self.name}/examples_per_sec").set(
            s["examples_per_sec"])
        _reg.gauge(f"monitor/{self.name}/input_wait_ratio").set(
            s["input_wait_ratio"])
        _reg.gauge(f"monitor/{self.name}/mfu").set(s["mfu"])
        _reg.gauge(f"monitor/{self.name}/hbm_bw_util").set(
            s["hbm_bw_util"])
        line = (
            f"[monitor:{self.name}] step={s['step']} "
            f"step_ms={s['step_ms']:.2f} "
            f"examples_per_sec={s['examples_per_sec']:.1f} "
            f"input_wait_ratio={s['input_wait_ratio']:.3f} "
            f"plan_cache_hit_rate={s['plan_cache_hit_rate']:.3f} "
            f"jit_cache_hit_rate={s['jit_cache_hit_rate']:.3f} "
            f"compiles={s['compiles']} "
            f"hbm_peak_bytes={s['hbm_peak_bytes']} "
            f"mfu={_fmt_util(s['mfu'])} "
            f"hbm_bw_util={_fmt_util(s['hbm_bw_util'])} "
            f"roofline={s['roofline']}"
        )
        self.last_line = line
        self._log_fn(line)
        # the lifetime ledger reports on the same cadence: one window
        # line (rates) + one goodput line (where the wall time went)
        led = _goodput.active_ledger()
        if led is not None:
            led.flush_metrics()
            led.emit_line(self._log_fn)
        self._reset_window()
        return line

    def close(self):
        """Flush a final partial-window line and detach (idempotent).

        A run shorter than ``FLAGS_monitor_interval`` never reaches an
        emit boundary — without this flush it would end silently, which
        for a smoke run is exactly when the line matters most. Interval 0
        still means silent (the documented off switch); an in-flight step
        (close inside an exception unwind) is aborted, not counted.
        Returns the emitted line (None when nothing was flushed)."""
        if self._closed:
            return None
        self._closed = True
        # detach: a closed monitor must stop feeding cluster snapshots
        # (a later evaluate()'s executed work would silently accrue to
        # this dead window otherwise)
        ref = _active[0]
        if ref is not None and ref() is self:
            _active[0] = None
        if self._t_begin is not None:
            self.step_abort()
        interval = (self._interval if self._interval is not None
                    else flag("monitor_interval"))
        line = self._emit() if (self._win_steps and interval) else None
        # final ledger sync even when no window line flushed: the last
        # partial window's seconds must not be lost on a short run
        led = _goodput.active_ledger()
        if led is not None:
            led.close()
        return line
