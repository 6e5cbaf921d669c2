"""Lifetime training goodput/badput ledger (``paddle_tpu/monitor/goodput.py``,
the port's own copy: the same phases, sidecar format and payloads).

The windowed TrainingMonitor answers "how fast is the current window";
nothing answered "over this job's LIFETIME, what fraction of wall-clock
produced committed steps, and where did the rest go?" — the question
every cost comparison starts from. This ledger classifies every
second of training wall time into exclusive phases:

- ``compute``      — productive step time (committed steps, minus any
  instrumented sub-phase that ran inside the step frame)
- ``input_wait``   — blocked on the data pipeline (the DataLoader's
  existing ``record_input_wait_ms`` feed)
- ``compile``      — a graph capture (runtime/compiled.py ``GraphStore.capture``)
- ``checkpoint``   — snapshot capture/serialize/publish on the step path
- ``restore``      — checkpoint restore on (re)start
- ``renegotiate``  — elastic world renegotiation
- ``lost_work``    — restart badput: steps RECOMPUTED after a resume
  because they committed after the manifest the job restarted from
- ``aborted``      — wall time of steps whose body raised
- ``idle``         — the unattributed residual (wall − everything else)

Phases are mutually exclusive and conserve by construction: ``idle`` is
the residual, so the categories sum to measured wall exactly unless a
bug double-counts (surfaced as ``conservation_error > 0``). Work noted
from a thread other than the one owning the live step frame (the async
checkpoint writer publishing under compute) is *background* — reported
separately, excluded from the conservation sum, because overlapped work
costs no wall time.

Restart continuity: the ledger persists a ``GOODPUT.json`` sidecar with
the checkpoint discipline (tmp → fsync → atomic rename, embedded CRC32)
on a step-commit cadence (``FLAGS_goodput_publish_interval_s``) and
after every checkpoint publication. A kill -9 restart loads it and
CONTINUES the lifetime accounting: restored totals land under
``lifetime``, the restored ``max_committed_step`` prices the resume's
recomputation window (``note_resume``), and steps re-committed inside
that window are charged to ``lost_work``, not ``compute``.

Surfaces: ``goodput/seconds_total{phase=…}`` labeled counters (plus
``goodput/wall_seconds_total`` / ``goodput/badput_seconds_total`` for
the optional burn-rate SLO — :func:`install_goodput_slo`), the debug
server's ``/goodputz``, a "goodput
phases" track in ``export_merged_chrome_trace``, and the periodic
``[monitor:goodput]`` line the TrainingMonitor emits alongside its own.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
import zlib

from ..flags import flag
from . import registry as _reg

__all__ = [
    "PHASES",
    "SIDECAR",
    "GoodputLedger",
    "active_ledger",
    "start_ledger",
    "stop_ledger",
    "reset_ledger",
    "maybe_start_from_flags",
    "span",
    "goodputz_payload",
    "install_goodput_slo",
    "chrome_events",
]

# the exclusive foreground phases (idle is the derived residual)
PHASES = ("compute", "input_wait", "compile", "checkpoint", "restore",
          "renegotiate", "lost_work", "aborted")

SIDECAR = "GOODPUT.json"
_FORMAT_VERSION = 1
# synthetic chrome-trace thread id for the phase track (host spans use
# real thread ids; this one must never collide with a live thread name
# row, so it gets its own constant + a thread_name metadata event)
_CHROME_TID = 770077


def _flight():
    from . import flight_recorder

    return flight_recorder


class _Span:
    """Measures one phase interval against the ledger's clock."""

    def __init__(self, ledger, phase):
        self._ledger = ledger
        self._phase = phase
        self._t0 = None

    def __enter__(self):
        self._t0 = self._ledger._clock()
        return self

    def __exit__(self, *exc):
        t1 = self._ledger._clock()
        self._ledger.note_phase(self._phase, t1 - self._t0,
                                t0=self._t0, t1=t1)
        return False


class _NullSpan:
    """Stateless no-op context manager (ledger disabled)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class GoodputLedger:
    """Exclusive-phase wall-time accounting with restart continuity.

    ``dir=None`` keeps the ledger in-memory (unit tests, the bench row);
    ``clock`` is injectable (tests drive a fake clock). All mutators are
    lock-protected: phase notes arrive from the step thread, the async
    checkpoint writer, and the debug-server scrape thread concurrently.
    """

    def __init__(self, dir=None, clock=None, publish_interval_s=None):
        self.dir = str(dir) if dir else None
        self._clock = clock or time.perf_counter
        self._publish_interval_s = publish_interval_s
        self._lock = threading.RLock()
        self.phase_s = {p: 0.0 for p in PHASES}
        self.background_s: dict = {}
        self.steps = 0
        self.lost_steps = 0
        self.resumes = 0
        self.max_committed_step = -1
        self.recompute_until = -1
        self.lost_work_priced_s = 0.0
        self.downtime_s = 0.0
        self.sidecar_loaded = False
        # trailing step times price a resume's lost work before the
        # recomputation has actually been paid for
        self._mean_window = collections.deque(maxlen=32)
        self._restored_mean_step_s = 0.0
        # lifetime totals restored from the sidecar (previous lives)
        self._base_phases = {p: 0.0 for p in PHASES}
        self._base_wall_s = 0.0
        self._base_idle_s = 0.0
        self._base_steps = 0
        self._base_lost_steps = 0
        self._base_resumes = 0
        # live step frame (owner-thread gated)
        self._frame_t0 = None
        self._frame_thread = None
        self._frame_overlap = 0.0
        # bounded phase-interval buffer for the chrome-trace track
        self._intervals: collections.deque = collections.deque(maxlen=4096)
        # prometheus flush watermarks (counters are monotone; idle and
        # badput can transiently shrink while a span is in flight, so
        # flushes clamp at the high-water mark)
        self._flushed: dict = {}
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)
            self._load_sidecar()
        self._t0 = self._clock()
        self._last_publish = self._t0

    # -- step frames --------------------------------------------------------

    def step_begin(self):
        """Open a step frame on the calling thread. Sub-phases noted on
        this thread while the frame is open (compile inside the step,
        input wait, a sync checkpoint) are deducted from the frame's
        compute at commit, keeping the phases exclusive."""
        with self._lock:
            self._frame_t0 = self._clock()
            self._frame_thread = threading.get_ident()
            self._frame_overlap = 0.0

    def step_commit(self, global_step=None):
        """Close the frame as a committed step. ``global_step`` (the
        run's global step index) drives lost-work attribution: a step
        re-committed inside the post-resume recomputation window is
        charged to ``lost_work`` instead of ``compute``."""
        with self._lock:
            if self._frame_t0 is None:
                return
            t1 = self._clock()
            dur = max(0.0, t1 - self._frame_t0)
            overlap = min(self._frame_overlap, dur)
            fg = dur - overlap
            recomputed = (global_step is not None
                          and int(global_step) <= self.recompute_until)
            phase = "lost_work" if recomputed else "compute"
            self.phase_s[phase] += fg
            self._intervals.append((phase, self._frame_t0, t1))
            self.steps += 1
            if recomputed:
                self.lost_steps += 1
            else:
                self._mean_window.append(dur)
            if global_step is not None:
                self.max_committed_step = max(self.max_committed_step,
                                              int(global_step))
            self._frame_t0 = None
            self._frame_thread = None
            self._frame_overlap = 0.0
        self._maybe_publish()

    def step_abort(self):
        """Close the frame as badput: the step body raised, so its wall
        time is ``aborted``, never ``compute``."""
        with self._lock:
            if self._frame_t0 is None:
                return
            t1 = self._clock()
            dur = max(0.0, t1 - self._frame_t0)
            fg = dur - min(self._frame_overlap, dur)
            self.phase_s["aborted"] += fg
            self._intervals.append(("aborted", self._frame_t0, t1))
            self._frame_t0 = None
            self._frame_thread = None
            self._frame_overlap = 0.0

    # -- phase notes --------------------------------------------------------

    def note_phase(self, phase, dur_s, t0=None, t1=None):
        """Account ``dur_s`` seconds of ``phase``. Foreground unless a
        step frame is open on a DIFFERENT thread — then the work ran
        overlapped with compute (the async checkpoint writer) and costs
        no wall time, so it lands in the informational ``background_s``
        side table instead of the conservation sum."""
        if phase not in PHASES:
            raise ValueError(f"unknown goodput phase {phase!r}; "
                             f"one of {PHASES}")
        dur_s = max(0.0, float(dur_s))
        with self._lock:
            frame_open = self._frame_t0 is not None
            me = threading.get_ident()
            if frame_open and me != self._frame_thread:
                self.background_s[phase] = (
                    self.background_s.get(phase, 0.0) + dur_s)
                return
            if frame_open:
                # same thread, inside the step frame: the frame's compute
                # share shrinks by exactly this note at commit
                self._frame_overlap += dur_s
            self.phase_s[phase] += dur_s
            if t0 is not None and t1 is not None and dur_s > 0:
                self._intervals.append((phase, t0, t1))

    def span(self, phase):
        """Context manager timing one foreground/background phase."""
        return _Span(self, phase)

    # -- resume pricing -----------------------------------------------------

    def mean_step_s(self) -> float:
        """Trailing mean committed-step duration (sidecar value until
        this life has committed steps of its own)."""
        with self._lock:
            if self._mean_window:
                return sum(self._mean_window) / len(self._mean_window)
            return self._restored_mean_step_s

    def note_resume(self, manifest_step):
        """Called after a checkpoint restore with the manifest's step:
        every step committed in a previous life AFTER that manifest
        (``max_committed_step`` from the sidecar) must be recomputed, so
        commits up to ``recompute_until`` become ``lost_work``. The
        priced estimate (steps lost × trailing mean step time) is
        recorded immediately so the resume event carries a cost figure
        before the recomputation has actually run."""
        with self._lock:
            manifest_step = int(manifest_step)
            self.resumes += 1
            self.recompute_until = max(self.recompute_until,
                                       self.max_committed_step)
            steps_lost = max(0, self.max_committed_step - manifest_step)
            priced = steps_lost * self.mean_step_s()
            self.lost_work_priced_s += priced
        _flight().record_event(
            "goodput_resume", manifest_step=manifest_step,
            max_committed_step=self.max_committed_step,
            steps_to_recompute=steps_lost,
            priced_lost_work_s=round(priced, 3))

    # -- reporting ----------------------------------------------------------

    def wall_s(self) -> float:
        """This process's measured wall since the ledger started."""
        return max(0.0, self._clock() - self._t0)

    def snapshot(self) -> dict:
        """Phase accounting as plain data: this process + lifetime.
        ``idle`` is the residual, so ``sum(phases) == wall_s`` holds by
        construction; ``conservation_error`` > 0 means a phase was
        double-counted (the contract the smoke asserts ≤ 2%)."""
        with self._lock:
            wall = self.wall_s()
            fg = dict(self.phase_s)
            attributed = sum(fg.values())
            idle = max(0.0, wall - attributed)
            err = max(0.0, attributed - wall) / max(wall, 1e-9)
            life_wall = self._base_wall_s + wall
            life = {p: self._base_phases.get(p, 0.0) + fg[p]
                    for p in PHASES}
            life["idle"] = self._base_idle_s + idle
            life_compute = life["compute"]
            return {
                "enabled": True,
                "dir": self.dir,
                "wall_s": wall,
                "phases": {**fg, "idle": idle},
                "background_s": dict(self.background_s),
                "goodput": fg["compute"] / max(wall, 1e-9),
                "steps": self.steps,
                "lost_steps": self.lost_steps,
                "resumes": self.resumes,
                "max_committed_step": self.max_committed_step,
                "recompute_until": self.recompute_until,
                "mean_step_s": self.mean_step_s(),
                "lost_work_priced_s": self.lost_work_priced_s,
                "downtime_s": self.downtime_s,
                "sidecar_loaded": self.sidecar_loaded,
                "conservation_error": err,
                "lifetime": {
                    "wall_s": life_wall,
                    "phases": life,
                    "goodput": life_compute / max(life_wall, 1e-9),
                    "steps": self._base_steps + self.steps,
                    "lost_steps": self._base_lost_steps + self.lost_steps,
                    "resumes": self._base_resumes + self.resumes,
                },
            }

    def flush_metrics(self):
        """Reflect lifetime totals into the registry: the labeled
        ``goodput/seconds_total{phase=…}`` family plus the wall/badput
        counters the SLO objective reads. Counters are monotone, so each
        phase flushes the positive delta past its high-water mark (idle
        and badput can transiently shrink while a span is in flight)."""
        snap = self.snapshot()
        life = snap["lifetime"]
        fam = _reg.counter(
            "goodput/seconds_total",
            help="lifetime training wall seconds by exclusive phase")
        with self._lock:
            for phase, cur in life["phases"].items():
                prev = self._flushed.get(phase, 0.0)
                if cur > prev:
                    fam.labels(phase=phase).inc(cur - prev)
                    self._flushed[phase] = cur
            pairs = (
                ("__wall__", "goodput/wall_seconds_total",
                 life["wall_s"]),
                ("__badput__", "goodput/badput_seconds_total",
                 life["wall_s"] - life["phases"]["compute"]),
            )
            for key, name, cur in pairs:
                prev = self._flushed.get(key, 0.0)
                if cur > prev:
                    _reg.counter(name).inc(cur - prev)
                    self._flushed[key] = cur
        return snap

    def emit_line(self, log_fn=print):
        """One parseable ``[monitor:goodput]`` line (lifetime values)."""
        from .training_monitor import _fmt_util

        s = self.snapshot()
        life = s["lifetime"]
        ph = life["phases"]
        line = (
            f"[monitor:goodput] wall_s={life['wall_s']:.3f} "
            f"goodput={_fmt_util(life['goodput'])} "
            f"compute_s={ph['compute']:.3f} "
            f"input_wait_s={ph['input_wait']:.3f} "
            f"compile_s={ph['compile']:.3f} "
            f"checkpoint_s={ph['checkpoint']:.3f} "
            f"restore_s={ph['restore']:.3f} "
            f"renegotiate_s={ph['renegotiate']:.3f} "
            f"lost_work_s={ph['lost_work']:.3f} "
            f"aborted_s={ph['aborted']:.3f} "
            f"idle_s={ph['idle']:.3f} "
            f"steps={life['steps']} "
            f"lost_steps={life['lost_steps']} "
            f"resumes={life['resumes']}"
        )
        log_fn(line)
        return line

    def chrome_events(self) -> list:
        """The recorded phase intervals as chrome-trace "X" events on a
        synthetic "goodput phases" track. Interval timestamps share the
        host-span clock family (perf_counter seconds → µs), so the track
        lines up against RecordEvent spans without re-basing."""
        with self._lock:
            intervals = list(self._intervals)
        if not intervals:
            return []
        pid = os.getpid()
        events = [{"name": "thread_name", "ph": "M", "pid": pid,
                   "tid": _CHROME_TID,
                   "args": {"name": "goodput phases"}}]
        for phase, t0, t1 in intervals:
            events.append({
                "name": f"goodput::{phase}", "ph": "X", "pid": pid,
                "tid": _CHROME_TID, "ts": t0 * 1e6,
                "dur": max(t1 - t0, 0.0) * 1e6, "cat": "goodput",
            })
        return events

    # -- sidecar persistence ------------------------------------------------

    def _sidecar_path(self) -> str:
        return os.path.join(self.dir, SIDECAR)

    @staticmethod
    def _body_crc(body) -> int:
        return zlib.crc32(
            json.dumps(body, sort_keys=True).encode("utf-8")) & 0xFFFFFFFF

    def publish(self, force=True):
        """Durably publish lifetime totals: write + fsync a ``.tmp``,
        then one atomic ``os.replace`` — the checkpoint publication
        discipline, so a kill -9 leaves either the old sidecar or the
        new one, never a torn file. The embedded CRC32 catches torn
        WRITES (power loss mid-page) at load time."""
        if not self.dir:
            return None
        snap = self.snapshot()
        life = snap["lifetime"]
        body = {
            "format": _FORMAT_VERSION,
            "wall_s": life["wall_s"],
            "phases": {p: life["phases"][p] for p in PHASES},
            "idle_s": life["phases"]["idle"],
            "steps": life["steps"],
            "lost_steps": life["lost_steps"],
            "resumes": life["resumes"],
            "max_committed_step": self.max_committed_step,
            "mean_step_s": self.mean_step_s(),
            "time": time.time(),
        }
        doc = json.dumps({"crc32": self._body_crc(body), "body": body},
                         sort_keys=True).encode("utf-8")
        final = self._sidecar_path()
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            f.write(doc)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        with self._lock:
            self._last_publish = self._clock()
        return final

    def _maybe_publish(self):
        if not self.dir:
            return
        interval = self._publish_interval_s
        if interval is None:
            try:
                interval = float(flag("goodput_publish_interval_s"))
            except Exception:
                interval = 30.0
        if self._clock() - self._last_publish >= interval:
            try:
                self.publish()
            except OSError as e:  # a full disk must not kill the step
                _flight().record_event(
                    "goodput_publish_failed",
                    error=f"{type(e).__name__}: {e}"[:200])

    def _load_sidecar(self):
        path = self._sidecar_path()
        try:
            with open(path, "rb") as f:
                doc = json.loads(f.read().decode("utf-8"))
            body = doc["body"]
            if int(doc["crc32"]) != self._body_crc(body):
                raise ValueError("crc mismatch")
            phases = body["phases"]
            self._base_wall_s = float(body["wall_s"])
            self._base_phases = {p: float(phases.get(p, 0.0))
                                 for p in PHASES}
            self._base_idle_s = float(body.get("idle_s", 0.0))
            self._base_steps = int(body.get("steps", 0))
            self._base_lost_steps = int(body.get("lost_steps", 0))
            self._base_resumes = int(body.get("resumes", 0))
            self.max_committed_step = int(
                body.get("max_committed_step", -1))
            self._restored_mean_step_s = float(
                body.get("mean_step_s", 0.0))
            self.downtime_s = max(0.0,
                                  time.time() - float(body.get("time", 0)))
            self.sidecar_loaded = True
            _flight().record_event(
                "goodput_sidecar_resumed", path=path,
                lifetime_wall_s=round(self._base_wall_s, 3),
                max_committed_step=self.max_committed_step,
                downtime_s=round(self.downtime_s, 3))
        except FileNotFoundError:
            pass  # first life: fresh accounting
        except Exception as e:
            # corrupt/torn/incompatible sidecar: start fresh, loudly —
            # lifetime continuity is best-effort, never a crash
            _flight().record_event(
                "goodput_sidecar_corrupt", path=path,
                error=f"{type(e).__name__}: {e}"[:200])

    def close(self):
        """Final flush: publish the sidecar and sync the registry."""
        try:
            self.flush_metrics()
        finally:
            if self.dir:
                self.publish()


# ---------------------------------------------------------------------------
# module-level singleton + hook facades
# ---------------------------------------------------------------------------


_LEDGER: list = [None]


def active_ledger() -> GoodputLedger | None:
    """The process-wide ledger (or None when goodput is off)."""
    return _LEDGER[0]


def start_ledger(dir=None, clock=None,
                 publish_interval_s=None) -> GoodputLedger:
    """Start (or return) the process-wide ledger — idempotent, so every
    entrypoint can call it without fighting over the wall clock's t0."""
    led = _LEDGER[0]
    if led is None:
        led = GoodputLedger(dir=dir, clock=clock,
                            publish_interval_s=publish_interval_s)
        _LEDGER[0] = led
    return led


def stop_ledger():
    """Close (final publish + metric flush) and detach the ledger."""
    led = _LEDGER[0]
    _LEDGER[0] = None
    if led is not None:
        led.close()


def reset_ledger():
    """Drop the ledger WITHOUT a final publish (test isolation)."""
    _LEDGER[0] = None


def maybe_start_from_flags() -> GoodputLedger | None:
    """Start the ledger iff ``FLAGS_goodput_dir`` is set (the
    TrainingMonitor calls this, so any monitored run is one env var away
    from lifetime accounting). Returns the active ledger either way."""
    led = _LEDGER[0]
    if led is not None:
        return led
    d = str(flag("goodput_dir") or "").strip()
    if not d:
        return None
    return start_ledger(dir=d)


def span(phase):
    """Zero-cost-when-off phase span for instrumentation sites:
    ``with goodput.span("compile"): ...`` — a shared no-op context
    manager when no ledger is active."""
    led = _LEDGER[0]
    return led.span(phase) if led is not None else _NULL_SPAN


def goodputz_payload() -> dict:
    """The ``/goodputz`` endpoint body (registry flushed as a side
    effect, so a scrape right after shows the same totals)."""
    led = _LEDGER[0]
    if led is None:
        return {"enabled": False,
                "hint": "set FLAGS_goodput_dir to enable the ledger"}
    return led.flush_metrics()


def chrome_events() -> list:
    """Phase-track events for export_merged_chrome_trace ([] when the
    ledger is off)."""
    led = _LEDGER[0]
    return led.chrome_events() if led is not None else []


def install_goodput_slo(target=None, window_s=3600.0):
    """Install the goodput-ratio objective through the burn-rate engine:
    error mode with badput as the bad counter over wall as the total, so
    "goodput >= target" alerts exactly like a serving availability SLO.
    ``target`` defaults to ``FLAGS_goodput_slo_target``; <= 0 installs
    nothing and returns None."""
    if target is None:
        target = float(flag("goodput_slo_target"))
    if not target or float(target) <= 0:
        return None
    from . import slo as _slo

    s = _slo.SLO("goodput", "goodput/badput_seconds_total",
                 error_ratio="goodput/wall_seconds_total",
                 target=float(target), window_s=float(window_s))
    return _slo.install_slo(s)
