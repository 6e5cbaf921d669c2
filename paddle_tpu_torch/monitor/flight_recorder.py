"""Flight recorder: post-mortem and live fault diagnosis (``paddle_tpu/monitor/flight_recorder.py``).

The black box the port's runtime reports into, with the JAX package's
event layout and dump format (``tools/debug_dump.py`` reads either):

- :class:`FlightRecorder` — a fixed-capacity ring buffer of structured
  events: executor runs (program id, cache disposition), the IR gates'
  verdicts (``program_verify``, ``memory_budget``, ``plan_accuracy``),
  graph captures and their refusals, the router's backend changes, flag
  changes, NaN verdicts. Dumped to JSON on an unhandled exception, on
  ``SIGUSR1`` and on a watchdog trip.
- :class:`HangWatchdog` — a daemon thread behind
  ``FLAGS_watchdog_timeout_s`` that fires when no step completes within
  the deadline (the progress clock is fed at step boundaries, never by a
  device sync), dumping the recorder and every Python thread's stack.
- **Collective desync detection** — per-group (seq, fingerprint) tails
  and :func:`first_divergence` over them. The exchange across ranks
  needs a side channel; the port's multi-process runtime does not exist
  yet, so :func:`exchange_and_diagnose` returns None unless the caller
  hands it a channel (``set(key, value)``, ``get(key, timeout_s)``), as
  the JAX package does in a world of one.

Recording rides hot paths always-on (``FLAGS_flight_recorder``): one flag
read, one dict build and one short lock hold an event.
"""
from __future__ import annotations

import collections
import json
import os
import signal
import sys
import tempfile
import threading
import time
import traceback

from ..flags import flag
from . import tracing as _tracing

__all__ = [
    "FlightRecorder", "HangWatchdog",
    "get_recorder", "record_event", "record_collective", "events",
    "reset_recorder", "dump_now", "default_dump_path",
    "notify_progress", "last_progress_age_s",
    "first_divergence", "exchange_and_diagnose",
    "install", "install_from_flags",
    "start_watchdog", "stop_watchdog", "watchdog",
    "thread_stacks",
]

# per-group collective tail length kept for desync diagnosis — long
# enough to reach back past a divergence that happened many calls before
# anyone hung, bounded so a week-long run holds kilobytes, not gigabytes
_TAIL_LEN = 256

_t0_monotonic = time.monotonic()


def _safe_rank() -> int:
    """Process rank from the environment alone (the recorder must work
    inside crash handlers, where initializing a device is off the
    table)."""
    try:
        return int(os.getenv("PADDLE_TRAINER_ID", os.getenv("RANK", "0")))
    except ValueError:
        return 0


def _safe_world() -> int:
    try:
        return int(os.getenv("PADDLE_TRAINERS_NUM",
                             os.getenv("WORLD_SIZE", "1")))
    except ValueError:
        return 1


def _safe_flags() -> dict:
    try:
        from ..flags import globals_view

        return {k: v for k, v in globals_view().items()}
    except Exception:
        return {}


def thread_stacks() -> dict:
    """Every Python thread's current stack (faulthandler-style, but
    structured): ``{"<name>-<tid>": [frame lines...]}``."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        key = f"{names.get(tid, 'unknown')}-{tid}"
        out[key] = [line.rstrip("\n")
                    for line in traceback.format_stack(frame)]
    return out


class FlightRecorder:
    """Fixed-capacity ring buffer of structured runtime events.

    One lock, held only for the deque append / seq bump — recording is a
    hot-path citizen, reading (snapshot/dump) pays the copies. Events are
    plain dicts with ``i`` (global index — monotonic, so ``dropped`` in a
    snapshot says exactly how much history the ring evicted), ``t``
    (epoch seconds) and ``kind``.
    """

    def __init__(self, capacity=None):
        if capacity is None:
            try:
                capacity = int(flag("flight_recorder_capacity"))
            except Exception:
                capacity = 4096
        self._capacity = max(1, int(capacity))
        self._buf = collections.deque(maxlen=self._capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._coll_seq = {}   # group -> next per-group collective seq
        self._tails = {}      # group -> deque[(seq, fingerprint)]

    @property
    def enabled(self) -> bool:
        try:
            return bool(flag("flight_recorder"))
        except Exception:
            return True

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def total_recorded(self) -> int:
        """Monotonic count of events ever recorded (ring eviction does
        not decrement it — matches the dump's ``events_recorded``)."""
        with self._lock:
            return self._seq

    # -- recording -----------------------------------------------------------

    def record(self, kind, **fields):
        """Append one structured event; no-op (None) when disabled.

        Events recorded inside an active trace cite its ``trace_id`` —
        a flight-recorder post-mortem (NaN dump, watchdog trip) can
        name the exact request/step whose trace to pull from
        ``/tracez``, and a trace can be grepped out of a dump."""
        if not self.enabled:
            return None
        ev = {"i": 0, "t": time.time(), "kind": kind}
        ctx = _tracing.current_context()
        if ctx is not None:
            ev["trace_id"] = ctx.trace_id
        ev.update(fields)
        with self._lock:
            ev["i"] = self._seq
            self._seq += 1
            self._buf.append(ev)
        return ev

    def record_collective(self, primitive, group, shape=None, dtype=None,
                          reduce_op=None, traced=False, nbytes=0,
                          sequenced=True):
        """Record one collective call: assigns the group's next monotonic
        sequence number and a ``primitive|shape|dtype|reduce_op``
        fingerprint, and appends both to the group's desync tail.
        Returns the seq (None when disabled).

        Trace-time calls (``traced=True``) and rank-local utilities
        (``sequenced=False`` — e.g. ``wait``, which any single rank may
        legally call alone) land in the event ring but do NOT consume a
        seq or touch the tails: one trace stands for N executions,
        retraces are rank-asymmetric (one rank's jit-cache miss is
        another's hit), and a lone rank timing a step must not read as
        desync. The cross-rank comparison is over *issued* logically-
        collective eager calls only.
        """
        if not self.enabled:
            return None
        shape_s = tuple(int(d) for d in shape) if shape is not None else ()
        fp = f"{primitive}|{shape_s}|{dtype or ''}|{reduce_op or ''}"
        if traced or not sequenced:
            self.record("collective", primitive=primitive, group=group,
                        seq=None, fingerprint=fp, traced=bool(traced),
                        nbytes=int(nbytes))
            return None
        with self._lock:
            seq = self._coll_seq.get(group, 0)
            self._coll_seq[group] = seq + 1
            tail = self._tails.get(group)
            if tail is None:
                tail = self._tails[group] = collections.deque(
                    maxlen=_TAIL_LEN)
            tail.append((seq, fp))
        self.record("collective", primitive=primitive, group=group,
                    seq=seq, fingerprint=fp, traced=False,
                    nbytes=int(nbytes))
        return seq

    # -- reading -------------------------------------------------------------

    def events(self) -> list:
        with self._lock:
            return list(self._buf)

    def collective_tails(self) -> dict:
        """Per-group desync tails: ``{group: [(seq, fingerprint), ...]}``."""
        with self._lock:
            return {g: list(t) for g, t in self._tails.items()}

    def reset(self):
        with self._lock:
            self._buf.clear()
            self._seq = 0
            self._coll_seq.clear()
            self._tails.clear()

    def snapshot(self, reason="snapshot", desync=None) -> dict:
        """The full dump payload as plain data (what every dump trigger
        and the /flightrecorder endpoint serve)."""
        evs = self.events()
        with self._lock:
            total = self._seq
        snap = {
            "reason": reason,
            "time": time.time(),
            "pid": os.getpid(),
            "rank": _safe_rank(),
            "world": _safe_world(),
            "uptime_s": round(time.monotonic() - _t0_monotonic, 3),
            "capacity": self._capacity,
            "events_recorded": total,
            "dropped": max(0, total - len(evs)),
            "events": evs,
            "collective_tails": self.collective_tails(),
            "threads": thread_stacks(),
            "flags": _safe_flags(),
        }
        if desync is not None:
            snap["desync"] = desync
        return snap

    def dump(self, path=None, reason="dump", desync=None) -> str:
        """Write the snapshot as JSON (atomically: tmp + rename, so a
        crash mid-dump never leaves a half-written file that a post-
        mortem tool chokes on). Returns the path."""
        snap = self.snapshot(reason=reason, desync=desync)
        if path is None:
            path = default_dump_path(reason)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=1, default=str)
        os.replace(tmp, path)
        sys.stderr.write(
            f"[flight_recorder] rank {snap['rank']}: dumped "
            f"{len(snap['events'])} events -> {path} (reason: {reason})\n")
        return path


_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _RECORDER


def record_event(kind, **fields):
    return _RECORDER.record(kind, **fields)


def record_collective(primitive, group, **kwargs):
    return _RECORDER.record_collective(primitive, group, **kwargs)


def events() -> list:
    return _RECORDER.events()


def reset_recorder():
    _RECORDER.reset()


def default_dump_path(reason="dump") -> str:
    """``<FLAGS_flight_recorder_dump_dir or tempdir>/paddle_tpu_flight_
    rank<r>_pid<pid>_<reason-slug>.json`` — rank+pid keyed so every
    process of a fleet world dumps without clobbering peers on a shared
    filesystem, and reason-slug keyed so distinct triggers never
    clobber each other (a barrier-failure dump carrying the desync
    report must survive the excepthook dump the re-raised error writes
    moments later). Same-reason re-dumps (a watchdog re-tripping)
    overwrite in place: latest evidence wins, disk use stays bounded."""
    try:
        d = flag("flight_recorder_dump_dir")
    except Exception:
        d = ""
    d = d or tempfile.gettempdir()
    slug = "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(reason))[:48] or "dump"
    return os.path.join(
        d, f"paddle_tpu_flight_rank{_safe_rank()}_pid{os.getpid()}"
           f"_{slug}.json")


def dump_now(reason="request", path=None, desync=None) -> str:
    """Dump the global recorder immediately (the SIGUSR1 handler's body,
    also the programmatic trigger)."""
    return _RECORDER.dump(path=path, reason=reason, desync=desync)


def nan_event_action(where, detail):
    """Shared ``FLAGS_check_nan_inf_action`` policy for every NaN/Inf
    detection site (the executor's post-run scan, the checkify train
    step): validates the flag value, bumps ``debug/nan_events``, records
    the ``nan_inf`` flight event, and performs the non-raising half.

    Returns None when ``action=warn`` consumed the event (the caller
    continues), else the action — the caller must then raise its
    domain-specific error (for ``"dump"`` the snapshot has already been
    written)."""
    from ..flags import flag as _flag

    action = _flag("check_nan_inf_action")
    if action not in ("raise", "warn", "dump"):
        from ..errors import InvalidArgumentError

        raise InvalidArgumentError(
            f"FLAGS_check_nan_inf_action must be raise|warn|dump, "
            f"got {action!r}")
    from . import registry as _registry

    _registry.counter("debug/nan_events").inc()
    record_event("nan_inf", where=str(where), action=action,
                 detail=str(detail)[:300])
    if action == "warn":
        import warnings

        warnings.warn(
            f"check_nan_inf: {detail} (action=warn: continuing; "
            f"debug/nan_events counter bumped)",
            RuntimeWarning, stacklevel=3)
        return None
    if action == "dump":
        dump_now(reason=f"check_nan_inf:{where}")
    return action


# -- progress clock / hang watchdog ------------------------------------------

# [monotonic time of last completed unit of work, what it was]; written
# by the executor (run end), collectives (eager completion), and the PS
# client (reply received) — two plain stores + one clock read, cheap
# enough to ride every completion unconditionally
_last_progress = [time.monotonic(), "startup"]


def notify_progress(what="step"):
    """Feed the watchdog: some unit of forward progress just completed."""
    _last_progress[0] = time.monotonic()
    _last_progress[1] = what


def last_progress_age_s() -> float:
    return time.monotonic() - _last_progress[0]


def last_progress_what() -> str:
    return _last_progress[1]


class HangWatchdog:
    """Daemon thread that trips when the progress clock goes stale.

    On trip: records a ``watchdog_trip`` event, runs the desync exchange
    (if a multi-process side channel exists), and dumps the recorder —
    thread stacks included, so the dump shows *where* every thread is
    parked, not just that nothing moved. The progress clock is re-armed
    after a trip, so a still-hung process re-dumps once per timeout
    period instead of once per poll.
    """

    def __init__(self, timeout_s, recorder=None, poll_interval=None,
                 desync=True, on_trip=None):
        self.timeout_s = float(timeout_s)
        if self.timeout_s <= 0:
            raise ValueError("watchdog timeout must be > 0 (0 disables the "
                             "watchdog — don't construct one)")
        self._recorder = recorder or _RECORDER
        self._poll = (float(poll_interval) if poll_interval
                      else max(0.05, min(self.timeout_s / 4.0, 5.0)))
        self._desync = desync
        self._on_trip = on_trip
        self._stop = threading.Event()
        self._thread = None
        self.trips = 0
        self.last_dump = None

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        if self.alive:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="ptpu-hang-watchdog", daemon=True)
        self._thread.start()
        self._recorder.record("watchdog_start", timeout_s=self.timeout_s)
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self._poll * 4 + 1.0)
        self._thread = None

    def _run(self):
        while not self._stop.wait(self._poll):
            age = last_progress_age_s()
            if age < self.timeout_s:
                continue
            try:
                self._trip(age)
            except Exception as e:  # the watchdog must never kill the run
                sys.stderr.write(f"[flight_recorder] watchdog trip handler "
                                 f"failed: {type(e).__name__}: {e}\n")
            notify_progress("watchdog_rearm")

    def _trip(self, age):
        self.trips += 1
        self._recorder.record(
            "watchdog_trip", age_s=round(age, 3),
            timeout_s=self.timeout_s, trips=self.trips,
            last_progress=last_progress_what())
        desync = None
        if self._desync:
            try:
                # STABLE tag: trip counts are rank-local (a transient
                # first-compile trip on one rank would desynchronize
                # per-trip tags forever, stranding later exchanges on
                # mismatched keys). Every rank always publishes/reads
                # "watchdog"; set() overwrites, so a get returns the
                # peer's latest published tail — possibly from an
                # earlier trip, which for a hung peer is exactly the
                # freshest evidence that exists.
                desync = exchange_and_diagnose(
                    tag="watchdog", recorder=self._recorder)
            except Exception as e:
                desync = {"error": f"{type(e).__name__}: {e}"}
        # stable path (reason varies by age digits): a re-tripping
        # watchdog overwrites its own dump — latest evidence, bounded disk
        self.last_dump = self._recorder.dump(
            path=default_dump_path("watchdog_timeout"),
            reason=f"watchdog_timeout({age:.1f}s > {self.timeout_s:g}s, "
                   f"last progress: {last_progress_what()})",
            desync=desync)
        if self._on_trip is not None:
            self._on_trip(self)


_watchdog = [None]


def watchdog() -> HangWatchdog | None:
    return _watchdog[0]


def start_watchdog(timeout_s=None) -> HangWatchdog | None:
    """Start the global watchdog (idempotent). ``timeout_s`` defaults to
    ``FLAGS_watchdog_timeout_s``; <=0 leaves it off and returns None."""
    if timeout_s is None:
        timeout_s = flag("watchdog_timeout_s")
    if not timeout_s or float(timeout_s) <= 0:
        return None
    wd = _watchdog[0]
    if wd is not None and wd.alive:
        return wd
    notify_progress("watchdog_armed")
    wd = HangWatchdog(float(timeout_s))
    wd.start()
    _watchdog[0] = wd
    return wd


def stop_watchdog():
    wd = _watchdog[0]
    if wd is not None:
        wd.stop()
    _watchdog[0] = None


# -- collective desync detection ---------------------------------------------


def first_divergence(tails_by_rank) -> list:
    """Name the first diverging collective call per group.

    ``tails_by_rank``: ``{rank: {group: [(seq, fingerprint), ...]}}`` —
    each rank's per-group tail as exchanged over the side channel.
    Returns one dict per diverging group::

        {"group": "dp", "seq": 41,
         "fingerprints": {"0": "all_reduce|(1024,)|float32|sum",
                          "1": "all_gather|(1024,)|float32|"},
         "summary": "group 'dp' diverges at seq 41: ..."}

    Comparison happens inside the seq window every rank can still see
    (tails are bounded rings) — a seq evicted on one rank is not
    evidence. A missing fingerprint inside the window (``None``) means
    that rank never issued the call: the skipped-collective case. When
    the common window is fingerprint-identical but ranks stopped at
    different seqs, the first seq past the shortest rank is reported as
    a call-count mismatch (the classic "one rank left the loop early").
    """
    ranks = sorted(tails_by_rank)
    groups = sorted({g for tails in tails_by_rank.values() for g in tails})
    out = []
    for g in groups:
        per = {r: {int(s): f for s, f in tails_by_rank[r].get(g, [])}
               for r in ranks}
        starts = [min(m) for m in per.values() if m]
        ends = [max(m) for m in per.values() if m]
        lo = max(starts) if starts else 0
        hi = max(ends) if ends else -1
        shortest = min(ends) if len(ends) == len(ranks) else -1
        div = None
        for s in range(lo, hi + 1):
            fps = {r: per[r].get(s) for r in ranks}
            if len(set(fps.values())) > 1:
                div = {"group": g, "seq": s,
                       "fingerprints": {str(r): fps[r] for r in ranks}}
                if 0 <= shortest < s:
                    div["note"] = ("call-count mismatch: some ranks "
                                   "stopped issuing collectives earlier")
                break
        if div is not None:
            parts = ", ".join(
                f"rank{r}={div['fingerprints'][str(r)] or 'MISSING'}"
                for r in ranks)
            div["summary"] = (
                f"group {g!r} diverges at seq {div['seq']}: {parts}")
            out.append(div)
    return out


def _default_channel():
    """The side channel of a multi-process world: none in the port yet
    (its multi-process runtime is still to come)."""
    return None


def exchange_and_diagnose(tag="trip", timeout_s=15.0, channel=None,
                          rank=None, world=None, recorder=None):
    """Exchange collective tails across ranks and diagnose the first
    divergence (c10d-flight-recorder style).

    Publishes this rank's per-group (seq, fingerprint) tail under
    ``ptpu/flight/<tag>/<rank>`` and collects every peer's, then runs
    :func:`first_divergence`. Returns the report dict, or None when
    there is nothing to exchange (single-process world, or no side
    channel — the eager path must stay harmless). Peers that never
    publish within ``timeout_s`` (crashed before their own trip) are
    listed in ``missing_ranks`` rather than failing the diagnosis —
    a dead peer is itself evidence.

    Every rank that trips calls this with the same ``tag`` (the stable
    ``"watchdog"`` tag, a barrier token), so the keyspace lines up
    without extra coordination; publishes overwrite, so a reused tag
    reads each peer's latest published tail.
    """
    recorder = recorder or _RECORDER
    if rank is None:
        rank = _safe_rank()
    if world is None:
        world = _safe_world()
    if world <= 1:
        return None
    channel = channel or _default_channel()
    if channel is None:
        return None
    tails = recorder.collective_tails()
    payload = json.dumps(
        {g: [[s, f] for s, f in t] for g, t in tails.items()})
    try:
        channel.set(f"ptpu/flight/{tag}/{rank}", payload)
    except Exception as e:
        # best-effort: peers may still have published THEIR tails — a
        # one-sided diagnosis beats none
        recorder.record("desync_publish_failed", tag=str(tag),
                        error=f"{type(e).__name__}: {e}"[:200])
    by_rank = {}
    # ONE shared deadline across all peers: a hung fleet must not pay
    # timeout_s per missing rank (world * timeout_s could hold the
    # watchdog's dump hostage for minutes)
    deadline = time.monotonic() + float(timeout_s)

    def _try_get(r, budget_s):
        try:
            raw = channel.get(f"ptpu/flight/{tag}/{r}",
                              max(budget_s, 0.001))
            if isinstance(raw, bytes):
                raw = raw.decode("utf-8")
            by_rank[r] = {g: [(int(s), f) for s, f in t]
                          for g, t in json.loads(raw).items()}
            return True
        except Exception:
            return False

    # two passes: a quick short-slice sweep first, so one dead LOW rank
    # cannot starve reads of higher ranks whose tails are already
    # published (the dead rank is exactly when cross-rank evidence
    # matters most); whatever deadline remains is then split across the
    # stragglers
    stragglers = [r for r in range(world)
                  if not _try_get(r, min(0.25,
                                         deadline - time.monotonic()))]
    for i, r in enumerate(stragglers):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        _try_get(r, remaining / (len(stragglers) - i))
    missing = sorted(set(range(world)) - set(by_rank))
    divergences = first_divergence(by_rank)
    report = {
        "tag": str(tag),
        "rank": rank,
        "world": world,
        "missing_ranks": missing,
        "divergences": divergences,
        "tails_by_rank": {str(r): {g: [[s, f] for s, f in t]
                                   for g, t in tails.items()}
                          for r, tails in by_rank.items()},
    }
    recorder.record("desync_report", tag=str(tag),
                    divergences=len(divergences),
                    missing_ranks=missing)
    for d in divergences:
        sys.stderr.write(f"[flight_recorder] rank {rank}: DESYNC "
                         f"{d['summary']}\n")
    return report


# -- crash / signal installation ---------------------------------------------

_installed = {"excepthook": False, "signal": False}


def install(excepthook=True, sig=True):
    """Install the dump triggers that need process-global hooks:

    - unhandled exception: chain onto ``sys.excepthook`` — the dump is
      written *before* the traceback prints, so a crash leaves evidence
      even if stderr is lost;
    - ``SIGUSR1``: faulthandler-style on-demand dump of a live process
      (``kill -USR1 <pid>``) — main-thread only (signal module rule).

    Idempotent; both hooks preserve and call whatever was installed
    before them.
    """
    if excepthook and not _installed["excepthook"]:
        prev_hook = sys.excepthook

        def _dump_excepthook(etype, value, tb):
            try:
                _RECORDER.record("unhandled_exception",
                                 type=etype.__name__,
                                 message=str(value)[:500])
                _RECORDER.dump(reason=f"unhandled_exception:{etype.__name__}")
            except Exception:
                pass
            prev_hook(etype, value, tb)

        sys.excepthook = _dump_excepthook
        _installed["excepthook"] = True

    if (sig and not _installed["signal"] and hasattr(signal, "SIGUSR1")
            and threading.current_thread() is threading.main_thread()):
        prev_handler = signal.getsignal(signal.SIGUSR1)

        def _on_sigusr1(signum, frame):
            try:
                dump_now(reason="SIGUSR1")
            except Exception:
                pass
            if callable(prev_handler):
                prev_handler(signum, frame)

        try:
            signal.signal(signal.SIGUSR1, _on_sigusr1)
            _installed["signal"] = True
        except (ValueError, OSError):
            pass
    return _installed


def install_from_flags():
    """One-call wiring of everything the FLAGS ask for — crash/SIGUSR1
    dumps always, the hang watchdog when ``FLAGS_watchdog_timeout_s``>0,
    and the debug server when ``FLAGS_debug_port``>0 (bound at
    port+rank so a multi-process host serves every rank). Safe to call
    repeatedly."""
    install()
    wd = start_watchdog()
    server = None
    try:
        port = int(flag("debug_port"))
    except Exception:
        port = 0
    if port > 0:
        from .debug_server import start_debug_server

        try:
            server = start_debug_server(port + _safe_rank())
        except OSError as e:
            sys.stderr.write(
                f"[flight_recorder] debug server bind failed on port "
                f"{port + _safe_rank()}: {e}\n")
            _RECORDER.record("debug_server_bind_failed",
                             port=port + _safe_rank(), error=str(e))
    return wd, server
