"""Fault injection for chaos testing (``FLAGS_fault_injection``; ``paddle_tpu/distributed/chaos.py``).

Preemption tolerance is only real if every recovery path has been
exercised by a real process death. Well-known code points call
:func:`inject` and, when the flag
carries a matching directive, the process is killed (``kill`` = SIGKILL
to self, the genuine ``kill -9``), exits hard (``exit`` = os._exit, no
atexit/teardown), sleeps (``delay`` — straggler emulation), or raises
:class:`ChaosInjected` (``raise`` — in-process failure without dying).

Directive grammar (';'-separated, each ``action:key=val,key=val``):

    kill:point=step,step=3          SIGKILL self at train step 3
    kill:point=step,step=3,rank=1   ... only on rank 1
    delay:point=step,step=2,ms=250  sleep 250ms before step 2
    kill:point=mid_save,n=2         die inside the 2nd checkpoint save
    raise:point=mid_save,n=1        fail the 1st save, keep the process

Points are where the runtime calls ``inject``: ``step`` (train-step
boundary — hapi.Model.fit) and ``mid_save``
(inside the checkpoint writer, after data files are written but before
the manifest publish — the torn-snapshot window crash-consistent
rotation must survive). Each directive fires at most once per process.
The empty flag (default) short-circuits to a single flag read.
"""
from __future__ import annotations

import os
import signal
import time

from ..flags import flag

__all__ = ["ChaosInjected", "inject", "parse", "reset"]

_ACTIONS = ("kill", "exit", "delay", "raise")
_POINTS = ("step", "mid_save")


class ChaosInjected(RuntimeError):
    """Raised by a ``raise`` directive — a survivable injected failure."""


# (raw flag value, parsed directives) + per-process fire bookkeeping
_PARSED: tuple = ("", [])
_FIRED: set = set()
_OCCURRENCES: dict = {}


def parse(spec: str):
    """Parse a directive string; raises InvalidArgumentError on garbage
    (a chaos run with a typo'd spec must fail loudly, not test nothing)."""
    from ..errors import InvalidArgumentError

    out = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        action, _, kvs = part.partition(":")
        action = action.strip()
        if action not in _ACTIONS:
            raise InvalidArgumentError(
                f"fault_injection: unknown action {action!r} in {part!r} "
                f"(known: {_ACTIONS})")
        d = {"action": action}
        for kv in kvs.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, sep, v = kv.partition("=")
            if not sep:
                raise InvalidArgumentError(
                    f"fault_injection: expected key=value, got {kv!r}")
            d[k.strip()] = v.strip()
        if d.get("point") not in _POINTS:
            raise InvalidArgumentError(
                f"fault_injection: directive {part!r} needs point="
                f"{'|'.join(_POINTS)}")
        for k in ("step", "rank", "n", "code"):
            if k in d:
                try:
                    d[k] = int(d[k])
                except ValueError:
                    raise InvalidArgumentError(
                        f"fault_injection: {k}={d[k]!r} is not an int")
        if "ms" in d:
            try:
                d["ms"] = float(d["ms"])
            except ValueError:
                raise InvalidArgumentError(
                    f"fault_injection: ms={d['ms']!r} is not a number")
        out.append(d)
    return out


def reset():
    """Forget fired/occurrence state (tests)."""
    global _PARSED
    _PARSED = ("", [])
    _FIRED.clear()
    _OCCURRENCES.clear()


def inject(point: str, step=None, rank=None):
    """Fire any matching directive at this code point.

    ``step`` is the caller's step counter (matched against ``step=N``
    directives); ``n`` directives match the Nth time this *point* is
    reached in this process. ``rank`` defaults to the process's
    distributed rank.
    """
    raw = flag("fault_injection")
    if not raw:
        return
    global _PARSED
    if _PARSED[0] != raw:
        _PARSED = (raw, parse(raw))
        _FIRED.clear()
        _OCCURRENCES.clear()
    n = _OCCURRENCES[point] = _OCCURRENCES.get(point, 0) + 1
    for i, d in enumerate(_PARSED[1]):
        if d["point"] != point or i in _FIRED:
            continue
        if "rank" in d and d["rank"] != _current_rank(rank):
            continue
        if "step" in d and (step is None or d["step"] != int(step)):
            continue
        if "n" in d and d["n"] != n:
            continue
        _FIRED.add(i)
        _fire(d, point, step)


def _current_rank(rank):
    if rank is not None:
        return int(rank)
    from ..monitor import flight_recorder as _flight

    return _flight._safe_rank()


def _fire(d, point, step):
    action = d["action"]
    try:
        from ..monitor import flight_recorder as _flight
        from ..monitor import registry as _reg

        _flight.record_event("fault_injected", action=action, point=point,
                             step=-1 if step is None else int(step))
        _reg.counter(f"chaos/{action}").inc()
    except Exception:
        pass  # chaos must fire even if telemetry is half-torn-down
    if action == "delay":
        time.sleep(float(d.get("ms", 100.0)) / 1000.0)
    elif action == "raise":
        raise ChaosInjected(
            f"fault_injection: injected failure at {point} (step={step})")
    elif action == "exit":
        os._exit(int(d.get("code", 17)))
    elif action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
