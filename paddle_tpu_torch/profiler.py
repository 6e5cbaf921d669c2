"""Named monotonic counters (``paddle_tpu/profiler/__init__.py:61-75``), the port's own copy.

The program-IR analysis books its cache hits and misses here
(``memplan::cache_hit``, ``ir_opt::cache_miss``, ...) and the optimizer its
per-pass ``ir_opt::<pass>::ops_rewritten``. The JAX profiler's host event
ranges and trace export wait for ROADMAP.md Queue A item 10.
"""
from __future__ import annotations

import threading

__all__ = ["bump_counter", "counters", "reset_counters"]

_counters_lock = threading.Lock()
_counters: dict = {}


def bump_counter(name: str, n: int = 1) -> None:
    """Increment a named monotonic counter."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """Snapshot of all counters."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()
