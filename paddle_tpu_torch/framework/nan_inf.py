"""``FLAGS_check_nan_inf`` in the train step: which operation made the first NaN.

The JAX package runs its checked train step through ``checkify`` with
``float_checks`` (``paddle_tpu/framework/jit.py:487-518``): every
primitive's output is tested for NaN, and the first one that held a NaN
is named (``nan generated by primitive: dot_general``). An inf alone is
no error there, and it is none here.

The port's counterpart is :class:`NanCheck`, a ``TorchDispatchMode``
around the step's forward, backward and update. For each aten op with a
floating output it keeps ``isnan(out).any()`` as a 0-dim tensor on the
device and the op's name (``aten::mm``) on the host; views, which make no
values, and the ``empty`` family, whose outputs hold whatever the memory
held, are left out. :meth:`NanCheck.verdict_into` writes, on the device,
whether any op made a NaN and the index of the first one, so a checked
step captured in a CUDA graph keeps its verdict in two scalars that each
replay rewrites; the names, listed while the step ran or was captured,
are the same for every replay. The host reads the two scalars after the
step: one sync a step, and only with the flag on.

A hand-written kernel's launch through ``ctypes`` is not an aten op, so
its wrapper hands its outputs to ``ops/cuda/_tally.py`` ``check_outputs``,
which finds the active check (:attr:`NanCheck.checks_kernels`) and tests
them under the kernel's own name; else a NaN the kernel made would be
blamed on the next aten op that read it.

:func:`nan_event_action` is the ``FLAGS_check_nan_inf_action`` policy the
train step and the executor share (``paddle_tpu/monitor/flight_recorder.py``
``nan_event_action``): every event is counted (:func:`nan_events` and the
registry's ``debug/nan_events``) and recorded as a ``nan_inf`` flight
event; then ``raise`` (the caller raises), ``warn`` (a ``RuntimeWarning``,
the run goes on) or ``dump`` (a flight-recorder snapshot is written, then
the caller raises, as ``paddle_tpu/framework/jit.py:504-509`` does).
"""
from __future__ import annotations

import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["NanCheck", "nan_event_action", "nan_events"]

# ops whose outputs are allocations, not values
_UNWRITTEN = frozenset({"aten::empty", "aten::empty_like", "aten::empty_strided",
                        "aten::new_empty", "aten::new_empty_strided", "aten::resize_",
                        "aten::set_"})

_events = 0
_events_lock = threading.Lock()


def nan_events() -> int:
    """NaN events counted so far in this process (``debug/nan_events`` of
    the JAX package's registry)."""
    return _events


class NanCheck(TorchDispatchMode):
    """Inside ``with NanCheck() as chk:``, every aten op with a floating
    output is tested for NaN (module docstring). :attr:`names` lists the
    tested ops in order."""

    #: the kernel wrappers hand their outputs to this mode (``_tally.check_outputs``)
    checks_kernels = True

    def __init__(self):
        super().__init__()
        self.names: list[str] = []
        self._bad: list[torch.Tensor] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if not func.is_view and name not in _UNWRITTEN:
            self.note(name, out)
        return out

    def note(self, name, out):
        """Test the floating tensors of ``out`` for NaN under ``name``
        (called with this mode off)."""
        ts = [t for t in tree_leaves(out)
              if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()]
        if not ts:
            return
        bad = torch.isnan(ts[0]).any()
        for t in ts[1:]:
            bad = bad | torch.isnan(t).any()
        self.names.append(name)
        self._bad.append(bad)

    def verdict_into(self, found, first):
        """Write into ``found`` (0-dim bool) whether an op made a NaN and
        into ``first`` (0-dim int64) the index in :attr:`names` of the
        first that did, both on the device, without a host read."""
        if not self._bad:
            found.fill_(False)
            first.fill_(-1)
            return
        bad = torch.stack(self._bad)
        found.copy_(bad.any())
        first.copy_(bad.to(torch.int32).argmax())


def nan_event_action(where, detail):
    """The ``FLAGS_check_nan_inf_action`` policy for a NaN/Inf found at
    ``where`` (``monitor.flight_recorder.nan_event_action``): counts the
    event (also in :func:`nan_events`) and records a ``nan_inf`` flight
    event, then returns None for ``warn`` (after a ``RuntimeWarning``; the
    caller goes on), or the action for ``raise`` and ``dump`` (the caller
    raises its own error; for ``dump`` the flight-recorder snapshot is
    written first); any other value raises ``InvalidArgumentError``."""
    from ..monitor import flight_recorder as _flight

    global _events
    action = _flight.nan_event_action(where, detail)
    with _events_lock:
        _events += 1
    return action
