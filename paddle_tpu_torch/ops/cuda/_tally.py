"""The kernel counts' one increment, and the tallies of captures beside them.

Every wrapper bumps its count through :func:`bump`, holding its module's
count lock. While a capture records (``ops/cuda`` :func:`tallied`), what
it launches is also tallied apart from what other threads count at the
same time: on the card by the capture's stream, which is where the
capturing thread's kernels and the autograd engine's backward kernels of
the captured step launch; else (a stand-in graph on the CPU) by the
capturing thread.
"""
from __future__ import annotations

import functools
import threading

import torch
from torch.utils._python_dispatch import _disable_current_modes, _get_current_dispatch_mode_stack

_local = threading.local()
_by_stream: dict = {}  # a capture's stream handle -> its tally, while it records
_work_counters = [0]  # monitor.cost_model.count_work blocks open in the process
_work_lock = threading.Lock()


def bump(namespace, name, n=1):
    """Add ``n`` to the count ``name`` of the module whose globals are
    ``namespace``, and to the tally of the capture recording it, if any."""
    namespace[name] += n
    tally = None
    if _by_stream:
        tally = _by_stream.get(torch.cuda.current_stream().cuda_stream)
    if tally is None:
        tally = getattr(_local, "tally", None)
    if tally is not None and n:
        key = (namespace["__name__"], name)
        tally[key] = tally.get(key, 0) + n


def check_outputs(namespace, name, *tensors):
    """Hand a kernel's outputs to the NaN check active on this thread
    (``framework/nan_inf.py`` ``NanCheck``), if any, under the kernel's
    name in ``KERNEL_COUNTERS`` (the count ``name`` of the module whose
    globals are ``namespace``): a launch through ``ctypes`` is no aten op
    that the check would see."""
    for mode in _get_current_dispatch_mode_stack():
        if getattr(mode, "checks_kernels", False):
            from . import KERNEL_COUNTERS

            kernel = next((k for k, (mod, attr) in KERNEL_COUNTERS.items()
                           if attr == name and mod.__name__ == namespace["__name__"]), name)
            with _disable_current_modes():
                mode.note(kernel, tensors)
            return


def work_counters_active(n):
    """Add ``n`` to the count of open ``monitor.cost_model.count_work``
    blocks: while it is 0, a wrapper looks for none."""
    with _work_lock:
        _work_counters[0] += n


def counted(cost):
    """Decorate a kernel wrapper so that it reports ``cost(*args,
    **kwargs) -> (flops, bytes)``, the work of the function it computes, to
    the work counter active on this thread (``monitor.cost_model``
    ``WorkCount``, found on the dispatch mode stack by ``counts_work``),
    which then counts none of the aten ops the wrapper runs. The cost is
    computed from the arguments, so the wrapper counts the same on a CPU
    tensor (its plain version) as on the card."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _work_counters[0]:
                for mode in _get_current_dispatch_mode_stack():
                    if getattr(mode, "counts_work", False):
                        flops, nbytes = cost(*args, **kwargs)
                        return mode.kernel(fn.__name__, flops, nbytes, fn, args, kwargs)
            return fn(*args, **kwargs)
        return inner
    return wrap
