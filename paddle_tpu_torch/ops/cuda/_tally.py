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

import threading

import torch
from torch.utils._python_dispatch import _disable_current_modes, _get_current_dispatch_mode_stack

_local = threading.local()
_by_stream: dict = {}  # a capture's stream handle -> its tally, while it records


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
