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
