"""Device selection, the card's identity and its memory counters
(``paddle_tpu/device.py``, ``framework/place.py``).

Entry points run on ``cuda`` unless the caller names another device; with
no card, resolving the default raises instead of falling back to the CPU.
The ``paddle.device`` functions read ``torch.cuda``'s caching allocator,
the counters the JAX package reads from the PJRT arena; on a host without
a card the memory functions return 0 and ``memory_stats`` an empty dict,
as the JAX package's do on the CPU.
"""
from __future__ import annotations

import gc
import subprocess

import torch

from .framework.place import get_device, set_device  # noqa: F401

__all__ = ["resolve_device", "card_identity", "set_device", "get_device", "device_count",
           "get_device_name", "synchronize", "memory_allocated", "max_memory_allocated",
           "memory_reserved", "memory_stats", "empty_cache", "is_compiled_with_cuda"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device and raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def card_identity() -> str:
    """The card's ``name, power.limit`` as ``nvidia-smi`` reports them: the
    label every measurement on the card carries."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def device_count() -> int:
    return torch.cuda.device_count()


def _index(device=None):
    """The CUDA index of ``device`` (an int, ``"gpu:1"``, a place, a
    ``torch.device``; None the current one), or None without a card."""
    if not torch.cuda.is_available():
        return None
    if device is None:
        return torch.cuda.current_device()
    if isinstance(device, int):
        return device
    if isinstance(device, str):
        return int(device.rsplit(":", 1)[1]) if ":" in device else 0
    if hasattr(device, "get_device_id"):
        return device.get_device_id()
    return torch.device(device).index or 0


def get_device_name(device=None) -> str:
    i = _index(device)
    return "cpu" if i is None else torch.cuda.get_device_name(i)


def synchronize(device=None):
    """Wait for the work queued on the card (a no-op without one)."""
    i = _index(device)
    if i is not None:
        torch.cuda.synchronize(i)


def memory_stats(device=None) -> dict:
    i = _index(device)
    return {} if i is None else dict(torch.cuda.memory_stats(i))


def memory_allocated(device=None) -> int:
    i = _index(device)
    return 0 if i is None else int(torch.cuda.memory_allocated(i))


def max_memory_allocated(device=None) -> int:
    i = _index(device)
    return 0 if i is None else int(torch.cuda.max_memory_allocated(i))


def memory_reserved(device=None) -> int:
    """Bytes the caching allocator holds from the card."""
    i = _index(device)
    return 0 if i is None else int(torch.cuda.memory_reserved(i))


def empty_cache():
    """Drop dead tensors' owners, then hand the allocator's free blocks
    back to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()
