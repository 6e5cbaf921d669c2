"""Random state: the global seed and one default ``torch.Generator`` per device.

Counterpart of ``paddle_tpu/framework/random.py``. Where the JAX package
splits one global PRNG key, the port keeps a ``torch.Generator`` per
device, made on first use and seeded from the global seed, and every
random op of the port (dropout, the attention kernel's dropout seed) takes
a generator explicitly, defaulting to its device's. ``seed(value)``
re-seeds every default generator. The streams differ from the JAX
package's, so parity tests make their random inputs with numpy.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "default_generator"]

_lock = threading.Lock()
_seed = 0
_generators: dict = {}


def _key(device) -> torch.device:
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_generator(device=None) -> torch.Generator:
    """The default generator of ``device`` (the CPU's when None), made on
    first use and seeded with the global seed."""
    dev = _key(device)
    with _lock:
        gen = _generators.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_seed)
            _generators[dev] = gen
        return gen


def seed(value: int) -> torch.Generator:
    """Set the global seed (``paddle.seed``): every default generator, made
    or still to be made, starts over from ``value``. Returns the CPU's."""
    global _seed
    with _lock:
        _seed = int(value)
        for gen in _generators.values():
            gen.manual_seed(_seed)
    return default_generator("cpu")
