"""Random state: the global seed and one default ``torch.Generator`` per device.

Counterpart of ``paddle_tpu/framework/random.py``. Where the JAX package
splits one global PRNG key, the port keeps a ``torch.Generator`` per
device, made on first use and seeded from the global seed, and every
random op of the port (dropout, the attention kernel's dropout seed) takes
a generator explicitly, defaulting to its device's. ``seed(value)``
re-seeds every default generator. The streams differ from the JAX
package's, so parity tests make their random inputs with numpy.

Every random op of the port draws through :func:`draw`. Two rules follow
from the compiled step (``framework/jit.py``):

- A step captured in a CUDA graph draws anew at every replay: the capture
  registers the device's generators with the graph
  (:func:`graph_generators`, ``CUDAGraph.register_generator_state``), whose
  replays then advance them as eager steps would, and draw what an eager
  step from the same state draws. A generator the capture did not register
  makes PyTorch refuse the capture.
- A forward recomputed under ``recompute=True`` draws what the first
  forward drew, as ``jax.checkpoint`` replays the same key: inside a
  :class:`Tape`'s first :func:`taped` scope every draw is recorded, and each
  later scope hands the same tensors back in order.
  ``torch.utils.checkpoint``'s ``preserve_rng_state`` covers only torch's
  own default generators, not these.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "default_generator", "graph_generators", "draw", "Tape", "taped"]

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


def graph_generators(device) -> list:
    """The generators a step captured on ``device`` draws from: its default
    generator (made now if it is not yet)."""
    return [default_generator(device)]


class Tape:
    """The draws of one forward, recorded by its first :func:`taped` scope
    and handed back, in order, by each later one."""

    def __init__(self):
        self.draws = None
        self.cursor = 0


_active = threading.local()


@contextlib.contextmanager
def taped(tape: Tape):
    """Record every :func:`draw` into ``tape`` (its first scope) or take
    them back from it (every later scope)."""
    if tape.draws is None:
        tape.draws = []
        tape.cursor = None  # recording
    else:
        tape.cursor = 0
    prev = getattr(_active, "tape", None)
    _active.tape = tape
    try:
        yield tape
    finally:
        _active.tape = prev


def draw(device, generator, fn):
    """``fn(gen)``: a random tensor drawn from ``generator`` (default:
    ``device``'s default generator), or, inside a replaying :func:`taped`
    scope, the tensor its recording scope drew at the same place."""
    tape = getattr(_active, "tape", None)
    if tape is not None and tape.cursor is not None:
        if tape.cursor >= len(tape.draws):
            raise RuntimeError(f"the recomputed forward draws more than the {len(tape.draws)} "
                               "random tensors of its first run")
        tape.cursor += 1
        return tape.draws[tape.cursor - 1]
    gen = default_generator(device) if generator is None else generator
    out = fn(gen)
    if tape is not None:
        tape.draws.append(out)
    return out
