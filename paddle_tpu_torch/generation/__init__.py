"""Autoregressive decoding of the port (``paddle_tpu/generation``): the
eager greedy loop. The KV caches, the sampling ops and the engine are not
ported yet."""
from .sampling import decode_loop  # noqa: F401

__all__ = ["decode_loop"]
