"""The fleet router of disaggregated serving (``paddle_tpu/serving/router.py``): not ported yet.

The JAX router composes a ``prefill`` tier's ``/prefill`` with a ``decode``
tier's ``/generate_kv`` behind one ``/generate``, picks backends by kind and
load, and re-picks on a kind mismatch. The port's tiers speak the same wire
(:mod:`paddle_tpu_torch.generation.handoff`), so a client can drive the two
legs itself meanwhile; the router is ROADMAP.md Queue A item 3, entry 5.
"""
from __future__ import annotations

from ..errors import UnimplementedError

__all__ = ["Router"]


class Router:
    """Raises :class:`~paddle_tpu_torch.errors.UnimplementedError` naming
    its ROADMAP entry."""

    def __init__(self, *args, **kwargs):
        raise UnimplementedError("Router: the disaggregated fleet's router (ROADMAP.md Queue A "
                                 "item 3, entry 5) is not ported yet")
