"""Distributed training (``paddle_tpu/distributed``): so far the checkpoints,
at world size 1, and the fault-injection hooks (``chaos``)."""
from . import chaos, checkpoint  # noqa: F401

__all__ = ["chaos", "checkpoint"]
