"""Distributed training (``paddle_tpu/distributed``): so far the checkpoints, at world size 1."""
from . import checkpoint  # noqa: F401

__all__ = ["checkpoint"]
