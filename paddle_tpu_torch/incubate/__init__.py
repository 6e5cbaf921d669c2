"""Incubating APIs of the port (``paddle_tpu/incubate``): so far
``auto_checkpoint``."""
from . import auto_checkpoint  # noqa: F401
