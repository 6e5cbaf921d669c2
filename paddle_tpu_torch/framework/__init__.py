"""Framework pieces of the port: reading ``paddle_tpu.save`` files, the
random state, and the training step."""
from . import jit, random  # noqa: F401
from .random import seed  # noqa: F401
from .serialization import load  # noqa: F401
