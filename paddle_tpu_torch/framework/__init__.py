"""Framework pieces of the port: reading ``paddle_tpu.save`` files."""
from .serialization import load  # noqa: F401
