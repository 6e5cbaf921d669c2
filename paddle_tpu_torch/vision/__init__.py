"""Vision datasets of the port (``paddle_tpu/vision``)."""
from . import datasets  # noqa: F401
