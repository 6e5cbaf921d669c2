"""Runtime pieces of the port: the store of captured steps (``compiled``),
counterpart of ``paddle_tpu/runtime``."""
from . import compiled  # noqa: F401
