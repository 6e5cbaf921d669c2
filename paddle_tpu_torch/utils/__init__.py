"""Small helpers of the port (``paddle_tpu/utils``): the dataset home,
``run_check`` and the gated ``download``."""
from .install_check import run_check  # noqa: F401
from . import download  # noqa: F401
