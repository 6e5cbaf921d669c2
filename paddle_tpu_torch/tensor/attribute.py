"""``tensor.attribute`` (``paddle_tpu/tensor/attribute.py``): re-exports of the
mode-aware op front (:mod:`paddle_tpu_torch.ops`)."""
from ..ops import (  # noqa: F401
    shape,
    real,
    imag,
    rank,
    is_complex,
    is_integer,
)
