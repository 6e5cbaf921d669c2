"""``tensor.stat`` (``paddle_tpu/tensor/stat.py``): re-exports of the
mode-aware op front (:mod:`paddle_tpu_torch.ops`)."""
from ..ops import (  # noqa: F401
    mean,
    std,
    var,
    numel,
    median,
    nanmedian,
    quantile,
)
