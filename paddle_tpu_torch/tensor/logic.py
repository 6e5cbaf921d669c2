"""``tensor.logic`` (``paddle_tpu/tensor/logic.py``): re-exports of the
mode-aware op front (:mod:`paddle_tpu_torch.ops`)."""
from ..ops import (  # noqa: F401
    equal,
    greater_equal,
    greater_than,
    less_equal,
    less_than,
    logical_and,
    logical_not,
    logical_or,
    logical_xor,
    not_equal,
    allclose,
    equal_all,
    isclose,
    isnan,
    isinf,
    isfinite,
    is_empty,
)
