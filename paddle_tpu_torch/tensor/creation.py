"""``tensor.creation`` (``paddle_tpu/tensor/creation.py``): re-exports of the
mode-aware op front (:mod:`paddle_tpu_torch.ops`)."""
from ..ops import (  # noqa: F401
    to_tensor,
    zeros,
    ones,
    full,
    zeros_like,
    ones_like,
    full_like,
    arange,
    linspace,
    eye,
    diag,
    tril,
    triu,
    meshgrid,
    assign,
    empty,
    empty_like,
    diagflat,
    clone,
)
