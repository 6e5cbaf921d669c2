"""``tensor.random`` (``paddle_tpu/tensor/random.py``): re-exports of the
mode-aware op front (:mod:`paddle_tpu_torch.ops`)."""
from ..ops import (  # noqa: F401
    bernoulli,
    multinomial,
    normal,
    uniform,
    randn,
    rand,
    randint,
    randperm,
    poisson,
    standard_normal,
)
