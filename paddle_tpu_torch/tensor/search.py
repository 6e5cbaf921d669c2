"""``tensor.search`` (``paddle_tpu/tensor/search.py``): re-exports of the
mode-aware op front (:mod:`paddle_tpu_torch.ops`)."""
from ..ops import (  # noqa: F401
    argmax,
    argmin,
    argsort,
    searchsorted,
    topk,
    where,
    index_sample,
    nonzero,
    sort,
    index_select,
    mode,
    kthvalue,
)
