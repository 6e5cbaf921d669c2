"""Dtype names (``paddle_tpu/framework/dtype.py``): the canonical name a
serialized Program stores for a dtype, and the torch dtype of a name."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dtype_name", "torch_dtype"]

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def dtype_name(dtype) -> str:
    """The canonical name (``"float32"``, ``"int8"``) of a dtype given as a
    name, a numpy dtype or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return name


def torch_dtype(dtype) -> torch.dtype:
    return _TORCH_DTYPES[dtype_name(dtype)]
