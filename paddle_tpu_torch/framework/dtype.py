"""Dtypes (``paddle_tpu/framework/dtype.py``): the canonical name a
serialized Program stores for a dtype, the torch dtype of a name, the
dtype constants (``float32`` is ``torch.float32``, so ``t.dtype ==
paddle.float32`` holds) and the default float dtype."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dtype_name", "torch_dtype", "convert_dtype", "get_default_dtype",
           "set_default_dtype", "is_floating", "bool_", "uint8", "int8", "int16", "int32",
           "int64", "float16", "bfloat16", "float32", "float64", "complex64", "complex128"]

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_ALIASES = {"float": "float32", "double": "float64", "half": "float16", "int": "int32",
            "long": "int64", "bf16": "bfloat16", "fp16": "float16", "fp32": "float32",
            "fp64": "float64", "bool_": "bool"}

bool_ = torch.bool
uint8, int8, int16, int32, int64 = torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64
float16, bfloat16, float32, float64 = torch.float16, torch.bfloat16, torch.float32, torch.float64
complex64, complex128 = torch.complex64, torch.complex128

_default_dtype = ["float32"]


def dtype_name(dtype) -> str:
    """The canonical name (``"float32"``, ``"int8"``) of a dtype given as a
    name, a numpy dtype or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
    else:
        name = np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return name


def torch_dtype(dtype) -> torch.dtype:
    return _TORCH_DTYPES[dtype_name(dtype)]


def convert_dtype(dtype) -> torch.dtype:
    """The torch dtype of any dtype spec (a name, a numpy or torch dtype);
    None is the default float dtype."""
    return torch_dtype(_default_dtype[0] if dtype is None else dtype)


def get_default_dtype() -> str:
    """The dtype of floats made without one (``"float32"`` unless set)."""
    return _default_dtype[0]


def set_default_dtype(dtype):
    name = dtype_name(dtype)
    if name not in ("float16", "bfloat16", "float32", "float64"):
        raise TypeError(f"set_default_dtype takes a float dtype, got {dtype!r}")
    _default_dtype[0] = name


def is_floating(dtype) -> bool:
    return torch_dtype(dtype).is_floating_point
