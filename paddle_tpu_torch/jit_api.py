"""``InputSpec``: the name, shape and dtype of one model input.

Counterpart of ``paddle_tpu/jit_api.py`` ``InputSpec``. ``None`` (or -1)
marks the batch axis, which serving fills with a bucket size.
"""
from __future__ import annotations

__all__ = ["InputSpec"]


class InputSpec:
    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"
