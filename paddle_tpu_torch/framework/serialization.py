"""Read ``paddle_tpu.save`` files (``paddle_tpu/framework/serialization.py``).

The format is the magic line ``PTPU1\\n`` followed by a pickle of the saved
object with numpy arrays as leaves. Reading only: the port writes no such
files yet. Unpickling runs code the file names, so load only files this
project wrote.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

__all__ = ["load"]

_MAGIC = b"PTPU1\n"


def _to_tensor(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_tensor(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensor(v) for v in obj)
    return obj


def load(path, return_numpy=False):
    """Load an object written by ``paddle_tpu.save``: numpy leaves with
    ``return_numpy=True``, else CPU tensors."""
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if head != _MAGIC:
            raise ValueError(f"{path} is not a paddle_tpu checkpoint (bad magic {head!r})")
        obj = pickle.load(f)
    return obj if return_numpy else _to_tensor(obj)
