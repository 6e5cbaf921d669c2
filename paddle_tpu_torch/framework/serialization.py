"""Read ``paddle_tpu.save`` files (``paddle_tpu/framework/serialization.py``).

The format is the magic line ``PTPU1\\n`` followed by a pickle of the saved
object with numpy arrays as leaves; :func:`dumps` makes those bytes
(tensors become numpy leaves) and :func:`loads` reads them, :func:`save`
and :func:`load` do the same through a file, so either package reads the
other's files and checkpoint shards (``distributed/checkpoint.py``).
Unpickling runs code the file names, so load only files this project
wrote.
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load", "dumps", "loads"]

_MAGIC = b"PTPU1\n"


def _to_tensor(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, dict):
        return {k: _to_tensor(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensor(v) for v in obj)
    return obj


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def dumps(obj, protocol=4) -> bytes:
    """The ``paddle_tpu.save`` bytes of ``obj`` (magic + pickle of its
    host values), the JAX package's ``dumps``."""
    buf = io.BytesIO()
    buf.write(_MAGIC)
    pickle.dump(_to_host(obj), buf, protocol=protocol)
    return buf.getvalue()


def loads(data: bytes, return_numpy=False):
    """Inverse of :func:`dumps`: numpy leaves with ``return_numpy=True``,
    else CPU tensors."""
    if not data.startswith(_MAGIC):
        raise ValueError(f"not a paddle_tpu checkpoint (bad magic {data[:8]!r})")
    obj = pickle.loads(data[len(_MAGIC):])
    return obj if return_numpy else _to_tensor(obj)


def save(obj, path, protocol=4):
    """Write a (nested) dict / list of tensors, arrays and plain values to
    ``path`` in the ``paddle_tpu.save`` format."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(dumps(obj, protocol=protocol))


def load(path, return_numpy=False):
    """Load an object written by ``paddle_tpu.save``: numpy leaves with
    ``return_numpy=True``, else CPU tensors."""
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if head != _MAGIC:
            raise ValueError(f"{path} is not a paddle_tpu checkpoint (bad magic {head!r})")
        obj = pickle.load(f)
    return obj if return_numpy else _to_tensor(obj)
