"""Device selection and the card's identity.

Counterpart of ``paddle_tpu/device.py`` and ``framework/place.py``. Entry
points run on ``cuda`` unless the caller names another device; with no
card, resolving the default raises instead of falling back to the CPU.
"""
from __future__ import annotations

import subprocess

import torch

__all__ = ["resolve_device", "card_identity"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device and raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def card_identity() -> str:
    """The card's ``name, power.limit`` as ``nvidia-smi`` reports them: the
    label every measurement on the card carries."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()
