"""Predictor over a module (``paddle_tpu/inference/predictor.py``).

The port has no static Program IR yet, so its ``Predictor`` wraps an
``nn.Module`` and the ``InputSpec``s of its positional inputs, with the
interface the serving stack uses: ``get_input_names``,
``get_output_names``, ``run(list of numpy) -> list of numpy`` and
``clone()``. Loading a saved Program is not ported yet.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..device import resolve_device
from ..errors import InvalidArgumentError

__all__ = ["Predictor"]


class Predictor:
    """Runs ``module(*inputs)`` in eval mode under ``torch.inference_mode()``.

    ``input_spec`` names and shapes the module's positional inputs;
    ``output_names`` names its outputs (a tensor or a tuple of them).
    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU. TF32 is switched off for matrix
    products and convolutions, so float32 stays float32 on the card.
    """

    def __init__(self, module, input_spec, output_names, device=None):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.input_spec = list(input_spec)
        names = [s.name for s in self.input_spec]
        if any(n is None for n in names) or len(set(names)) != len(names):
            raise InvalidArgumentError(f"every InputSpec needs a distinct name, got {names}")
        self._feed_names = names
        self._fetch_names = list(output_names)
        self.module = module.to(self.device).eval()

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def clone(self):
        """A replica sharing the module (and so its weights on the device):
        N clones serve N worker threads from one copy of the weights."""
        return copy.copy(self)

    def run(self, inputs):
        """``inputs``: numpy arrays in ``get_input_names()`` order. Returns
        numpy arrays in ``get_output_names()`` order."""
        if len(inputs) != len(self._feed_names):
            raise InvalidArgumentError(
                f"expected {len(self._feed_names)} inputs {self._feed_names}, got {len(inputs)}")
        with torch.inference_mode():
            feeds = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in inputs]
            outs = self.module(*feeds)
            if isinstance(outs, torch.Tensor):
                outs = (outs,)
            if len(outs) != len(self._fetch_names):
                raise InvalidArgumentError(
                    f"module returned {len(outs)} outputs, expected {self._fetch_names}")
            return [o.cpu().numpy() for o in outs]
