"""The training step (``paddle_tpu/framework/jit.py`` ``train_step``).

The JAX package traces the step into one compiled XLA program; PyTorch
runs eagerly, so the port's step is the eager sequence itself, on the
card unless the caller asks for the CPU: zero the gradients, forward and
loss in train mode, backward, optimizer step. Capturing the step in a
CUDA graph comes later.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["TrainStepFn", "train_step"]


class TrainStepFn:
    """``step(*batch) -> {"loss": tensor}``: one optimizer step of ``model``
    on ``loss_fn(model, *batch)``. Numpy or CPU inputs move to the step's
    device; the model moves there once, at construction. TF32 is switched
    off for matrix products and convolutions, so float32 stays float32 on
    the card, and so is cuBLAS's reduced-precision reduction of bf16
    products, so a bf16 product's split-K sums stay f32 as the JAX
    package's ``preferred_element_type=f32`` keeps them. AMP is the
    caller's: ``loss_fn`` may run the model under ``amp.auto_cast``."""

    def __init__(self, model, optimizer, loss_fn, device=None):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.loss_fn = loss_fn

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device) if isinstance(x, torch.Tensor) else x

    def __call__(self, *batch):
        batch = [self._to_device(b) for b in batch]
        self.optimizer.clear_grad()
        self.model.train()
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach()}

    def sync(self):
        """API parity with the JAX package, whose compiled step keeps its
        state apart from the model: here the model and optimizer are the
        state, so there is nothing to write back."""
        return self


def train_step(model, optimizer, loss_fn, device=None) -> TrainStepFn:
    """Build a train step; ``loss_fn(model, *batch) -> scalar loss``.
    ``device=None`` means the CUDA card and raises without one."""
    return TrainStepFn(model, optimizer, loss_fn, device=device)
