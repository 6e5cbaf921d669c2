"""Known-bad fixture: GL004 weak-type-capture in captured bodies (3 findings)."""
import torch

from paddle_tpu_torch.framework.jit import eval_step
from paddle_tpu_torch.jit_api import to_static


@to_static
def shifted(x):
    return x + torch.tensor(1)  # BAD: a host int64 tensor made at capture


def head(model, x):
    return model(x) * torch.as_tensor(0.5, dtype=torch.float32)  # BAD: no device


def serve(model, store, sig, inputs):
    step = eval_step(model, head)
    store.capture(sig, lambda x: x + torch.tensor([1, 2], device=x.device), inputs)  # BAD
    return step
