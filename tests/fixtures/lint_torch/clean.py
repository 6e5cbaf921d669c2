"""Clean fixture: the same shapes done right — zero findings expected."""
import threading

import torch

from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.framework.jit import train_step
from paddle_tpu_torch.runtime.compiled import compiled_step


def build(model, opt):
    nan_scan = bool(flag("check_nan_inf"))  # read ONCE when the step is built
    one = torch.tensor(1.0, dtype=torch.float32, device="cuda")  # made once, on the card

    def loss_fn(model, x, y):
        if nan_scan:  # closed-over value, not a read at capture
            x = x + one
        return ((model(x) - y) ** 2).mean()

    return train_step(model, opt, loss_fn)


def eager_loss(model, x, y):
    if flag("check_nan_inf"):  # fine: the step below runs eagerly at every call
        x = x + 1
    return ((model(x) - y) ** 2).mean()


def build_eager(model, opt):
    return train_step(model, opt, eager_loss, jit=False)


def run_compiled(store, sig, body, inputs, scale):
    with compiled_step():
        return store.run_eager(sig, lambda: body(*inputs) * scale)


class ReplayPool:
    def __init__(self):
        self._lock = threading.Lock()
        self.replays = 0
        self._worker = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while True:
            with self._lock:
                self.replays += 1  # guarded read-modify-write


def decode_tokens(engine, steps):
    toks = torch.stack([engine.step() for _ in range(steps)])
    return toks.cpu().tolist()  # ONE read, after the loop


def decode_with_cache(engine, steps):
    for _ in range(steps):
        engine.step()  # the cache stays on the card across the loop
    return engine.kv_cache.cpu()  # ONE pull, after the loop
