"""Known-bad fixture: GL001 stale-flag-read in captured bodies (3 findings)."""
import torch

from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.framework.jit import train_step
from paddle_tpu_torch.runtime.compiled import compiled_step


def loss_fn(model, x, y):
    if flag("check_nan_inf"):  # BAD: train_step captures this body
        x = x + 1
    return ((model(x) - y) ** 2).mean()


def build(model, opt):
    return train_step(model, opt, loss_fn)


def run_compiled(store, sig, body, inputs):
    with compiled_step():
        scale = flag("monitor_interval")  # BAD: read while the step is captured
        return store.run_eager(sig, lambda: body(*inputs) * scale)


def record(graph, fn, x):
    with torch.cuda.graph(graph):
        return fn(x) if flag("benchmark") else x  # BAD: the graph keeps one branch
