"""paddle.utils.run_check in the port (``paddle_tpu/utils/install_check.py``).

Checks the installation end to end: prints the version and the devices,
trains the 8-16-2 net two SGD steps through a compiled train step (on the
card the step is captured into a CUDA graph and replayed) and raises
unless the loss falls. When more than one device takes part (a
``torch.distributed`` world above one, one card a rank, as the port runs
data parallelism), it also runs a sharded step over a ``dp`` mesh and
raises unless its loss is the single device's.
"""
from __future__ import annotations

import numpy as np
import torch


def run_check(device=None):
    """``device=None`` means the card (raises without one); pass
    ``device="cpu"`` to check on the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.framework import jit as fjit
    from paddle_tpu_torch.nn import functional as F

    dev = resolve_device(device)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_available() and torch.distributed.is_initialized() else 1)
    if dev.type == "cuda":
        visible = f"{torch.cuda.device_count()} gpu device(s) ({torch.cuda.get_device_name(dev)})"
    else:
        visible = "1 cpu device"
    print(f"paddle_tpu_torch {paddle.__version__} (torch {torch.__version__}) is installed; "
          f"{visible} visible, {world} in the world.")

    def loss_fn(m, x, y):
        return F.cross_entropy(m(x), y).mean()

    def net():
        paddle.seed(0)
        model = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 2))
        return model, optimizer.SGD(learning_rate=0.1, parameters=model.parameters())

    model, opt = net()
    step = fjit.train_step(model, opt, loss_fn, device=dev)
    rng = np.random.RandomState(0)
    batch = max(16, 2 * world)  # dp-shardable on any world size
    x = rng.randn(batch, 8).astype("float32")
    y = rng.randint(0, 2, (batch,)).astype("int64")
    l0 = float(step(x, y)["loss"])
    l1 = float(step(x, y)["loss"])
    if not (np.isfinite(l0) and l1 < l0):
        raise RuntimeError(f"compiled train step did not reduce the loss ({l0} -> {l1}); "
                           "the installation is broken")
    captured = len(step.store)
    print(f"single-device compiled train step: OK ({captured} captured graph(s))")

    if world > 1:
        from paddle_tpu_torch import parallel

        model2, opt2 = net()
        sstep = parallel.sharded_train_step(model2, opt2, loss_fn,
                                            parallel.create_mesh(dp=world), device=dev)
        sl = float(sstep(x, y)["loss"])
        # a different reduction order shifts the value slightly
        if abs(sl - l0) > 5e-3 * max(abs(l0), 1e-6):
            raise RuntimeError(f"sharded-step loss {sl} diverges from single-device loss {l0}; "
                               "the multi-device path is broken")
        print(f"{world}-device sharded train step: OK (matches single-device loss)")
    print("paddle_tpu_torch is installed successfully!")
