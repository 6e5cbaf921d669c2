"""``FLAGS_benchmark`` in the port's train step: with the flag on, a call
waits for the step's stream (a sync, no copy to the host) before it
returns, as the JAX step blocks on its metrics; off, it does not wait. The
stream is faked here, where there is no card."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.framework import jit as fjit
from paddle_tpu_torch.optimizer import SGD


class _Stream:
    def __init__(self):
        self.syncs = 0

    def synchronize(self):
        self.syncs += 1


@pytest.fixture
def stream(monkeypatch):
    s = _Stream()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: s)
    yield s
    set_flags({"benchmark": False})


def test_wait_syncs_the_stream_of_a_card_only(stream):
    fjit._wait_for_step(torch.device("cuda", 0))
    fjit._wait_for_step(torch.device("cpu"))
    assert stream.syncs == 1


@pytest.mark.parametrize("on", [False, True])
def test_the_step_waits_only_with_the_flag(stream, monkeypatch, on):
    waited = []
    monkeypatch.setattr(fjit, "_wait_for_step", waited.append)
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    step = fjit.train_step(model, SGD(learning_rate=0.1, parameters=model.parameters()),
                           lambda m, x: (m(x) ** 2).mean(), device="cpu")
    set_flags({"benchmark": on})
    x = np.ones((3, 4), np.float32)
    losses = [float(step(x)["loss"]) for _ in range(2)]
    assert losses[1] < losses[0]
    assert waited == ([torch.device("cpu")] * 2 if on else [])
