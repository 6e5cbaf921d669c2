"""A train step runs its convolutions on cuDNN's deterministic algorithms
while it runs, so a step on the card repeats its bits run to run, as the
JAX package's compiled step does, and gives the caller's setting back after
the call. ``step.deterministic = False`` keeps cuDNN's defaults, whose
backward adds in an order that varies between runs
(``tools/lenet_repeat.py`` measures what that does to the dygraph LeNet's
Adadelta run on the card). The card cannot be reached here: the test holds
the setting the step's body sees and the one it leaves behind."""
import pytest
import torch

from paddle_tpu_torch.framework import jit as fjit
from paddle_tpu_torch.optimizer import SGD


@pytest.fixture
def restore_cudnn_flag():
    prev = torch.backends.cudnn.deterministic
    yield
    torch.backends.cudnn.deterministic = prev


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("deterministic", [True, False])
def test_a_train_step_scopes_cudnn_determinism_to_its_call(restore_cudnn_flag, caller,
                                                           deterministic):
    model = torch.nn.Linear(2, 2)
    seen = []

    def loss_fn(m, x):
        seen.append(torch.backends.cudnn.deterministic)
        return m(x).sum()

    step = fjit.train_step(model, SGD(learning_rate=0.1, parameters=model.parameters()),
                           loss_fn, device="cpu")
    assert step.deterministic is True  # the default
    step.deterministic = deterministic
    torch.backends.cudnn.deterministic = caller
    step(torch.ones(3, 2))
    assert seen == [deterministic]
    assert torch.backends.cudnn.deterministic is caller
    assert torch.backends.cudnn.allow_tf32 is False
