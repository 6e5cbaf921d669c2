"""``FLAGS_call_stack_level`` in the port's errors (``paddle_tpu_torch/errors.py``)
against the JAX package's: at levels 0 and 1 every error class both
packages have formats the same message, with and without an op context;
level 2 adds the Python call stack under its header."""
import pytest

from paddle_tpu import errors as jax_errors
from paddle_tpu.flags import flag as jax_flag
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu_torch import errors
from paddle_tpu_torch.flags import flag, set_flags

CLASSES = [n for n in errors.__all__ if n != "op_error_context"]
CONTEXTS = [None, {"op_type": "mul", "inputs": ["x", "w"], "outputs": ["y"]},
            {"op_type": "relu"}]


@pytest.fixture
def level():
    old, jax_old = flag("call_stack_level"), jax_flag("call_stack_level")

    def set_level(n):
        set_flags({"call_stack_level": n})
        jax_set_flags({"call_stack_level": n})

    yield set_level
    set_flags({"call_stack_level": old})
    jax_set_flags({"call_stack_level": jax_old})


def test_the_flag_has_the_jax_default():
    assert flag("call_stack_level") == jax_flag("call_stack_level") == 1
    assert flag("benchmark") is jax_flag("benchmark") is False


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("name", CLASSES)
def test_message_equals_the_jax_packages(level, n, name):
    level(n)
    for ctx in CONTEXTS:
        mine = getattr(errors, name)("bad shape", op_context=ctx)
        theirs = getattr(jax_errors, name)("bad shape", op_context=ctx)
        assert str(mine) == str(theirs)
        assert mine.code == theirs.code and mine.raw_message == "bad shape"
    if n == 0:
        assert "operator" not in str(getattr(errors, name)("m", op_context=CONTEXTS[1]))


def _raise_deep(cls):
    def inner():
        raise cls("deep", op_context=CONTEXTS[1])

    inner()


def test_level_2_carries_the_call_stack(level):
    level(2)
    with pytest.raises(errors.InvalidArgumentError) as ei:
        _raise_deep(errors.InvalidArgumentError)
    msg = str(ei.value)
    head, _, stack = msg.partition("  [python call stack]\n")
    assert head == ("[INVALID_ARGUMENT] deep\n"
                    "  [operator < mul > error] inputs=['x', 'w'] outputs=['y']\n")
    assert "test_level_2_carries_the_call_stack" in stack and "_raise_deep" in stack
    with pytest.raises(jax_errors.InvalidArgumentError) as ej:
        _raise_deep(jax_errors.InvalidArgumentError)
    assert str(ej.value).partition("  [python call stack]\n")[0] == head

