"""``incubate.memory_usage`` and ``op_freq_statistic`` over the port's static
``Program`` against the JAX package's (``paddle_tpu/incubate/model_stat.py``):
programs built by the JAX package, carried as ``Program.to_dict()`` into
the port's ``Program.from_dict``, give the same numbers and the same
ordered counts; the same programs built by the port's own ``static`` give
them too; and both refuse the same bad arguments."""
import numpy as np
import pytest

import paddle_tpu.static as jstatic
from paddle_tpu import ops as jops
from paddle_tpu.incubate import memory_usage as jax_memory_usage
from paddle_tpu.incubate import op_freq_statistic as jax_op_freq
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.incubate import memory_usage, op_freq_statistic
from paddle_tpu_torch.static.program import Program


def _mlp(static, ops):
    x = static.data("x", [None, 13], "float32")
    h = static.nn.fc(x, 32, activation="relu")
    h = ops.relu(static.nn.fc(h, 16))
    static.nn.fc(h, 1)


def _conv(static, ops):
    img = static.data("img", [None, 3, 16, 16], "float32")
    h = static.nn.conv2d(img, 8, 3, padding=1, bias_attr=False)
    h = ops.relu(static.nn.batch_norm(h, is_test=True))
    h = ops.max_pool2d(h, kernel_size=2, stride=2)
    logits = static.nn.fc(ops.mean(h, axis=[2, 3]), 10)
    label = static.data("label", [None, 1], "int64")
    ops.mean(ops.softmax_with_cross_entropy(logits, label))


def _built(static, ops, build):
    static.enable_static()
    static.reset_default_programs()
    try:
        build(static, ops)
        return static.default_main_program()
    finally:
        static.disable_static()
        static.reset_default_programs()


@pytest.mark.parametrize("build", [_mlp, _conv], ids=["mlp", "conv"])
@pytest.mark.parametrize("batch", [1, 64, 100000])
def test_numbers_equal_the_jax_packages(build, batch):
    jprog = _built(jstatic, jops, build)
    tprog = Program.from_dict(jprog.to_dict())
    assert memory_usage(tprog, batch) == jax_memory_usage(jprog, batch)
    mine, theirs = op_freq_statistic(tprog), jax_op_freq(jprog)
    assert [list(d.items()) for d in mine] == [list(d.items()) for d in theirs]
    native = _built(tstatic, tops, build)
    assert memory_usage(native, batch) == jax_memory_usage(jprog, batch)
    assert op_freq_statistic(native) == theirs


def test_units_and_the_band():
    prog = _built(tstatic, tops, _mlp)
    low, high, unit = memory_usage(prog, 64)
    assert 0 < low < high and unit in ("B", "KB", "MB", "GB")
    np.testing.assert_allclose(high / low, 3.0)
    uni, adj = op_freq_statistic(prog)
    assert uni["mul"] == 3 and uni["relu"] == 2
    assert next(iter(uni)) == max(uni, key=uni.get)
    assert any("relu" in k for k in adj)


def test_bad_arguments_raise_as_in_the_jax_package():
    prog = _built(tstatic, tops, _mlp)
    with pytest.raises(ValueError, match="positive"):
        memory_usage(prog, 0)
    with pytest.raises(TypeError):
        memory_usage("not a program", 1)
    with pytest.raises(TypeError):
        op_freq_statistic(42)
    block = prog.global_block()
    op = block.ops[0]
    block.var(op.outputs[next(iter(op.outputs))][0]).shape = [-1, -1]
    with pytest.raises(ValueError, match="more than one negative dim"):
        memory_usage(prog, 2)
