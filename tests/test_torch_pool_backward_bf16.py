"""Port parity: the max-pool2d backward in bf16 (``paddle_tpu_torch.ops.cuda.pool_backward``).

Under AMP the stem's pool sees the fused conv's bf16 output. The TPU kernel
compares the taps, adds the ones a window's first maximum took in float32
and rounds each element of ``dx`` once at its store
(``paddle_tpu/ops/pallas/pool_backward.py:131-135``, ``:196``). The port's
plain version does the same, so on the same bf16 inputs it equals the JAX
kernel run in interpret mode bit for bit, in NCHW and in the stem's
channels-last layout (where ``dx`` comes back channels-last). Adding the
taps in bf16 instead rounds after every tap and differs in some entries
(0.37% at the first case). The CUDA kernel is held against the plain
version on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas.pool_backward import max_pool2d_backward as jax_pool_bwd  # noqa: E402

from paddle_tpu_torch.ops.cuda import pool_backward as tpb  # noqa: E402

torch.set_num_threads(1)

GEOMS = [
    ((2, 8, 16, 16), (3, 3), (2, 2), (1, 1)),  # the stem's pool, small
    ((2, 3, 8, 8), (2, 2), (2, 2), (0, 0)),
    ((1, 4, 12, 16), (3, 3), (1, 1), (1, 1)),
    ((2, 2, 14, 14), (3, 3), (2, 2), (1, 1)),
    ((1, 2, 8, 8), (3, 2), (2, 3), (1, 0)),  # C > 1: channels-last differs from NCHW
]


def _case(shape, ks, st, p, seed):
    """bf16 x (a relu output: zeros tie), y = the pooling of x, a normal
    bf16 dy."""
    rng = np.random.RandomState(seed)
    x = torch.relu(torch.from_numpy(rng.randn(*shape).astype("f4"))).bfloat16()
    y = torch.nn.functional.max_pool2d(x, ks, st, p)
    dy = torch.from_numpy(rng.randn(*y.shape).astype("f4")).bfloat16()
    return x, y, dy


def _jax(x, y, dy, ks, st, p):
    arrays = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, y, dy)]
    dx = jax_pool_bwd(*arrays, kernel=ks, stride=st, padding=p, interpret=True)
    assert dx.dtype == jnp.bfloat16
    return np.asarray(dx.astype(jnp.float32))


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("shape,ks,st,p", GEOMS)
def test_bf16_plain_version_equals_the_jax_kernel_bit_for_bit(shape, ks, st, p, layout):
    x, y, dy = _case(shape, ks, st, p, seed=0)
    want = _jax(x, y, dy, ks, st, p)
    if layout == "nhwc":
        x, y, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, y, dy))
    got = tpb.max_pool2d_backward(x, y, dy, ks, st, p)
    assert got.dtype == torch.bfloat16 and tpb.memory_layout(got) == layout
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bf16_sums_are_float32_rounded_once():
    """An element that is the maximum of three overlapping windows takes
    their dy in float32 and rounds once: 1 + 2**-8 + 2**-8 is 1 + 2**-7, a
    bf16 value, where adding in bf16 rounds 1 + 2**-8 (a tie) to 1 twice.
    The element is the last window's first tap, which is added first."""
    x = torch.zeros(1, 1, 1, 5, dtype=torch.bfloat16)
    x[0, 0, 0, 2] = 1.0  # the maximum of the three 1 x 3 windows
    y = torch.ones(1, 1, 1, 3, dtype=torch.bfloat16)
    dy = torch.tensor([[[[2.0 ** -8, 2.0 ** -8, 1.0]]]], dtype=torch.bfloat16)
    dx = tpb.max_pool2d_backward(x, y, dy, (1, 3), (1, 1), (0, 0))
    assert dx[0, 0, 0, 2].item() == 1.0 + 2.0 ** -7
    assert dx.sum().item() == 1.0 + 2.0 ** -7


def test_bf16_off_the_cpu_reaches_the_kernel_entry():
    meta = dict(device="meta", dtype=torch.bfloat16)
    x, y = torch.empty(2, 3, 8, 8, **meta), torch.empty(2, 3, 4, 4, **meta)
    before = (tpb.LAUNCHES, tpb.BF16_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tpb.max_pool2d_backward(x, y, y, (2, 2), (2, 2), (0, 0))
    x, y, dy = _case((2, 3, 8, 8), (2, 2), (2, 2), (0, 0), seed=1)
    tpb.max_pool2d_backward(x, y, dy, (2, 2), (2, 2), (0, 0))
    assert (tpb.LAUNCHES, tpb.BF16_LAUNCHES) == before  # the plain version counts nothing
