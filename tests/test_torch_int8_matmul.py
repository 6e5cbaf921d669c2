"""Port parity: the int8 matmul and the static-scale quantization ops.

The plain int8 product is held bit for bit against the JAX package's Pallas
kernel in interpret mode and its ``jnp`` fallback (integer arithmetic: no
tolerance), at the three shapes of ``tests/test_quantization.py``'s kernel
test plus K not a multiple of 4. The registry ops ``quantize_static``,
``dequantize_static``, ``quant_dequant_static``, ``mul_int8`` and
``matmul_int8`` are held against the JAX registry's on the same numpy inputs:
int8 outputs bit-equal, float32 outputs to 1 ulp (the JAX ops run through
XLA:CPU, which may fuse a multiply chain differently).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas.int8_matmul import _jnp_matmul, _pallas_matmul  # noqa: E402
from paddle_tpu.ops.registry import kernel as jax_kernel  # noqa: E402

from paddle_tpu_torch import flags  # noqa: E402
from paddle_tpu_torch.errors import UnimplementedError  # noqa: E402
from paddle_tpu_torch.ops import quantize_kernels as tqk  # noqa: E402
from paddle_tpu_torch.ops.cuda import int8_matmul as tim  # noqa: E402
from paddle_tpu_torch.ops.registry import kernel  # noqa: E402

torch.set_num_threads(1)

SHAPES = [(32, 128, 128), (37, 70, 130), (257, 129, 260), (5, 147, 9), (1, 1, 1)]


def _int8(rng, *shape):
    return rng.randint(-128, 128, shape).astype(np.int8)  # the full range, -128 included


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_product_equals_the_jax_kernel_bit_for_bit(m, k, n):
    rng = np.random.RandomState(0)
    x, w = _int8(rng, m, k), _int8(rng, k, n)
    got = tim.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(_pallas_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jnp_matmul(jnp.asarray(x),
                                                                      jnp.asarray(w))))
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ w.astype(np.int64))


def test_float64_reference_is_exact_at_the_extremes():
    """The card's reference multiplies in float64: exact while K * 2**14 <
    2**53. At K = 3072 with every product at its largest magnitude."""
    x = torch.full((3, 3072), -128, dtype=torch.int8)
    w = torch.full((3072, 2), -128, dtype=torch.int8)
    ref = (x.double() @ w.double()).to(torch.int32)
    assert torch.equal(ref, tim.int8_matmul(x, w)) and ref[0, 0].item() == 3072 * 128 * 128


def test_entry_refuses_what_the_kernel_does_not_take():
    x, w = torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 3, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        tim.int8_matmul(x.float(), w)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        tim.int8_matmul(x, w.T)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        tim.int8_matmul(x[0], w)


def test_non_cpu_tensor_reaches_the_kernel_entry_and_empty_launches_nothing():
    meta = dict(device="meta", dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tim.int8_matmul(torch.empty(4, 8, **meta), torch.empty(8, 3, **meta))
    with pytest.raises(ValueError, match="CUDA"):  # one operand on the host is no CPU call
        tim.int8_matmul(torch.empty(4, 8, **meta), torch.zeros(8, 3, dtype=torch.int8))
    before = tim.LAUNCHES
    out = tim.int8_matmul(torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 3, dtype=torch.int8))
    assert tim.LAUNCHES == before and out.dtype == torch.int32  # the plain version counts nothing


def test_flag_never_changes_a_cpu_number_and_off_raises_off_the_cpu(monkeypatch):
    """``FLAGS_use_int8_matmul`` chooses between exact routes: both settings
    give the same bits on CPU tensors; a non-CPU tensor has only the kernel,
    so off raises ``UnimplementedError`` and on reaches the kernel entry."""
    rng = np.random.RandomState(1)
    x, w = torch.from_numpy(_int8(rng, 6, 10)), torch.from_numpy(_int8(rng, 10, 5))
    on = kernel("mul_int8")(x, w, scale_x=1.5, scale_y=0.5)
    monkeypatch.setattr(flags._REGISTRY["use_int8_matmul"], "value", False)
    assert torch.equal(kernel("mul_int8")(x, w, scale_x=1.5, scale_y=0.5), on)
    meta = dict(device="meta", dtype=torch.int8)
    with pytest.raises(UnimplementedError, match="use_int8_matmul"):
        kernel("mul_int8")(torch.empty(6, 10, **meta), torch.empty(10, 5, **meta),
                           scale_x=1.0, scale_y=1.0)
    monkeypatch.setattr(flags._REGISTRY["use_int8_matmul"], "value", True)
    with pytest.raises(ValueError, match="CUDA"):
        kernel("matmul_int8")(torch.empty(6, 10, **meta), torch.empty(10, 5, **meta),
                              scale_x=1.0, scale_y=1.0)


def test_flag_default_is_on_as_in_the_jax_package():
    from paddle_tpu import flags as jax_flags

    assert flags.flag("use_int8_matmul") is True and jax_flags.flag("use_int8_matmul") is True


# -- registry ops against the JAX registry -------------------------------------------


def _ulp_close(got, want, ulps=1):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= ulps * np.spacing(np.abs(want))).all(), np.abs(got - want).max()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scale", [2.7, 0.031, 0.0])
def test_quantize_static_matches_jax_bit_for_bit(scale, bits):
    rng = np.random.RandomState(2)
    x = (rng.randn(33, 17) * 1.3).astype(np.float32)
    x[0, :4] = [scale, -scale, scale / 127 * 0.5, scale / 127 * 1.5]  # edges and half-way ties
    got = kernel("quantize_static")(torch.from_numpy(x), scale=scale, bit_length=bits)
    want = np.asarray(jax_kernel("quantize_static")(jnp.asarray(x), scale=scale,
                                                    bit_length=bits))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_round_is_half_to_even_in_both():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32)
    got = kernel("quantize_static")(torch.from_numpy(x), scale=127.0).numpy()
    want = np.asarray(jax_kernel("quantize_static")(jnp.asarray(x), scale=127.0))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [0, 2, 2, 0, -2, -2]


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_and_quant_dequant_static_match_jax_to_one_ulp(bits):
    rng = np.random.RandomState(3)
    q = _int8(rng, 9, 11)
    got = kernel("dequantize_static")(torch.from_numpy(q), scale=0.37, bit_length=bits)
    want = jax_kernel("dequantize_static")(jnp.asarray(q), scale=0.37, bit_length=bits)
    assert got.dtype == torch.float32
    _ulp_close(got.numpy(), want)
    x = (rng.randn(9, 11) * 0.4).astype(np.float32)
    got = kernel("quant_dequant_static")(torch.from_numpy(x), scale=0.91, bit_length=bits)
    want = jax_kernel("quant_dequant_static")(jnp.asarray(x), scale=0.91, bit_length=bits)
    _ulp_close(got.numpy(), want)


@pytest.mark.parametrize("ybits", [None, 4])
def test_mul_int8_matches_jax_to_one_ulp(ybits):
    rng = np.random.RandomState(4)
    x, w = _int8(rng, 2, 3, 10), _int8(rng, 10, 7)
    kw = dict(scale_x=1.7, scale_y=0.23, bit_length=8, y_bit_length=ybits, x_num_col_dims=2)
    got = kernel("mul_int8")(torch.from_numpy(x), torch.from_numpy(w), **kw)
    want = jax_kernel("mul_int8")(jnp.asarray(x), jnp.asarray(w), **kw)
    assert tuple(got.shape) == (2, 3, 7) and got.dtype == torch.float32
    _ulp_close(got.numpy(), want)


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False), (False, True), (True, True)])
def test_matmul_int8_transposes_match_jax_to_one_ulp(tx, ty):
    rng = np.random.RandomState(5)
    x = _int8(rng, *((10, 6) if tx else (6, 10)))
    w = _int8(rng, *((5, 10) if ty else (10, 5)))
    kw = dict(scale_x=0.8, scale_y=1.9, y_bit_length=4, transpose_x=tx, transpose_y=ty)
    got = kernel("matmul_int8")(torch.from_numpy(x), torch.from_numpy(w), **kw)
    want = jax_kernel("matmul_int8")(jnp.asarray(x), jnp.asarray(w), **kw)
    assert tuple(got.shape) == (6, 5)
    _ulp_close(got.numpy(), want)


def test_matmul_int8_keeps_leading_axes():
    rng = np.random.RandomState(6)
    x, w = _int8(rng, 2, 3, 10), _int8(rng, 10, 4)
    got = kernel("matmul_int8")(torch.from_numpy(x), torch.from_numpy(w), scale_x=1.0,
                                scale_y=1.0)
    want = jax_kernel("matmul_int8")(jnp.asarray(x), jnp.asarray(w), scale_x=1.0, scale_y=1.0)
    assert tuple(got.shape) == (2, 3, 4)
    _ulp_close(got.numpy(), want)


def test_dequantizing_constant_is_computed_in_python_floats():
    assert tqk._dequant_constant(2.0, 3.0, 8, 4) == 2.0 * 3.0 / (127.0 * 7.0)
    assert tqk._dequant_constant(2.0, 3.0, 8, None) == 2.0 * 3.0 / (127.0 * 127.0)


@pytest.mark.parametrize("name", ["mul", "matmul", "elementwise_add", "gelu", "relu",
                                  "layer_norm", "conv2d", "reshape"])
def test_float_op_matches_the_jax_registry(name):
    """The float ops of the served programs against the JAX registry's:
    1e-6 relative to the largest entry (sums in another order; ``gelu``'s
    erf and ``rsqrt`` are other implementations)."""
    rng = np.random.RandomState(7)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    cases = {
        "mul": ([f(2, 3, 8), f(8, 5)], dict(x_num_col_dims=2)),
        "matmul": ([f(4, 8), f(5, 8)], dict(transpose_y=True)),
        "elementwise_add": ([f(4, 8), f(8)], {}),
        "gelu": ([f(4, 8)], {}),
        "relu": ([f(4, 8)], {}),
        "layer_norm": ([f(4, 8), f(8), f(8)], dict(epsilon=1e-5, begin_norm_axis=-1)),
        "conv2d": ([f(2, 3, 8, 8), f(4, 3, 3, 3)], dict(stride=2, padding=1)),
        "reshape": ([f(4, 8)], dict(shape=(2, 16))),
    }
    args, attrs = cases[name]
    got = kernel(name)(*map(torch.from_numpy, args), **attrs).numpy()
    want = np.asarray(jax_kernel(name)(*map(jnp.asarray, args), **attrs))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_unknown_op_names_what_is_ported():
    with pytest.raises(UnimplementedError, match="while_loop"):
        kernel("while_loop")
