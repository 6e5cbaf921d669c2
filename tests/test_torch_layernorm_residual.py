"""Port parity: fused residual-add + LayerNorm (``paddle_tpu_torch.ops.cuda.layernorm_residual``).

On the CPU the port's wrapper runs its plain version; it is held against
the JAX package's function and its Pallas kernel in interpret mode, with
the same numpy inputs. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas import layernorm_residual as _  # noqa: E402,F401
from paddle_tpu_torch.ops.cuda import layernorm_residual as tlnr  # noqa: E402

lnr = sys.modules["paddle_tpu.ops.pallas.layernorm_residual"]
torch.set_num_threads(1)

EPS = 1e-5


def _inputs(rows, h, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, h).astype("f4")
    r = rng.randn(rows, h).astype("f4")
    w = rng.randn(h).astype("f4")
    b = rng.randn(h).astype("f4")
    return x, r, w, b


@pytest.mark.parametrize("rows,h", [(37, 256), (8, 768), (3, 128)])
def test_plain_matches_jax_and_interpret_kernel_f32(rows, h):
    """y, mean and rstd of the port's plain version == the JAX function
    and the Pallas kernel run in interpret mode (rows not a multiple of
    the kernel's row block exercise its masked tail)."""
    x, r, w, b = _inputs(rows, h, seed=rows)
    y, mean, rstd = tlnr.layernorm_residual_fwd(*map(torch.from_numpy, (x, r, w, b)), EPS)
    ref = lnr.layernorm_residual(x, r, w, b, EPS)
    ky, kmean, krstd = lnr._pallas_fwd(jnp.asarray(x), jnp.asarray(r), jnp.asarray(w),
                                       jnp.asarray(b), EPS, interpret=True)
    tol = dict(rtol=1e-5, atol=1e-5)  # torch and XLA reduce in different orders
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(y.numpy(), np.asarray(ky), **tol)
    np.testing.assert_allclose(mean.numpy(), np.asarray(kmean)[:, 0], **tol)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(krstd)[:, 0], **tol)


def test_plain_matches_interpret_kernel_bf16_within_ulp():
    """bf16: both add in bf16 and take f32 statistics, so they agree to the
    bf16 rounding of the sum carried through the affine plus one output
    rounding (the bound of tests/test_fused_kernels.py's bf16 test)."""
    x, r, w, b = _inputs(16, 128, seed=4)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    rb = jnp.asarray(r).astype(jnp.bfloat16)
    ky, _, krstd = lnr._pallas_fwd(xb, rb, jnp.asarray(w), jnp.asarray(b), EPS, interpret=True)
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    tr = torch.from_numpy(np.array(rb.astype(jnp.float32))).to(torch.bfloat16)
    y, _, rstd = tlnr.layernorm_residual_fwd(tx, tr, torch.from_numpy(w),
                                            torch.from_numpy(b), EPS)
    assert y.dtype == torch.bfloat16
    yf = y.float().numpy()
    kf = np.asarray(ky, np.float32)
    a = np.asarray((xb + rb).astype(jnp.float32))
    ulp_in = 2.0 ** -8 * np.abs(a).max(axis=-1, keepdims=True)
    bound = (2.0 * ulp_in * rstd.numpy()[:, None] * (np.abs(w) + 1.0)
             + 2.0 ** -8 * np.abs(kf))
    d = np.abs(yf - kf)
    assert np.all(d <= bound), (d.max(), (d - bound).max())
    # XLA:CPU may keep the bf16 sum unrounded inside its fusion, so the
    # statistics agree to one bf16 rounding of the inputs, 2**-8 relative
    np.testing.assert_allclose(rstd.numpy(), np.asarray(krstd)[:, 0], rtol=2.0 ** -8)


def test_any_rank_wrapper_matches_unfused_layer_norm():
    """``layernorm_residual`` over [B, L, H] == F.layer_norm(residual + y)."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(5, 7, 64).astype("f4"))
    r = torch.from_numpy(rng.randn(5, 7, 64).astype("f4"))
    w = torch.from_numpy(rng.randn(64).astype("f4"))
    b = torch.from_numpy(rng.randn(64).astype("f4"))
    out = tlnr.layernorm_residual(x, r, w, b, EPS)
    ref = torch.nn.functional.layer_norm(r + x, (64,), w, b, EPS)
    assert out.shape == (5, 7, 64)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_variance_is_two_pass_on_large_means():
    """Rows with a mean far above their spread: E[a^2] - mean^2 would
    cancel; the two-pass variance keeps the JAX kernel's answer."""
    rng = np.random.RandomState(3)
    x = (1e3 + rng.randn(4, 256)).astype("f4")
    r = rng.randn(4, 256).astype("f4")
    w = np.ones(256, "f4")
    b = np.zeros(256, "f4")
    y, _, _ = tlnr.layernorm_residual_fwd(*map(torch.from_numpy, (x, r, w, b)), EPS)
    ky, _, _ = lnr._pallas_fwd(*map(jnp.asarray, (x, r, w, b)), EPS, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ky), rtol=1e-3, atol=1e-3)


def test_kernel_path_counts_no_launch_without_rows():
    x = torch.empty(0, 128, device="meta")
    before = tlnr.LAUNCHES
    y, mean, rstd = tlnr.layernorm_residual_fwd(x, x, torch.empty(128, device="meta"),
                                                torch.empty(128, device="meta"))
    assert tlnr.LAUNCHES == before
    assert y.shape == (0, 128) and mean.shape == rstd.shape == (0,)


def test_plain_version_does_not_count_launches():
    before = tlnr.LAUNCHES
    x, r, w, b = _inputs(4, 128, seed=0)
    tlnr.layernorm_residual_fwd(*map(torch.from_numpy, (x, r, w, b)))
    assert tlnr.LAUNCHES == before


@pytest.mark.parametrize("case", ["shape", "weight", "dtype"])
def test_bad_arguments_raise(case):
    x = torch.zeros(4, 128)
    r, w, b = torch.zeros(4, 128), torch.ones(128), torch.zeros(128)
    if case == "shape":
        r = torch.zeros(4, 64)
    elif case == "weight":
        w = torch.ones(64)
    else:
        r = r.double()
    with pytest.raises(ValueError):
        tlnr.layernorm_residual_fwd(x, r, w, b)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor runs the plain version: any other device goes to
    the kernel path, which refuses what is not on a CUDA device."""
    x = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tlnr.layernorm_residual_fwd(x, x, torch.empty(128, device="meta"),
                                    torch.empty(128, device="meta"))
