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


# -- backward ---------------------------------------------------------------


def _grads_through_function(x, r, w, b, dy):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, r, w, b)]
    y = tlnr.layernorm_residual(*ts, EPS)
    y.backward(torch.from_numpy(dy))
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("rows,h,block_r", [(37, 256, 16), (8, 768, 8), (3, 128, 2)])
def test_plain_backward_matches_interpret_kernel_and_vjp_f32(rows, h, block_r):
    """d_input, dw and db of the port's plain backward == the Pallas
    backward kernel in interpret mode on the same saved statistics (row
    blocks that do not divide the rows exercise its masked tail) and
    ``jax.vjp`` of the JAX ``_reference``; through the autograd Function
    the same gradient reaches x and the residual."""
    import jax

    x, r, w, b = _inputs(rows, h, seed=rows + 1)
    dy = np.random.RandomState(rows).randn(rows, h).astype("f4")
    _, mean, rstd = tlnr.layernorm_residual_fwd(*map(torch.from_numpy, (x, r, w, b)), EPS)
    da, dwp, dbp = tlnr.layernorm_residual_bwd(*map(torch.from_numpy, (x, r, w)), mean, rstd,
                                               torch.from_numpy(dy))
    kda, kdw, kdb = lnr._pallas_bwd(*map(jnp.asarray, (x, r, w)),
                                    jnp.asarray(mean.numpy()[:, None]),
                                    jnp.asarray(rstd.numpy()[:, None]), jnp.asarray(dy),
                                    interpret=True, block_r=block_r)
    _, vjp = jax.vjp(lambda x, r, w, b: lnr._reference(x, r, w, b, EPS),
                     *map(jnp.asarray, (x, r, w, b)))
    vdx, vdr, vdw, vdb = vjp(jnp.asarray(dy))
    tol = dict(rtol=1e-5, atol=1e-5)  # f32 sums in other orders
    np.testing.assert_allclose(da.numpy(), np.asarray(kda), **tol)
    np.testing.assert_allclose(dwp.sum(0).numpy(), np.asarray(kdw), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dbp.sum(0).numpy(), np.asarray(kdb), rtol=1e-5, atol=1e-4)
    gx, gr, gw, gb = _grads_through_function(x, r, w, b, dy)
    for got, want in ((gx, vdx), (gr, vdr)):
        np.testing.assert_allclose(got, np.asarray(want), **tol)
    np.testing.assert_allclose(gw, np.asarray(vdw), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gb, np.asarray(vdb), rtol=1e-5, atol=1e-4)


def test_plain_backward_matches_interpret_kernel_bf16():
    """bf16: both backwards compute in f32 from the same saved statistics
    and round ``d_input`` once to bf16; they differ by the bf16 rounding
    of ``x + res`` (the port rounds, XLA:CPU may keep the sum in f32 inside
    its fusion), carried through ``x^ * c2``, plus one output rounding."""
    rows, h = 21, 128
    x, r, w, _ = _inputs(rows, h, seed=9)
    dy = np.random.RandomState(9).randn(rows, h).astype("f4")
    xb, rb, dyb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, r, dy))
    _, kmean, krstd = lnr._pallas_fwd(xb, rb, jnp.asarray(w), jnp.asarray(w), EPS,
                                      interpret=True)
    kda, kdw, kdb = lnr._pallas_bwd(xb, rb, jnp.asarray(w), kmean, krstd, dyb, interpret=True,
                                    block_r=8)
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in (xb, rb, dyb)]
    mean = torch.from_numpy(np.array(kmean)[:, 0])
    rstd = torch.from_numpy(np.array(krstd)[:, 0])
    da, dwp, dbp = tlnr.layernorm_residual_bwd(tb[0], tb[1], torch.from_numpy(w), mean, rstd,
                                               tb[2])
    assert da.dtype == torch.bfloat16 and dwp.dtype == torch.float32
    got, want = da.float().numpy(), np.asarray(kda, np.float32)
    a = np.asarray((xb + rb).astype(jnp.float32))
    rs = rstd.numpy()[:, None]
    wdy = np.abs(np.asarray(dyb, np.float32) * w)
    # |d x^| <= ulp(a) * rstd, times |c2| <= max |w dy|, times rstd; and
    # one bf16 rounding of the larger output
    ulp_a = 2.0 ** -8 * np.abs(a).max(axis=-1, keepdims=True)
    bound = (ulp_a * rs * wdy.max(axis=-1, keepdims=True) * rs
             + 2.0 ** -8 * np.maximum(np.abs(got), np.abs(want)) + 1e-6)
    assert np.all(np.abs(got - want) <= bound), (np.abs(got - want) - bound).max()
    # dw sums dy * x^ over rows: the same x^ difference, relative 2**-8
    np.testing.assert_allclose(dwp.sum(0).numpy(), np.asarray(kdw), rtol=2.0 ** -7,
                               atol=2.0 ** -7 * np.abs(np.asarray(kdw)).max())
    np.testing.assert_allclose(dbp.sum(0).numpy(), np.asarray(kdb), rtol=1e-5, atol=1e-5)


def test_function_routes_through_the_kernel_entries(monkeypatch):
    """The autograd wiring the card takes: the Function calls the forward
    and backward entries (here standing in for the kernels with their
    plain versions) and gives the gradients of plain autograd through the
    unfused ``LayerNorm(x + res)``."""
    calls = []
    monkeypatch.setattr(tlnr, "layernorm_residual_fwd",
                        lambda *a: calls.append("fwd") or tlnr._reference(*a))
    monkeypatch.setattr(tlnr, "layernorm_residual_bwd",
                        lambda *a: calls.append("bwd") or tlnr._reference_bwd(*a))
    x, r, w, b = _inputs(5, 64, seed=11)
    dy = np.random.RandomState(11).randn(5, 3, 64).astype("f4")
    x, r = x.repeat(3, 0).reshape(5, 3, 64), r.repeat(3, 0).reshape(5, 3, 64)
    got = _grads_through_function(x, r, w, b, dy)
    assert calls == ["fwd", "bwd"]
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (x, r, w, b)]
    torch.nn.functional.layer_norm(ts[0] + ts[1], (64,), ts[2], ts[3], EPS).backward(
        torch.from_numpy(dy))
    for g, t in zip(got, ts):
        np.testing.assert_allclose(g, t.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_backward_entry_refuses_non_cpu_tensors_and_counts_no_empty_launch():
    meta = dict(device="meta")
    x = torch.empty(4, 128, **meta)
    w, stat = torch.empty(128, **meta), torch.empty(4, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        tlnr.layernorm_residual_bwd(x, x, w, stat, stat, x)
    before = tlnr.BWD_LAUNCHES
    empty = torch.empty(0, 128, **meta)
    da, dwp, dbp = tlnr.layernorm_residual_bwd(empty, empty, w, torch.empty(0, **meta),
                                               torch.empty(0, **meta), empty)
    assert tlnr.BWD_LAUNCHES == before
    assert da.shape == (0, 128) and dwp.shape == dbp.shape == (1, 128)


@pytest.mark.parametrize("rows,h,dtype,variant", [
    (16384, 768, torch.float32, "row"), (16384, 768, torch.bfloat16, "row"),
    (12345, 1024, torch.float32, "row"), (1, 768, torch.float32, "row"),
    (7, 256, torch.bfloat16, "row"), (37, 4100, torch.float32, "block"),
    (37, 100, torch.float32, "block"), (5, 384, torch.bfloat16, "block"),
    (5, 1152, torch.float32, "block"), (2000, 16384, torch.float32, "block")])
def test_backward_plan_picks_the_variant_and_grid(rows, h, dtype, variant):
    """The row variant takes H a multiple of 32 lanes x 16 bytes up to 1024;
    its grid is a fixed number of blocks an SM (fewer for few rows), the
    block variant's up to 1024 blocks; every partial row covers >= 1 row."""
    sms = 132
    got, per_block, nblocks = tlnr._bwd_plan(rows, h, dtype, sms)
    assert got == variant
    assert per_block >= 1 and (nblocks - 1) * per_block < rows <= nblocks * per_block
    if variant == "row":
        assert nblocks == min(-(-rows // tlnr._ROW_WARPS), tlnr._ROW_BLOCKS_PER_SM * sms)
    else:
        assert nblocks <= tlnr._BWD_MAX_BLOCKS


def test_backward_plan_mirrors_the_kernel_source():
    """The C entry picks the variant by the same rule: its constants equal
    the wrapper's."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(tlnr.__file__), "..", "..", "csrc",
                            "layernorm_residual_bwd.cu")).read()
    consts = dict(re.findall(r"constexpr int (kRow\w+) = (\d+);", src))
    assert int(consts["kRowWarps"]) == tlnr._ROW_WARPS
    assert int(consts["kRowMaxH"]) == tlnr._ROW_MAX_H
