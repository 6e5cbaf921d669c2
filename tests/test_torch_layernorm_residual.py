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


# -- mixed dtypes (AMP's first encoder layer) ----------------------------------------


def _mixed_grads(x, r, w, b, dy):
    """Output and gradients of the port's op on a bf16 x and an f32
    residual (the bf16 attention output on the f32 embedding output)."""
    ts = [torch.from_numpy(x).bfloat16().requires_grad_(),
          torch.from_numpy(r).requires_grad_(), torch.from_numpy(w).requires_grad_(),
          torch.from_numpy(b).requires_grad_()]
    y = tlnr.layernorm_residual(*ts, EPS)
    y.backward(torch.from_numpy(dy).bfloat16())
    return y, ts


@pytest.mark.parametrize("rows,h", [(37, 256), (8, 768), (3, 128)])
def test_mixed_bf16_x_and_f32_residual_match_jax_reference_and_vjp(rows, h):
    """bf16 x + f32 residual, as the JAX ``_reference`` takes them: the sum
    promoted to f32, f32 statistics, the output in x's dtype; the backward
    gives x its gradient in bf16 and the residual in f32. Against
    ``_reference`` and ``jax.vjp`` on the same arrays: the output to 1 bf16
    ulp of its largest entry (both normalize in f32 and round once), dx to
    1 bf16 ulp of its largest, the residual's gradient, dw and db to 1e-5
    (f32 sums in other orders)."""
    import jax

    x, r, w, b = _inputs(rows, h, seed=rows + 5)
    dy = np.random.RandomState(rows + 6).randn(rows, h).astype("f4")
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want, vjp = jax.vjp(lambda x_, r_, w_, b_: lnr._reference(x_, r_, w_, b_, EPS),
                        jx, *map(jnp.asarray, (r, w, b)))
    wdx, wdr, wdw, wdb = (np.asarray(g.astype(jnp.float32)) for g in
                          vjp(jnp.asarray(dy).astype(jnp.bfloat16)))
    assert want.dtype == jnp.bfloat16
    y, ts = _mixed_grads(x, r, w, b, dy)
    assert y.dtype == torch.bfloat16
    assert ts[0].grad.dtype == torch.bfloat16 and ts[1].grad.dtype == torch.float32

    def ulp(a):
        return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)

    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(y.detach().float().numpy() - want).max() <= ulp(want)
    assert np.abs(ts[0].grad.float().numpy() - wdx).max() <= ulp(wdx)
    for t, g in zip(ts[1:], (wdr, wdw, wdb)):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max())


def test_mixed_dtypes_take_the_f32_kernel_entries_and_round_back(monkeypatch):
    """The card's route for the mixed case: the forward entry takes the
    bf16 x and the f32 residual as they are (the mixed kernel, no cast
    pass) and returns a bf16 output; the Function saves them uncast; the
    backward takes x and dy to f32 for the f32 backward entry and rounds
    the gradient of x back to bf16. Equal, bit for bit, to the CPU route."""
    x, r, w, b = _inputs(6, 128, seed=31)
    dy = np.random.RandomState(32).randn(6, 128).astype("f4")
    want_y, want = _mixed_grads(x, r, w, b, dy)
    seen = []

    def fwd(*a):
        seen.append(("fwd", a[0].dtype, a[1].dtype))
        out = tlnr._reference(*a)
        seen.append(("y", out[0].dtype))
        return out

    monkeypatch.setattr(tlnr, "layernorm_residual_fwd", fwd)
    monkeypatch.setattr(tlnr, "layernorm_residual_bwd",
                        lambda *a: seen.append(("bwd", a[0].dtype, a[1].dtype, a[-1].dtype))
                        or tlnr._reference_bwd(*a))
    got_y, got = _mixed_grads(x, r, w, b, dy)
    assert seen == [("fwd", torch.bfloat16, torch.float32), ("y", torch.bfloat16),
                    ("bwd", torch.float32, torch.float32, torch.float32)]
    assert torch.equal(got_y, want_y)
    for g, t in zip(got, want):
        assert torch.equal(g.grad, t.grad)


@pytest.mark.parametrize("rows,h", [(37, 256), (8, 768), (5, 1000)])
def test_mixed_entry_matches_jax_reference(rows, h):
    """The mixed forward entry's plain version on a bf16 x and an f32
    residual against the JAX ``_reference`` on the same arrays: the sum in
    f32 (bf16 x widened, no rounding), f32 statistics, y rounded to bf16
    once; to 1 bf16 ulp of the largest output (f32 sums in other orders),
    mean and rstd to 1e-5."""
    x, r, w, b = _inputs(rows, h, seed=rows + 40)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    y, mean, rstd = tlnr.layernorm_residual_fwd(tx, torch.from_numpy(r), torch.from_numpy(w),
                                                torch.from_numpy(b), EPS)
    assert y.dtype == torch.bfloat16 and mean.dtype == rstd.dtype == torch.float32
    want = np.asarray(lnr._reference(jx, jnp.asarray(r), jnp.asarray(w), jnp.asarray(b), EPS)
                      .astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(y.float().numpy() - want).max() <= ulp
    a = np.asarray(jx.astype(jnp.float32)) + r  # the f32 sum, unrounded
    np.testing.assert_allclose(mean.numpy(), a.mean(-1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(a.var(-1) + EPS), rtol=1e-5)
    # the bf16 instance rounds the sum first: the mixed case must not
    ybf, _, _ = tlnr.layernorm_residual_fwd(tx, torch.from_numpy(r).bfloat16(),
                                            torch.from_numpy(w), torch.from_numpy(b), EPS)
    assert not torch.equal(ybf, y)


def test_mixed_entry_refuses_off_cpu_and_other_mixes_and_counts_apart():
    """The mixed forward entry goes to the kernel path off the CPU, which
    refuses a tensor not on a CUDA device; only a bf16 x on an f32 residual
    is a mixed instance (an f32 x on a bf16 residual is refused by the
    entry); the plain version counts no launch, and the mixed launches
    count apart, listed in ``KERNEL_COUNTERS``."""
    from paddle_tpu_torch.ops import cuda

    w = torch.empty(768, device="meta")
    xb = torch.empty(4, 768, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tlnr.layernorm_residual_fwd(xb, xb.float(), w, w)
    with pytest.raises(ValueError, match="residual"):
        tlnr.layernorm_residual_fwd(torch.zeros(4, 128), torch.zeros(4, 128).bfloat16(),
                                    torch.ones(128), torch.zeros(128))
    with pytest.raises(ValueError, match="residual"):  # the backward takes one dtype
        tlnr.layernorm_residual_bwd(torch.zeros(4, 128).bfloat16(), torch.zeros(4, 128),
                                    torch.ones(128), torch.zeros(4), torch.ones(4),
                                    torch.zeros(4, 128).bfloat16())
    assert cuda.KERNEL_COUNTERS["layernorm_residual_fwd_mixed"] == (tlnr, "MIXED_LAUNCHES")
    before = (tlnr.LAUNCHES, tlnr.BF16_LAUNCHES, tlnr.MIXED_LAUNCHES)
    x, r, wn, b = _inputs(4, 256, seed=1)
    tlnr.layernorm_residual_fwd(torch.from_numpy(x).bfloat16(), torch.from_numpy(r),
                                torch.from_numpy(wn), torch.from_numpy(b))
    assert (tlnr.LAUNCHES, tlnr.BF16_LAUNCHES, tlnr.MIXED_LAUNCHES) == before
    tlnr._count("LAUNCHES", torch.bfloat16, torch.float32)
    assert (tlnr.LAUNCHES, tlnr.BF16_LAUNCHES, tlnr.MIXED_LAUNCHES) == (
        before[0], before[1], before[2] + 1)


@pytest.mark.parametrize("h,dtype,variant", [
    (768, torch.float32, "row"), (768, torch.bfloat16, "row"), (1024, torch.float32, "row"),
    (128, torch.float32, "row"), (256, torch.bfloat16, "row"), (384, torch.bfloat16, "block"),
    (1000, torch.bfloat16, "block"), (1152, torch.float32, "block"),
    (4096, torch.bfloat16, "block"), (100, torch.float32, "block"),
    (16384, torch.float32, "block")])
def test_forward_plan_picks_the_variant(h, dtype, variant):
    """The forward's row variant takes H a multiple of 32 lanes x 16 bytes
    of x (128 f32, 256 bf16; the mixed instance goes by its bf16 x) up to
    1024; every other width takes the block variant."""
    assert tlnr._fwd_plan(h, dtype) == variant


def test_forward_plan_mirrors_the_kernel_source():
    """The forward's C entry picks the variant by the same rule: its
    constants equal the wrapper's, and its five instances are the
    wrapper's dtype codes."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(tlnr.__file__), "..", "..", "csrc",
                            "layernorm_residual.cu")).read()
    consts = dict(re.findall(r"constexpr int (kRow\w+) = (\d+);", src))
    assert int(consts["kRowWarps"]) == tlnr._FWD_ROW_WARPS
    assert int(consts["kRowMaxH"]) == tlnr._FWD_ROW_MAX_H
    codes = re.findall(r"if \(dtype == (\d)\) return launch<(\w+), (\w+)>", src)
    names = {torch.float32: "float", torch.bfloat16: "bf16", torch.float16: "__half"}
    assert {int(c): (tx, tr) for c, tx, tr in codes} == {
        code: (names[xd], names[rd]) for (xd, rd), code in tlnr._FWD_DTYPES.items()}


def test_bf16_and_mixed_reach_the_kernel_path_and_float16_is_refused():
    """On ``meta`` tensors bf16, float16 (kernels of its own since the fp16
    instances) and their mixed cases go to the kernel entries, which refuse
    a tensor off the card; float64 has no kernel and raises TypeError
    first."""
    w = torch.empty(128, device="meta")
    bf = torch.empty(4, 128, device="meta", dtype=torch.bfloat16)
    for x in (bf, bf.half()):
        for r in (x, x.float()):
            with pytest.raises(ValueError, match="CUDA"):
                tlnr.layernorm_residual(x, r, w, w)
    wide = bf.double()
    with pytest.raises(TypeError):
        tlnr.layernorm_residual(wide, wide, w, w)
    with pytest.raises(TypeError):
        tlnr.layernorm_residual_bwd(wide, wide, w, w[:4], w[:4], wide)


def test_bf16_kernel_launches_count_apart():
    """The bf16 forward and backward kernels have counts of their own
    beside the f32 ones, all listed in ``KERNEL_COUNTERS``."""
    from paddle_tpu_torch.ops import cuda

    names = {"layernorm_residual_fwd_bf16": "BF16_LAUNCHES",
             "layernorm_residual_bwd_bf16": "BF16_BWD_LAUNCHES"}
    for name, attr in names.items():
        assert cuda.KERNEL_COUNTERS[name] == (tlnr, attr)
    before = [tlnr.LAUNCHES, tlnr.BF16_LAUNCHES]
    tlnr._count("LAUNCHES", torch.bfloat16)
    tlnr._count("LAUNCHES", torch.float32)
    assert [tlnr.LAUNCHES, tlnr.BF16_LAUNCHES] == [before[0] + 1, before[1] + 1]
