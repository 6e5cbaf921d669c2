"""Port parity: the fused conv + batch_norm + relu in bf16 (``paddle_tpu_torch.ops.cuda.conv_bn_relu``).

Under AMP the fused conv takes bf16 ``x`` and ``weight`` with float32
gamma, beta and statistics. On the CPU the port's entries run their plain
versions; here each is held against the JAX package's Pallas kernel in
interpret mode on the same bf16 inputs (rows 8-13 of PERF.md's table), the
training core's gradients against ``jax.vjp`` of ``_train_core`` and the
whole op against ``jax.vjp`` of ``_fused(..., interpret=True, force=True)``.
The K padding that bf16 rows need on the card (``_as_matmul(...,
k_multiple=8)``) must change nothing. The CUDA kernels are held against the
plain versions on the card by ``chip_smoke.py``.

Tolerances, with their readings on the CPU:

- ``co`` and the eval output (rows 8, 9): bit-equal (read: bit-equal; the
  plain product rounds an f32 sum once, as the TPU kernel does);
- ``bn_relu`` (row 11): 1 bf16 ulp of each entry (read: one entry of 576,
  where XLA contracts ``co * scale + shift`` into one rounding);
- the float32 sums (rows 9, 10, 12) and ``d_co`` (row 13): rtol 1e-5 of the
  largest (sums of a few hundred terms in another order);
- the matrix gradients of the training core: each entry within 1 bf16 ulp
  of itself and at most 0.1% of the entries differing (read: 3 of 18,432
  in ``dp2``, 1 of 1,152 in ``dw2``, ties of the float32 sums' order). A
  ``d_co`` rounded to bf16 and bf16 products, the fault this file pins,
  make 39% and 46% of them differ, by up to 6,306 ulps of an entry.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas import conv_bn_relu as _  # noqa: E402,F401
from paddle_tpu_torch.ops.cuda import conv_bn_relu as tcbr  # noqa: E402

cbr = sys.modules["paddle_tpu.ops.pallas.conv_bn_relu"]
torch.set_num_threads(1)

SUM_TOL = dict(rtol=1e-5, atol=1e-4)
# the matrix gradients: share of entries that may differ, each by 1 ulp
GRAD_DIFFERING = 1e-3
# M, K and N ragged against the TPU kernel's tiles (K a multiple of 8, as
# the bf16 lowering gives it)
M, K, N = 300, 40, 24


def _ulp(a):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _mats(seed=0):
    rng = np.random.RandomState(seed)
    p2 = rng.randn(M, K).astype("f4")
    w2 = (rng.randn(K, N) * 0.3).astype("f4")
    co = (rng.randn(M, N) + rng.randn(1, N)).astype("f4")
    dy = rng.randn(M, N).astype("f4")
    vecs = [(rng.randn(N) * s).astype("f4") for s in (1.0, 0.5, 0.1, 0.1)]
    return p2, w2, co, dy, vecs


def _tb(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


def _jb(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _f32(a):
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a).astype(jnp.float32)))


def test_mm_affine_relu_bf16_plain_equals_interpret_kernel():
    p2, w2, _, _, (scale, shift, _, _) = _mats()
    got = tcbr.mm_affine_relu(_tb(p2), _tb(w2), torch.from_numpy(scale), torch.from_numpy(shift))
    want = cbr._mm_affine_relu(_jb(p2), _jb(w2), jnp.asarray(scale), jnp.asarray(shift),
                               interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_mm_stats_bf16_plain_equals_interpret_kernel():
    """``co`` rounded to bf16 once; its channel sums in float32 from the
    rounded values (``conv_bn_relu.py:245-250``)."""
    p2, w2, *_ = _mats(1)
    co, partial = tcbr.mm_stats(_tb(p2), _tb(w2))
    want_co, want_sum = cbr._mm_stats(_jb(p2), _jb(w2), interpret=True)
    assert co.dtype == torch.bfloat16 and partial.dtype == torch.float32
    np.testing.assert_array_equal(_f32(co), _f32(want_co)[:M, :N])
    np.testing.assert_allclose(partial.sum(0).numpy(), np.asarray(want_sum), **SUM_TOL)
    # the sums are the rounded co's, not the unrounded product's
    np.testing.assert_allclose(partial.sum(0).numpy(), _f32(co).astype("f8").sum(0), rtol=1e-6)


def test_centered_sumsq_bf16_plain_matches_interpret_kernel():
    _, _, co, _, _ = _mats(2)
    cob = _tb(co)
    mean = cob.float().mean(0)
    got = tcbr.centered_sumsq(cob, mean).sum(0)
    want = cbr._centered_sumsq(_jb(co), jnp.asarray(mean.numpy()), M, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)


def test_bn_relu_bf16_plain_matches_interpret_kernel_to_an_ulp():
    _, _, co, _, (scale, shift, _, _) = _mats(3)
    got = tcbr.bn_relu(_tb(co), torch.from_numpy(scale), torch.from_numpy(shift))
    want = _f32(cbr._bn_relu(_jb(co), jnp.asarray(scale), jnp.asarray(shift), interpret=True))
    assert got.dtype == torch.bfloat16
    assert np.all(np.abs(_f32(got) - want) <= _ulp(want))


def test_bn_bwd_partials_bf16_plain_matches_interpret_kernel():
    _, _, co, dy, (scale, shift, _, _) = _mats(4)
    pdy, pdyc = tcbr.bn_bwd_partials(_tb(co), _tb(dy), torch.from_numpy(scale),
                                     torch.from_numpy(shift))
    want_dy, want_dyc = cbr._bn_bwd_partials(_jb(co), _jb(dy), jnp.asarray(scale),
                                             jnp.asarray(shift), interpret=True)
    assert pdy.dtype == pdyc.dtype == torch.float32
    np.testing.assert_allclose(pdy.sum(0).numpy(), np.asarray(want_dy), **SUM_TOL)
    np.testing.assert_allclose(pdyc.sum(0).numpy(), np.asarray(want_dyc), **SUM_TOL)


def test_bn_bwd_dco_bf16_plain_is_float32_as_the_interpret_kernel():
    """``d_co`` stays float32 from bf16 ``co`` and ``dy`` (``:501``)."""
    _, _, co, dy, vecs = _mats(5)
    got = tcbr.bn_bwd_dco(_tb(co), _tb(dy), *(torch.from_numpy(v) for v in vecs))
    want = np.asarray(cbr._bn_bwd_dco(_jb(co), _jb(dy), *(jnp.asarray(v) for v in vecs),
                                      interpret=True))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# -- the training core's gradients ------------------------------------------------


def _differing(got, want):
    """(share of entries that differ, worst difference in ulps of the entry)."""
    d = np.abs(got - want)
    return float((d > 0).mean()), float((d / _ulp(want)).max())


def test_train_core_bf16_gradients_match_jax_vjp():
    """``_TrainCore`` on bf16 p2 [256, 72] @ w2 [72, 16] against ``jax.vjp``
    of ``_train_core(..., interpret=True)``: ``d_co`` float32, both matrix
    gradients float32 products rounded once (``:560-561``)."""
    rng = np.random.RandomState(0)
    p2 = rng.randn(256, 72).astype("f4")
    w2 = (rng.randn(72, 16) * 0.3).astype("f4")
    g, b = (rng.rand(16) + 0.5).astype("f4"), (rng.randn(16) * 0.1).astype("f4")
    dy = rng.randn(256, 16).astype("f4")
    ins = [_tb(p2).requires_grad_(), _tb(w2).requires_grad_(),
           torch.from_numpy(g).requires_grad_(), torch.from_numpy(b).requires_grad_()]
    y, _, _ = tcbr._TrainCore.apply(*ins, 1e-5)
    y.backward(_tb(dy))
    jy, vjp = jax.vjp(lambda *a: cbr._train_core(*a, 1e-5, True)[0], _jb(p2), _jb(w2),
                      jnp.asarray(g), jnp.asarray(b))
    want = vjp(_jb(dy))
    assert np.all(np.abs(_f32(y) - _f32(jy)) <= _ulp(_f32(jy)))
    for name, t, ref in zip(("dp2", "dw2"), ins, want):
        assert t.grad.dtype == torch.bfloat16, name
        share, ulps = _differing(_f32(t.grad), _f32(ref))
        assert share <= GRAD_DIFFERING and ulps <= 1.0, (name, share, ulps)
    for name, t, ref in zip(("dgamma", "dbeta"), ins[2:], want[2:]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


# -- the whole op -------------------------------------------------------------------

GEOMS = {"3x3_s2": (2, 3, 17, 8, 3, 2, 1), "1x1": (2, 16, 8, 32, 1, 1, 0),
         "3x3": (2, 8, 9, 16, 3, 1, 1)}


def _operands(geom, seed=0):
    n, c, h, co, k, s, p = geom
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, h, h).astype("f4")
    w = (rng.randn(co, c, k, k) * 0.3).astype("f4")
    g, b = (1 + 0.1 * rng.randn(co)).astype("f4"), (0.1 * rng.randn(co)).astype("f4")
    m, v = (0.1 * rng.randn(co)).astype("f4"), (1 + 0.1 * rng.rand(co)).astype("f4")
    oh = (h + 2 * p - k) // s + 1
    dy = rng.randn(n, co, oh, oh).astype("f4")
    return x, w, g, b, m, v, dy


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_op_bf16_gradients_match_jax_vjp_of_the_fused_kernels(geom, training):
    """The whole op on bf16 x and weight against ``jax.vjp`` of ``_fused(...,
    interpret=True, force=True)``: y, the running statistics, dw and dx.
    dw and dx are bit-equal (read: bit-equal). A KxK conv folds its
    patches' gradients back in float32 and rounds once, as XLA's patch VJP
    does (``_Unfold``); folding in bf16, as torch's CPU ``F.fold`` does,
    put dx up to 2 ulps of its largest entry off (51% of the entries of the
    3x3 case)."""
    n, c, h, co, k, s, p = GEOMS[geom]
    x, w, g, b, m, v, dy = _operands(GEOMS[geom])
    kw = dict(stride=s, padding=p, training=training, momentum=0.9, eps=1e-5,
              data_format="NCHW")
    jin = [_jb(x), _jb(w), jnp.asarray(g), jnp.asarray(b)]
    (jy, jm, jv), vjp = jax.vjp(lambda *a: cbr._fused(*a, jnp.asarray(m), jnp.asarray(v),
                                                      interpret=True, force=True, **kw), *jin)
    want = vjp((_jb(dy), jnp.zeros_like(jm), jnp.zeros_like(jv)))
    ts = [_tb(x).requires_grad_(), _tb(w).requires_grad_(), torch.from_numpy(g).requires_grad_(),
          torch.from_numpy(b).requires_grad_()]
    y, nm, nv = tcbr.conv_bn_relu(*ts, torch.from_numpy(m), torch.from_numpy(v), stride=s,
                                  padding=p, training=training, momentum=0.9, epsilon=1e-5)
    y.backward(_tb(dy))
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(y), _f32(jy))
    np.testing.assert_allclose(nm.numpy(), np.asarray(jm), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    dx, dw = _f32(ts[0].grad), _f32(ts[1].grad)
    jdx, jdw = _f32(want[0]), _f32(want[1])
    np.testing.assert_array_equal(dw, jdw)
    np.testing.assert_array_equal(dx, jdx)
    for t, ref in zip(ts[2:], want[2:]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("geom", ["3x3_s2", "3x3", "7x7_s2"])
def test_patch_gradient_folds_bf16_in_float32_as_xla(geom):
    """The lowering's patch gradient alone: ``dx`` of ``_as_matmul``'s p2
    against ``jax.vjp`` of the JAX package's ``_as_matmul``
    (``conv_general_dilated_patches``), whose VJP adds the overlapping
    patches in float32 and rounds once. Bit-equal; a fold that adds in bf16
    differs in most entries of a 3x3 conv."""
    n, c, h, k, s, p = {"3x3_s2": (2, 3, 17, 3, 2, 1), "3x3": (2, 8, 9, 3, 1, 1),
                        "7x7_s2": (1, 3, 20, 7, 2, 3)}[geom]
    rng = np.random.RandomState(5)
    x = rng.randn(n, c, h, h).astype("f4")
    w = np.zeros((4, c, k, k), "f4")
    pad = [(p, p), (p, p)]
    oh = (h + 2 * p - k) // s + 1
    dp = rng.randn(n * oh * oh, c * k * k).astype("f4")
    p2, vjp = jax.vjp(lambda a: cbr._as_matmul(a, _jb(w), s, pad, "NCHW")[0], _jb(x))
    want = _f32(vjp(_jb(dp))[0])
    tx = _tb(x).requires_grad_()
    tp2, _, _ = tcbr._as_matmul(tx, _tb(w), s, pad, "NCHW")
    tp2.backward(_tb(dp))
    np.testing.assert_array_equal(_f32(tp2), _f32(p2))
    assert tx.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(tx.grad), want)


# -- the K padding ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training", [True, False])
def test_k_padded_lowering_changes_nothing(dtype, training):
    """The stem's shape of conv (7x7, stride 2, padding 3, K = 3 * 49 = 147)
    lowered with K padded to 152 (zero columns of p2, zero rows of w2)
    against the unpadded lowering: the same y and the same gradients of x,
    weight, gamma and beta, bit for bit, in float32 and in bf16."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 20, 20).astype("f4")
    w = (rng.randn(8, 3, 7, 7) * 0.1).astype("f4")
    g, b = (rng.rand(8) + 0.5).astype("f4"), (rng.randn(8) * 0.1).astype("f4")
    m, v = (rng.randn(8) * 0.1).astype("f4"), (rng.rand(8) + 0.5).astype("f4")
    pad = [(3, 3), (3, 3)]
    dy = torch.from_numpy(rng.randn(2 * 10 * 10, 8).astype("f4")).to(dt)  # y2 [N * OH * OW, 8]
    answers = []
    for k_multiple in (1, 8):
        ins = [torch.from_numpy(x).to(dt).requires_grad_(),
               torch.from_numpy(w).to(dt).requires_grad_(),
               torch.from_numpy(g).requires_grad_(), torch.from_numpy(b).requires_grad_()]
        p2, w2, (n, oh, ow) = tcbr._as_matmul(ins[0], ins[1], 2, pad, "NCHW", k_multiple)
        assert p2.shape[1] == w2.shape[0] == (147 if k_multiple == 1 else 152)
        if training:
            y2, _, _ = tcbr._TrainCore.apply(p2, w2, ins[2], ins[3], 1e-5)
        else:
            y2 = tcbr._EvalCore.apply(p2, w2, ins[2], ins[3], torch.from_numpy(m),
                                      torch.from_numpy(v), 1e-5)
        y2.backward(dy)
        answers.append([y2.detach()] + [t.grad for t in ins])
    for a, b_ in zip(*answers):
        assert a.dtype == b_.dtype
        assert torch.equal(a, b_)


# -- the kernel route -----------------------------------------------------------------

_META = dict(device="meta", dtype=torch.bfloat16)


def _bf16_entry_calls():
    p2, w2 = torch.empty(8, 16, **_META), torch.empty(16, 6, **_META)
    co = torch.empty(8, 6, **_META)
    v = torch.empty(6, device="meta")
    return {
        "mm_affine_relu": lambda: tcbr.mm_affine_relu(p2, w2, v, v),
        "mm_stats": lambda: tcbr.mm_stats(p2, w2),
        "centered_sumsq": lambda: tcbr.centered_sumsq(co, v),
        "bn_relu": lambda: tcbr.bn_relu(co, v, v),
        "bn_bwd_partials": lambda: tcbr.bn_bwd_partials(co, co, v, v),
        "bn_bwd_dco": lambda: tcbr.bn_bwd_dco(co, co, v, v, v, v),
    }


@pytest.mark.parametrize("entry", list(_bf16_entry_calls()))
def test_bf16_non_cpu_tensor_never_takes_the_plain_version(entry):
    """bf16 off the CPU goes to the kernel path too, which refuses what is
    not on a CUDA device: no plain version, no unfused op."""
    with pytest.raises(ValueError, match="CUDA"):
        _bf16_entry_calls()[entry]()


def test_bf16_plain_versions_count_no_launch():
    names = [k for k in dir(tcbr) if k.endswith("_LAUNCHES")]
    assert sum(k.startswith("BF16_") for k in names) == 6
    before = {k: getattr(tcbr, k) for k in names}
    p2, w2, co, dy, vecs = _mats()
    s, b, k3, b0 = (torch.from_numpy(v) for v in vecs)
    p2, w2, co, dy = _tb(p2), _tb(w2), _tb(co), _tb(dy)
    tcbr.mm_affine_relu(p2, w2, s, b)
    tcbr.mm_stats(p2, w2)
    tcbr.centered_sumsq(co, s)
    tcbr.bn_relu(co, s, b)
    tcbr.bn_bwd_partials(co, dy, s, b)
    tcbr.bn_bwd_dco(co, dy, s, b, k3, b0)
    assert {k: getattr(tcbr, k) for k in names} == before


def test_bf16_op_pads_k_to_a_multiple_of_8_for_the_kernel(monkeypatch):
    """Under AMP the stem's conv (K = 3 * 7 * 7 = 147) reaches the training
    core with K = 152: its bf16 rows then start on 16-byte boundaries, as
    the bf16 GEMM copies them; float32 is not padded."""
    seen = []
    real = tcbr._TrainCore.apply

    def spy(p2, w2, *rest):
        seen.append((p2.dtype, p2.shape[1], w2.shape[0]))
        return real(p2, w2, *rest)

    rng = np.random.RandomState(0)
    x = rng.randn(1, 3, 16, 16).astype("f4")
    w = (rng.randn(8, 3, 7, 7) * 0.1).astype("f4")
    vecs = [torch.ones(8), torch.zeros(8), torch.zeros(8), torch.ones(8)]
    monkeypatch.setattr(tcbr._TrainCore, "apply", spy)
    for dt in (torch.float32, torch.bfloat16):
        tcbr.conv_bn_relu(torch.from_numpy(x).to(dt), torch.from_numpy(w).to(dt), *vecs,
                          stride=2, padding=3, training=True)
    assert seen == [(torch.float32, 147, 147), (torch.bfloat16, 152, 152)]
