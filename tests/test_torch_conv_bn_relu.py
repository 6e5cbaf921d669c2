"""Port parity: fused conv + batch_norm + relu (``paddle_tpu_torch.ops.cuda.conv_bn_relu``).

On the CPU the port's entries run their plain versions; each is held
against the JAX package's Pallas kernel run in interpret mode on the same
numpy inputs, and the whole op (forward, running statistics, gradients)
against ``conv_bn_relu._fused(..., interpret=True, force=True)``. The
CUDA kernels themselves are held against the plain versions on the card
by ``chip_smoke.py``.
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

# f32 products and sums of a few dozen terms, taken in other orders
TOL = dict(rtol=1e-5, atol=1e-5)
# M, K and N all ragged against the TPU kernel's 256 x 128 tiles
M, K, N = 300, 27, 10


def _mats(seed=0):
    rng = np.random.RandomState(seed)
    p2 = rng.randn(M, K).astype("f4")
    w2 = (rng.randn(K, N) * 0.3).astype("f4")
    co = (rng.randn(M, N) + rng.randn(1, N)).astype("f4")
    dy = rng.randn(M, N).astype("f4")
    vecs = [(rng.randn(N) * s).astype("f4") for s in (1.0, 0.5, 0.1, 0.1)]
    return p2, w2, co, dy, vecs


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_mm_affine_relu_plain_matches_interpret_kernel():
    p2, w2, _, _, (scale, shift, _, _) = _mats()
    got = tcbr.mm_affine_relu(*_t(p2, w2, scale, shift))
    want = cbr._mm_affine_relu(*_j(p2, w2, scale, shift), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mm_stats_plain_matches_interpret_kernel():
    """co and the channel sums; the TPU kernel's co comes back padded to
    its tiles, the port's at [M, N]."""
    p2, w2, *_ = _mats(1)
    co, partial = tcbr.mm_stats(*_t(p2, w2))
    want_co, want_sum = cbr._mm_stats(*_j(p2, w2), interpret=True)
    np.testing.assert_allclose(co.numpy(), np.asarray(want_co)[:M, :N], **TOL)
    np.testing.assert_allclose(partial.sum(0).numpy(), np.asarray(want_sum), rtol=1e-5,
                               atol=1e-4)  # 300 terms of O(3)


def test_centered_sumsq_plain_matches_interpret_kernel():
    _, _, co, _, _ = _mats(2)
    mean = co.mean(0)
    got = tcbr.centered_sumsq(*_t(co, mean)).sum(0)
    want = cbr._centered_sumsq(*_j(co, mean), M, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_bn_relu_plain_matches_interpret_kernel():
    _, _, co, _, (scale, shift, _, _) = _mats(3)
    got = tcbr.bn_relu(*_t(co, scale, shift))
    want = cbr._bn_relu(*_j(co, scale, shift), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bn_bwd_partials_plain_matches_interpret_kernel():
    _, _, co, dy, (scale, shift, _, _) = _mats(4)
    pdy, pdyc = tcbr.bn_bwd_partials(*_t(co, dy, scale, shift))
    want_dy, want_dyc = cbr._bn_bwd_partials(*_j(co, dy, scale, shift), interpret=True)
    np.testing.assert_allclose(pdy.sum(0).numpy(), np.asarray(want_dy), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pdyc.sum(0).numpy(), np.asarray(want_dyc), rtol=1e-5, atol=1e-4)


def test_bn_bwd_dco_plain_matches_interpret_kernel():
    _, _, co, dy, (scale, shift, k3, b0) = _mats(5)
    got = tcbr.bn_bwd_dco(*_t(co, dy, scale, shift, k3, b0))
    want = cbr._bn_bwd_dco(*_j(co, dy, scale, shift, k3, b0), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the whole op --------------------------------------------------------------


def _operands(cin=3, cout=8, kh=3, df="NCHW", seed=0, n=2, h=10):
    """``tests/test_fused_kernels.py`` ``_cbr_operands`` as numpy arrays."""
    rng = np.random.RandomState(seed)
    shape = (n, cin, h, h) if df == "NCHW" else (n, h, h, cin)
    x = rng.randn(*shape).astype("f4")
    w = (rng.randn(cout, cin, kh, kh) * 0.2).astype("f4")
    gamma = (rng.rand(cout) + 0.5).astype("f4")
    beta = (rng.randn(cout) * 0.1).astype("f4")
    mean = (rng.randn(cout) * 0.1).astype("f4")
    var = (rng.rand(cout) + 0.5).astype("f4")
    return x, w, gamma, beta, mean, var


def _port(x, w, gamma, beta, mean, var, **kw):
    eps = kw.pop("eps")
    y, nm, nv = tcbr.conv_bn_relu(*_t(x, w, gamma, beta, mean, var), epsilon=eps, **kw)
    return y.detach().numpy(), nm.numpy(), nv.numpy()


def _jax(x, w, gamma, beta, mean, var, **kw):
    y, nm, nv = cbr._fused(*_j(x, w, gamma, beta, mean, var), interpret=True, force=True, **kw)
    return np.asarray(y), np.asarray(nm), np.asarray(nv)


CASES = {
    # the four cases of tests/test_fused_kernels.py:296-301
    "3x3_s2_train": dict(kh=3, stride=2, padding=1, df="NCHW", training=True),
    "1x1_train": dict(kh=1, stride=1, padding=0, df="NCHW", training=True),
    "3x3_nhwc_eval": dict(kh=3, stride=1, padding=1, df="NHWC", training=False),
    "3x3_eval": dict(kh=3, stride=1, padding=1, df="NCHW", training=False),
    # asymmetric [top, bottom, left, right] padding: F.pad before F.unfold
    "3x3_s2_asym_train": dict(kh=3, stride=2, padding=[0, 1, 1, 0], df="NCHW", training=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_op_matches_jax_fused(name):
    """Output and running statistics of the whole op (lowering, the six
    entries, the blend) against the JAX package's fused op."""
    case = CASES[name]
    ops = _operands(kh=case["kh"], df=case["df"])
    kw = dict(stride=case["stride"], padding=case["padding"], training=case["training"],
              momentum=0.9, eps=1e-5, data_format=case["df"])
    for got, want in zip(_port(*ops, **kw), _jax(*ops, **kw)):
        np.testing.assert_allclose(got, want, **TOL)


def test_ragged_rows_match_jax_fused():
    """2x17x17 = 578 rows: three TPU tiles with a ragged tail."""
    ops = _operands(kh=3, seed=3, n=2, h=17)
    kw = dict(stride=1, padding=1, training=True, momentum=0.9, eps=1e-5, data_format="NCHW")
    for got, want in zip(_port(*ops, **kw), _jax(*ops, **kw)):
        np.testing.assert_allclose(got, want, **TOL)


def test_large_mean_variance_is_stable():
    """Channels at mean ~100, std ~0.1 (tests/test_fused_kernels.py:322):
    the centred two-pass variance keeps them; E[x^2] - mean^2 would lose
    the variance to f32 cancellation. Both packages' co here is exact (a
    1x1 conv with weight 1), so the normalized outputs, O(1), agree to the
    f32 rounding of mean and variance amplified by 1/std = 10."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 1, 12, 12) * 0.1 + 100.0).astype("f4")
    ops = (x, np.ones((8, 1, 1, 1), "f4"), np.ones(8, "f4"), np.zeros(8, "f4"),
           np.zeros(8, "f4"), np.ones(8, "f4"))
    kw = dict(stride=1, padding=0, training=True, momentum=0.9, eps=1e-5, data_format="NCHW")
    (y, nm, nv), (jy, jm, jv) = _port(*ops, **kw), _jax(*ops, **kw)
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-3)
    np.testing.assert_allclose(nm, jm, rtol=1e-6)
    np.testing.assert_allclose(nv, jv, rtol=1e-4)
    # the biased batch variance itself, against float64
    want_var = 0.9 + 0.1 * x.astype("f8").var()
    np.testing.assert_allclose(nv, np.full(8, want_var), rtol=1e-5)


@pytest.mark.parametrize("training", [True, False])
def test_gradients_match_jax_grad(training):
    """dx, dw, dgamma, dbeta of ``sum(y * cos(y))`` against ``jax.grad`` of
    the JAX fused op (``tests/test_fused_kernels.py:349``): the training
    backward's two entries plus the matmul gradients and the fold, and the
    eval backward's plain recompute."""
    x, w, gamma, beta, mean, var = _operands(seed=1)
    kw = dict(stride=2, padding=1, training=training, momentum=0.9, eps=1e-5,
              data_format="NCHW")

    def jloss(x, w, g, b):
        y, _, _ = cbr._fused(x, w, g, b, jnp.asarray(mean), jnp.asarray(var), interpret=True,
                             force=True, **kw)
        return (y * jnp.cos(y)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*_j(x, w, gamma, beta))
    ins = [t.requires_grad_() for t in _t(x, w, gamma, beta)]
    y, _, _ = tcbr.conv_bn_relu(*ins, *_t(mean, var), stride=2, padding=1, epsilon=1e-5,
                                momentum=0.9, training=training, data_format="NCHW")
    (y * torch.cos(y)).sum().backward()
    for name, t, ref in zip(("dx", "dw", "dgamma", "dbeta"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=name)  # sums of a few hundred f32 terms


def test_string_padding_takes_the_unfused_sequence():
    """``"SAME"`` is not admitted to the fused path (``_norm_padding``):
    the op runs conv2d -> batch_norm -> relu and returns new statistics
    without touching the ones it was given."""
    ops = _t(*_operands(kh=3, seed=6))
    mean0 = ops[4].clone()
    y, nm, _ = tcbr.conv_bn_relu(*ops, stride=1, padding="SAME", training=True)
    y_ref, nm_ref, _ = tcbr.conv_bn_relu(*ops, stride=1, padding=1, training=True)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL)
    np.testing.assert_allclose(nm.numpy(), nm_ref.numpy(), **TOL)
    assert torch.equal(ops[4], mean0)


# -- the kernel route ----------------------------------------------------------

_META = dict(device="meta")


def _entry_calls():
    p2, w2 = torch.empty(8, 4, **_META), torch.empty(4, 6, **_META)
    co = torch.empty(8, 6, **_META)
    v = torch.empty(6, **_META)
    return {
        "mm_affine_relu": lambda: tcbr.mm_affine_relu(p2, w2, v, v),
        "mm_stats": lambda: tcbr.mm_stats(p2, w2),
        "centered_sumsq": lambda: tcbr.centered_sumsq(co, v),
        "bn_relu": lambda: tcbr.bn_relu(co, v, v),
        "bn_bwd_partials": lambda: tcbr.bn_bwd_partials(co, co, v, v),
        "bn_bwd_dco": lambda: tcbr.bn_bwd_dco(co, co, v, v, v, v),
    }


@pytest.mark.parametrize("entry", list(_entry_calls()))
def test_non_cpu_tensor_never_takes_the_plain_version(entry):
    """Only CPU tensors run a plain version: any other device goes to the
    kernel path, which refuses what is not on a CUDA device."""
    with pytest.raises(ValueError, match="CUDA"):
        _entry_calls()[entry]()


def test_plain_versions_count_no_launch():
    before = {k: getattr(tcbr, k) for k in dir(tcbr) if k.endswith("_LAUNCHES")}
    assert len(before) == 18  # six kernels, float32, bf16 and fp16 apart
    p2, w2, co, dy, s, b, k3, b0 = _t(*_mats()[:4], *_mats()[4])
    tcbr.mm_affine_relu(p2, w2, s, b)
    tcbr.mm_stats(p2, w2)
    tcbr.centered_sumsq(co, s)
    tcbr.bn_relu(co, s, b)
    tcbr.bn_bwd_partials(co, dy, s, b)
    tcbr.bn_bwd_dco(co, dy, s, b, k3, b0)
    assert {k: getattr(tcbr, k) for k in before} == before


@pytest.mark.parametrize("case", ["product", "shape", "vector"])
def test_bad_arguments_raise(case):
    p2, w2, co, dy, s, b, _, _ = _t(*_mats()[:4], *_mats()[4])
    with pytest.raises(ValueError):
        if case == "product":
            tcbr.mm_stats(p2, w2[:-1])
        elif case == "shape":
            tcbr.bn_bwd_partials(co, dy[:-1], s, b)
        else:
            tcbr.bn_relu(co, s[:-1], b)
