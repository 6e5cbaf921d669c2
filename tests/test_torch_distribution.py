"""The port's distributions (``paddle_tpu_torch/distribution.py``) against the
JAX package's (``paddle_tpu/distribution.py``): ``log_prob``, ``entropy``,
``probs`` and KL divergence within 1e-6 (relative) of the JAX values on the
same numpy parameters and values; samples drawn from an explicit
``torch.Generator`` are reproducible and have the right moments (within 5
standard errors); Normal and Uniform samples are differentiable in their
parameters."""
import numpy as np
import pytest
import torch

import paddle_tpu.distribution as jd
from paddle_tpu_torch import distribution as td

RTOL = 1e-6
RNG = np.random.RandomState(0)
LOC = RNG.randn(3, 4).astype(np.float32)
SCALE = (RNG.rand(3, 4) + 0.5).astype(np.float32)
LOC2 = RNG.randn(3, 4).astype(np.float32)
SCALE2 = (RNG.rand(3, 4) + 0.5).astype(np.float32)
VALUE = RNG.randn(3, 4).astype(np.float32)
LOGITS = RNG.randn(3, 5).astype(np.float32)
LOGITS2 = RNG.randn(3, 5).astype(np.float32)
PROBS = RNG.rand(3, 4).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.numpy()), rtol=RTOL,
                               atol=atol)


CASES = {
    "normal": (lambda m: m.Normal(*map(_conv(m), (LOC, SCALE))),
               lambda m: m.Normal(*map(_conv(m), (LOC2, SCALE2))), VALUE),
    "uniform": (lambda m: m.Uniform(*map(_conv(m), (LOC - SCALE, LOC + SCALE))),
                lambda m: m.Uniform(*map(_conv(m), (LOC - 2 * SCALE, LOC + 2 * SCALE))),
                LOC + 0.5 * SCALE * np.sign(VALUE)),
    "categorical": (lambda m: m.Categorical(_conv(m)(LOGITS)),
                    lambda m: m.Categorical(_conv(m)(LOGITS2)),
                    np.array([0, 3, 4], np.int64)),
    "mvn_diag": (lambda m: m.MultivariateNormalDiag(*map(_conv(m), (LOC, SCALE))),
                 lambda m: m.MultivariateNormalDiag(*map(_conv(m), (LOC2, SCALE2))), VALUE),
    "bernoulli": (lambda m: m.Bernoulli(_conv(m)(PROBS)), None,
                  (VALUE > 0).astype(np.float32)),
}


def _conv(m):
    if m is td:
        return _t
    import paddle_tpu as paddle

    return lambda a: paddle.to_tensor(np.asarray(a))


def _value(m, v):
    return _conv(m)(v)


@pytest.mark.parametrize("name", sorted(CASES))
def test_log_prob_entropy_and_kl_equal_the_jax_ones(name):
    make, make_other, value = CASES[name]
    mine, theirs = make(td), make(jd)
    _close(mine.log_prob(_value(td, value)), theirs.log_prob(_value(jd, value)))
    _close(mine.probs(_value(td, value)), theirs.probs(_value(jd, value)))
    _close(mine.entropy(), theirs.entropy())
    if make_other is not None:
        _close(td.kl_divergence(mine, make_other(td)), jd.kl_divergence(theirs, make_other(jd)),
               atol=1e-7)
        _close(mine.kl_divergence(mine), theirs.kl_divergence(theirs), atol=1e-7)


def test_uniform_outside_its_support_is_minus_infinity():
    u = td.Uniform(_t(1.0), _t(3.0))
    assert np.isneginf(float(u.log_prob(_t(5.0))))
    assert np.isneginf(float(u.log_prob(_t(3.0))))  # the upper end is open


def test_kl_between_families_refuses():
    with pytest.raises(TypeError):
        td.kl_divergence(td.Normal(_t(0.0), _t(1.0)), td.Uniform(_t(0.0), _t(1.0)))


N = 200_000


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _within(mean, want, sd, n=N):
    assert abs(mean - want) < 5 * sd / np.sqrt(n), (mean, want)


def test_normal_samples_moments_and_reproducibility():
    n = td.Normal(_t(np.float32(3.0)), _t(np.float32(0.5)))
    s = n.sample([N], generator=_gen(0)).numpy()
    assert s.shape == (N,) and s.dtype == np.float32
    _within(s.mean(), 3.0, 0.5)
    # the variance's standard error: sd^2 * sqrt(2 / n)
    assert abs(s.var() - 0.25) < 5 * 0.25 * np.sqrt(2.0 / N)
    np.testing.assert_array_equal(n.sample([8], generator=_gen(7)).numpy(),
                                  n.sample([8], generator=_gen(7)).numpy())


def test_categorical_sample_frequencies():
    p = np.array([0.2, 0.3, 0.5])
    c = td.Categorical(_t(np.log(p).astype(np.float32)))
    s = c.sample([N], generator=_gen(2)).numpy()
    assert s.dtype == np.int64 and s.shape == (N,)
    freq = np.bincount(s, minlength=3) / N
    for f, q in zip(freq, p):
        _within(f, q, np.sqrt(q * (1 - q)))
    batched = td.Categorical(_t(LOGITS)).sample([4], generator=_gen(3))
    assert tuple(batched.shape) == (4, 3)


def test_uniform_bernoulli_and_mvn_samples():
    u = td.Uniform(_t(np.float32(1.0)), _t(np.float32(3.0))).sample([N], generator=_gen(1))
    u = u.numpy()
    assert u.min() >= 1.0 and u.max() < 3.0
    _within(u.mean(), 2.0, 2.0 / np.sqrt(12.0))
    b = td.Bernoulli(_t(np.float32(0.3))).sample([N], generator=_gen(4)).numpy()
    assert set(np.unique(b)) == {0.0, 1.0}
    _within(b.mean(), 0.3, np.sqrt(0.21))
    m = td.MultivariateNormalDiag(_t(LOC[0]), _t(SCALE[0])).sample([N], generator=_gen(5))
    m = m.numpy()
    assert m.shape == (N, 4)
    for j in range(4):
        _within(m[:, j].mean(), LOC[0, j], SCALE[0, j])


def test_reparameterized_samples_carry_gradients():
    loc = _t(np.float32(1.0)).requires_grad_()
    scale = _t(np.float32(2.0)).requires_grad_()
    s = td.Normal(loc, scale).sample([1000], generator=_gen(6))
    s.sum().backward()
    assert float(loc.grad) == 1000.0
    eps = (s.detach() - 1.0) / 2.0
    np.testing.assert_allclose(float(scale.grad), float(eps.sum()), rtol=1e-5)
