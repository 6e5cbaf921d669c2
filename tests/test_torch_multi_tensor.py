"""Port parity: the multi-tensor momentum entry and the arithmetic of the
tensor-core attention backward.

``fused_momentum_update_multi`` updates many tensors in one launch on the
card; on the CPU it runs the plain update per tensor, which must equal the
JAX package's ``_jnp_update`` bit for bit. Its grouping of tensors into
launches is plain Python and is tested as a function.

The attention backward kernels compute their five products on the tensor
cores in 3xTF32: each f32 operand is split into ``hi = tf32(x)`` and
``lo = tf32(x - hi)`` (``cvt.rna.tf32.f32``: round to nearest, ties away
from zero, to 10 mantissa bits) and a product is ``hi*hi + hi*lo + lo*hi``
accumulated in f32. The emulation below computes the backward with that
arithmetic on the CPU and shows that it stays within the kernels' limit
(``FLASH_ATOL`` of ``chip_smoke.py``) of float64, where single TF32 does not.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.ops.pallas import optimizer_update as _  # noqa: E402,F401
from paddle_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.ops.cuda import optimizer_update as tou  # noqa: E402

ou = sys.modules["paddle_tpu.ops.pallas.optimizer_update"]
torch.set_num_threads(1)

SHAPES = [(1,), (3,), (7,), (130,), (1000, 130)]
VARIANTS = [(False, 0.0), (False, 0.01), (True, 0.0), (True, 0.01)]


def _tensors(shapes, seed):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s).astype("f4") for s in shapes] for _ in range(3)]


@pytest.mark.parametrize("nesterov,wd", VARIANTS)
def test_multi_entry_equals_jax_update_per_tensor(nesterov, wd):
    """Mixed sizes in one call, in place, bit-equal to ``_jnp_update``; no
    launch or tensor is counted on the CPU."""
    ps, gs, vs = _tensors(SHAPES, seed=1)
    tp, tg, tv = ([torch.from_numpy(a.copy()) for a in arrs] for arrs in (ps, gs, vs))
    before = (tou.LAUNCHES, tou.TENSORS)
    assert tou.fused_momentum_update_multi(tp, tg, tv, 0.1, 0.9, wd, nesterov) is None
    assert (tou.LAUNCHES, tou.TENSORS) == before
    for p, g, v, got_p, got_v in zip(ps, gs, vs, tp, tv):
        want_p, want_v = ou._jnp_update(*map(jnp.asarray, (p, g, v)), 0.1, 0.9, wd, nesterov)
        assert np.array_equal(got_p.numpy(), np.asarray(want_p))
        assert np.array_equal(got_v.numpy(), np.asarray(want_v))


def test_multi_entry_skips_empty_tensors():
    ps, gs, vs = _tensors([(0,), (5,), (0, 3)], seed=2)
    tp, tg, tv = ([torch.from_numpy(a.copy()) for a in arrs] for arrs in (ps, gs, vs))
    tou.fused_momentum_update_multi(tp, tg, tv, 0.1)
    want_p, want_v = tou._plain_update(*(torch.from_numpy(a[1]) for a in (ps, gs, vs)), 0.1, 0.9,
                                       0.0, False)
    assert torch.equal(tp[1], want_p) and torch.equal(tv[1], want_v)
    assert tp[0].numel() == 0 and tp[2].shape == (0, 3)


def test_multi_entry_on_meta_tensors_raises():
    t = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tou.fused_momentum_update_multi([t, t], [t, t], [t, t], 0.1)
    # a CPU tensor among others is no reason to take the plain version
    c = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        tou.fused_momentum_update_multi([c, t], [c, t], [c, t], 0.1)


def test_multi_entry_mismatched_shapes_and_lengths_raise():
    a, b = torch.zeros(4), torch.zeros(3)
    with pytest.raises(ValueError, match="differ"):
        tou.fused_momentum_update_multi([a, a], [a, b], [a, a], 0.1)
    with pytest.raises(ValueError, match="grads"):
        tou.fused_momentum_update_multi([a, a], [a], [a, a], 0.1)


@pytest.mark.parametrize("numels,max_tensors,chunk", [
    ([1, 3, 7, 130, 130000], 110, 8192),
    ([5] * 161, 110, 8192),
    ([8192, 8193, 1, 16384, 3], 2, 8192),
    ([17] * 7, 3, 4),
    ([2**20], 110, 8192),
])
def test_launch_groups(numels, max_tensors, chunk):
    """Order kept, each tensor in exactly one group, at most
    ``max_tensors`` a group, prefix sums of ``ceil(n / chunk)`` from 0."""
    groups = tou.launch_groups(numels, max_tensors, chunk)
    flat = [i for idx, _ in groups for i in idx]
    assert flat == list(range(len(numels)))
    assert len(groups) == -(-len(numels) // max_tensors)
    for idx, starts in groups:
        assert 1 <= len(idx) <= max_tensors and len(starts) == len(idx) + 1
        assert starts[0] == 0
        assert [b - a for a, b in zip(starts, starts[1:])] == [
            -(-numels[i] // chunk) for i in idx]


def test_launch_groups_for_resnet50_take_two_launches():
    from paddle_tpu_torch.models import resnet50

    numels = [p.numel() for p in resnet50(num_classes=1000).parameters()]
    groups = tou.launch_groups(numels)
    assert len(numels) == 161 and [len(i) for i, _ in groups] == [tou.MAX_TENSORS, 51]
    assert sum(s[-1] for _, s in groups) == sum(-(-n // tou.CHUNK) for n in numels)


def test_launch_groups_refuse_empty_tensors():
    with pytest.raises(ValueError, match="elements"):
        tou.launch_groups([3, 0])


# -- the attention backward in 3xTF32 ----------------------------------------------

FLASH_ATOL = 5e-5  # chip_smoke.py's limit for the kernels against the plain version


def tf32_rna(x):
    """``cvt.rna.tf32.f32`` on a float32 tensor: keep 10 mantissa bits,
    rounding to nearest with ties away from zero (add half of the dropped
    13 bits' range to the magnitude, then clear them)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32(a, b, passes):
    """``a @ b`` of float32 tensors with f32 accumulation as the tensor
    cores compute it: ``passes`` 1 is single TF32 (``hi*hi``), 3 is 3xTF32
    (``hi*hi + hi*lo + lo*hi``, the ``lo*lo`` term dropped)."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    out = ah @ bh
    if passes == 3:
        al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
        out = out + (ah @ bl + al @ bh)
    return out


def _bwd_emulated(q, k, v, bias, do, causal, scale, passes):
    """dq, dk, dv as the kernels compute them, every product through
    :func:`mm_tf32`: S = q k^T, dP = dO v^T, dV = P^T dO, dK = dS^T q,
    dQ = dS k, the softmax and dS elementwise in f32."""
    lq, lk = q.shape[-2], k.shape[-2]
    s = mm_tf32(q, k.transpose(-1, -2), passes) * scale + bias
    if causal:
        keep = torch.arange(lq)[:, None] + (lk - lq) >= torch.arange(lk)[None, :]
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = mm_tf32(p, v, passes)
    delta = (do * out).sum(-1, keepdim=True)
    dp = mm_tf32(do, v.transpose(-1, -2), passes)
    ds = p * (dp - delta)
    dv = mm_tf32(p.transpose(-1, -2), do, passes)
    dk = mm_tf32(ds.transpose(-1, -2), q, passes) * scale
    dq = mm_tf32(ds, k, passes) * scale
    return dq, dk, dv


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23, -(1.0 + ulp / 2),
                      1.0 + ulp * 0.75, 3.0, 0.0])
    assert tf32_rna(x).tolist() == [1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + ulp, 3.0, 0.0]
    assert float(tf32_rna(one)) == 1.0


def test_3xtf32_attention_backward_stays_within_the_limit_and_tf32_does_not():
    """[2, 2, 128, 64], a pad bias, causal, rate 0: the 3xTF32 backward is
    within ``FLASH_ATOL`` of float64, single TF32 is not."""
    rng = np.random.RandomState(21)
    b, h, l, d = 2, 2, 128, 64
    q, k, v, do = (rng.randn(b, h, l, d).astype("f4") for _ in range(4))
    lens = rng.randint(l // 2, l + 1, size=b)
    bias = ((1.0 - (np.arange(l)[None, :] < lens[:, None])) * -1e4).astype("f4")[:, None, None]
    scale = d ** -0.5
    with torch.enable_grad():
        q64, k64, v64 = (torch.from_numpy(a).double().requires_grad_() for a in (q, k, v))
        o = tfa._plain_attention(q64, k64, v64, torch.from_numpy(bias).double(), True, scale)
        want = torch.autograd.grad(o, (q64, k64, v64), torch.from_numpy(do).double())
    args = [torch.from_numpy(a) for a in (q, k, v, bias, do)]
    errs = {}
    for passes in (3, 1):
        got = _bwd_emulated(*args[:4], args[4], True, scale, passes)
        errs[passes] = max(float((g.double() - w).abs().max()) for g, w in zip(got, want))
    assert errs[3] <= FLASH_ATOL, errs
    assert errs[1] > FLASH_ATOL, errs
