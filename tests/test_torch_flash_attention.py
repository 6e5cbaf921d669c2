"""Port parity: flash attention (``paddle_tpu_torch.ops.cuda.flash_attention``).

On the CPU the port's wrapper runs its plain version; it is held against
the JAX package's ``flash_attention`` (its plain path off-TPU), forward
and ``jax.vjp`` backward, with the same numpy inputs. The dropout mask is
Philox4x32-10 keyed by the seed and the coordinates; the JAX package draws
its own, so dropout is held against the mask's definition instead. The
CUDA kernels are held against the plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_flash  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402

torch.set_num_threads(1)

ATOL = 2e-5  # f32 sums in another order than XLA's


def _qkv(b, h, l, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, l, d).astype("f4") for _ in range(3)]


def _bias(kind, b, h, l, seed):
    rng = np.random.RandomState(seed + 100)
    if kind == "none":
        return None
    if kind == "pad":  # BERT's additive key mask, [B, 1, 1, L]
        lens = rng.randint(l // 2, l + 1, size=b)
        keep = np.arange(l)[None, :] < lens[:, None]
        return ((1.0 - keep) * -1e4).astype("f4")[:, None, None, :]
    return rng.randn(b, h, l, l).astype("f4")  # a full [B, H, L, L] bias


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("l", [16, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", ["pad", "full"])
def test_plain_matches_jax_flash_attention(bias_kind, causal, l, d):
    b, h = 2, 3
    q, k, v = _qkv(b, h, l, d, seed=l + d)
    bias = _bias(bias_kind, b, h, l, seed=l)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              bias=None if bias is None else torch.from_numpy(bias),
                              causal=causal)
    ref = jax_flash(q, k, v, bias=bias, causal=causal)
    assert out.shape == (b, h, l, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_plain_matches_jax_without_bias_and_with_explicit_scale():
    q, k, v = _qkv(2, 2, 16, 32, seed=5)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.3)
    ref = jax_flash(q, k, v, scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_cpu_dropout_is_not_ported_yet():
    """Attention dropout now runs on the CPU too, from the same mask the
    card's kernels regenerate: the same generator seed gives the same
    output, another seed another one, and rate 0 none at all."""
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 64, 32, seed=7))
    run = lambda s, rate=0.5: tfa.flash_attention(  # noqa: E731
        q, k, v, dropout_rate=rate, generator=torch.Generator().manual_seed(s))
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, 0.0), tfa.flash_attention(q, k, v))
    assert torch.isfinite(run(1)).all()


@pytest.mark.parametrize("shape", [(0, 2, 16, 32), (1, 2, 0, 32)])
def test_kernel_entry_counts_no_launch_without_query_rows(shape):
    q = torch.empty(shape, device="meta")
    kv = torch.empty(shape[0], shape[1], 16, shape[3], device="meta")
    before = tfa.LAUNCHES
    out, lse = tfa.flash_attention_fwd(q, kv, kv)
    assert tfa.LAUNCHES == before
    assert out.shape == shape and lse.shape == (shape[0] * shape[1], shape[2])


def test_kernel_entry_refuses_cpu_tensors():
    """``flash_attention_fwd`` is the kernel's entry: it never runs the
    plain version."""
    q, k, v = map(torch.from_numpy, _qkv(1, 1, 16, 32, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k, v)


def test_non_cpu_tensor_never_takes_the_plain_version():
    q = torch.empty(1, 2, 16, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    stat = torch.empty(2, 16, device="meta")
    for entry in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            entry(q, q, q, None, stat, stat, q)


def test_mismatched_shapes_raise():
    q = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, torch.zeros(1, 2, 16, 64), torch.zeros(1, 2, 16, 64))


# -- backward, dropout and the autograd wiring --------------------------------


def _port_grads(q, k, v, bias, do, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(kw.pop("bias_grad",
                                                                              False))
    out = tfa.flash_attention(*ts, bias=tb, **kw)
    out.backward(torch.from_numpy(do))
    return out, [t.grad for t in ts] + [None if tb is None else tb.grad]


@pytest.mark.parametrize("lq,lk", [(24, 24), (24, 40), (40, 24)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", ["none", "pad"])
def test_plain_backward_matches_jax_vjp(bias_kind, causal, lq, lk):
    """dq, dk, dv of the port (autograd through the plain version) ==
    ``jax.vjp`` of the JAX ``flash_attention``, with a pad bias, causal
    (bottom-right aligned, so Lq > Lk has rows that see no key) and
    Lq != Lk."""
    import jax

    b, h, d = 2, 3, 32
    rng = np.random.RandomState(lq + lk)
    q = rng.randn(b, h, lq, d).astype("f4")
    k, v = (rng.randn(b, h, lk, d).astype("f4") for _ in range(2))
    do = rng.randn(b, h, lq, d).astype("f4")
    bias = _bias(bias_kind, b, h, lk, seed=lk)
    _, grads = _port_grads(q, k, v, bias, do, causal=causal)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, bias=bias, causal=causal), q, k, v)
    for got, want in zip(grads[:3], vjp(do)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_trainable_bias_gradient_matches_jax_at_rate_0():
    import jax

    q, k, v = _qkv(2, 3, 24, 32, seed=12)
    bias = np.random.RandomState(13).randn(2, 3, 24, 24).astype("f4")
    do = np.random.RandomState(14).randn(2, 3, 24, 32).astype("f4")
    _, grads = _port_grads(q, k, v, bias, do, bias_grad=True)
    _, vjp = jax.vjp(lambda b: jax_flash(q, k, v, bias=b), bias)
    np.testing.assert_allclose(grads[3].numpy(), np.asarray(vjp(do)[0]), atol=ATOL, rtol=0)


def test_trainable_bias_with_dropout_raises():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 16, 32, seed=0))
    bias = torch.zeros(1, 1, 1, 16, requires_grad=True)
    with pytest.raises(ValueError, match="trainable bias"):
        tfa.flash_attention(q, k, v, bias=bias, dropout_rate=0.1)


# Random123's known-answer vectors for Philox4x32-10 (counter, key -> words)
_PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", _PHILOX_KAT)
def test_philox_matches_known_answers(counter, key, want):
    got = tfa.philox4x32_10(*(torch.tensor(c, dtype=torch.int64) for c in counter),
                            *(torch.tensor(x, dtype=torch.int64) for x in key))
    assert tuple(int(w) for w in got) == want


def test_dropout_mask_is_a_function_of_seed_and_coordinates():
    """One mask whatever the shape it is cut from: keyed by (seed, b*H+h,
    query row, key column), a smaller Lq/Lk is a corner of a larger one,
    as each kernel regenerates it tile by tile; another seed gives
    another mask."""
    seed = torch.tensor([11, -5], dtype=torch.int32)
    big = tfa.dropout_keep_mask(seed, 2, 3, 40, 70, 0.3)
    assert torch.equal(tfa.dropout_keep_mask(seed, 2, 3, 40, 70, 0.3), big)
    assert torch.equal(tfa.dropout_keep_mask(seed, 2, 3, 17, 33, 0.3), big[:, :, :17, :33])
    other = tfa.dropout_keep_mask(torch.tensor([12, -5], dtype=torch.int32), 2, 3, 40, 70, 0.3)
    assert not torch.equal(other, big)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_kept_fraction_is_within_4_sigma(rate):
    n = 4 * 6 * 128 * 128
    keep = tfa.dropout_keep_mask(torch.tensor([3, 4], dtype=torch.int32), 4, 6, 128, 128, rate)
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(keep.float().mean()) - (1 - rate)) <= 4 * sigma


def test_dropout_forward_and_backward_use_one_mask():
    """The output is the softmax with the seed's mask applied (kept entries
    scaled by 1/(1-rate)), and the gradients are those of that same
    masked function."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_() for a in _qkv(2, 2, 24, 32, 15))
    rate, gen_seed = 0.2, 9
    out = tfa.flash_attention(q, k, v, dropout_rate=rate,
                              generator=torch.Generator().manual_seed(gen_seed))
    seed = tfa._draw_seed(torch.Generator().manual_seed(gen_seed), "cpu")
    keep = tfa.dropout_keep_mask(seed, 2, 2, 24, 24, rate)
    w = torch.softmax(q @ k.transpose(-1, -2) * 32 ** -0.5, dim=-1)
    want = torch.where(keep, w / (1 - rate), torch.zeros_like(w)) @ v
    torch.testing.assert_close(out, want, atol=1e-12, rtol=1e-10)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = torch.autograd.grad(want, (q, k, v), g)
    for a, b_ in zip(got, ref):
        torch.testing.assert_close(a, b_, atol=1e-12, rtol=1e-10)


def test_gradcheck_f64_with_dropout():
    q, k, v = (torch.from_numpy(a[:, :, :6, :8]).double().requires_grad_()
               for a in _qkv(1, 2, 6, 32, 16))
    bias = torch.zeros(1, 1, 1, 6, dtype=torch.float64)
    bias[..., 4:] = -1e4
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, bias=bias, dropout_rate=0.1,
                                            generator=torch.Generator().manual_seed(2)),
        (q, k, v))


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("causal", [False, True])
def test_function_routes_through_the_kernel_entries(monkeypatch, rate, causal):
    """The autograd wiring the card takes: with the kernel entries standing
    in for the kernels (their plain versions), the Function's forward and
    backward give the plain route's output and gradients, the bias's at
    rate 0 included."""
    q, k, v = _qkv(2, 3, 20, 32, seed=17)
    do = np.random.RandomState(18).randn(2, 3, 20, 32).astype("f4")
    bias = _bias("pad", 2, 3, 20, seed=19)
    kw = dict(causal=causal, dropout_rate=rate, bias_grad=rate == 0.0)
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    want_out, want = _port_grads(q, k, v, bias, do, generator=gen(), **kw)
    calls = []

    def entry(name, fn):
        return lambda *a: calls.append(name) or fn(*a)

    plain_bwd = tfa._plain_bwd
    monkeypatch.setattr(tfa, "_use_kernel", lambda q: True)
    monkeypatch.setattr(tfa, "flash_attention_fwd", entry("fwd", tfa._plain_fwd))
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq", entry(
        "dq", lambda q, k, v, b, lse, delta, do, *a: plain_bwd(q, k, v, b, None, lse, do,
                                                              *a)[0]))
    monkeypatch.setattr(tfa, "flash_attention_bwd_dkv", entry(
        "dkv", lambda q, k, v, b, lse, delta, do, *a: plain_bwd(q, k, v, b, None, lse, do,
                                                               *a)[1:]))
    out, got = _port_grads(q, k, v, bias, do, generator=gen(), **kw)
    assert calls == ["fwd", "dq", "dkv"]
    np.testing.assert_allclose(out.detach().numpy(), want_out.detach().numpy(), atol=1e-6)
    for a, b_ in zip(got, want):
        if b_ is None:
            assert a is None
        else:
            np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5)
