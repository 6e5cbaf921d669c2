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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

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


# -- bfloat16 (the AMP path) --------------------------------------------------------


def _bf16_ulp(ref):
    """One bf16 ulp of the largest entry of ``ref``."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _bf16_case(bias_kind, lq, lk, d, seed):
    b, h = 2, 3
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, lq, d).astype("f4")
    k, v = (rng.randn(b, h, lk, d).astype("f4") for _ in range(2))
    do = rng.randn(b, h, lq, d).astype("f4")
    if bias_kind == "pad":
        lens = rng.randint(lk // 2, lk + 1, size=b)
        keep = np.arange(lk)[None, :] < lens[:, None]
        bias = ((1.0 - keep) * -1e4).astype("f4")[:, None, None, :]
    else:
        bias = rng.randn(b, h, lq, lk).astype("f4")
    return q, k, v, bias, do


def _to_bf16(a):
    return torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("lq,lk,d", [(16, 16, 32), (128, 128, 64), (24, 40, 32), (40, 24, 32)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", ["pad", "full"])
def test_bf16_forward_and_backward_match_jax(bias_kind, causal, lq, lk, d):
    """bf16 q, k, v and bias (the mask in q's dtype, as under AMP) against
    the JAX package's ``flash_attention`` on the same bf16 arrays (its jnp
    path, ``_plain_attention``) and ``jax.vjp``: the output and the
    gradients come back bf16. Both round the probabilities to bf16 before
    P V and the output once; the autograd route through the plain version
    matches to 1 bf16 ulp of the largest entry (read: 0.25 forward, 0.5
    backward). The plain backward the kernels are held against on the card
    (``_plain_bwd``, dS rounded to bf16 before its products as the TPU
    kernels round it, where the vjp keeps it f32) matches to 3 ulps (read:
    2), and the plain forward to 1."""
    q, k, v, bias, do = _bf16_case(bias_kind, lq, lk, d, seed=lq + lk + d)
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, bias, do)]
    want, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, bias=j[3], causal=causal),
                        *j[:3])
    want = np.asarray(want.astype(jnp.float32))
    want_grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(j[4])]
    ts = [_to_bf16(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*ts, bias=_to_bf16(bias), causal=causal)
    out.backward(_to_bf16(do))
    assert out.dtype == torch.bfloat16 and all(t.grad.dtype == torch.bfloat16 for t in ts)

    def err(got, ref):
        return np.abs(got.detach().float().numpy() - ref).max() / _bf16_ulp(ref)

    assert err(out, want) <= 1
    for t, g in zip(ts, want_grads):
        assert err(t.grad, g) <= 1
    bq, bk, bv, bb, bdo = (_to_bf16(a) for a in (q, k, v, bias, do))
    pout, lse = tfa._plain_fwd(bq, bk, bv, bb, causal)
    assert pout.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert err(pout, want) <= 1
    for got, g in zip(tfa._plain_bwd(bq, bk, bv, bb, pout, lse, bdo, causal), want_grads):
        assert got.dtype == torch.bfloat16 and err(got, g) <= 3


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_bf16_function_routes_through_the_kernel_entries(monkeypatch, rate):
    """The card's autograd wiring on bf16 with the kernel entries standing
    in for the kernels (their plain versions): bf16 output and gradients;
    with dropout the forward returns a ``keep_words`` mask and both
    backward entries are handed that mask in place of the seed; the dQ
    entry is handed ``out`` (it computes delta itself, f32) and the dK/dV
    entry the delta it returned; and the plain backward's values."""
    q, k, v, bias, do = _bf16_case("pad", 20, 20, 32, seed=21)
    calls, keeps, deltas, seeds = [], [], [], []
    plain_bwd = tfa._plain_bwd

    def fwd_entry(q, k, v, b, causal, scale, rate, seed):
        calls.append("fwd")
        seeds.append(seed)
        out = tfa._plain_fwd(q, k, v, b, causal, scale, rate, seed)
        if not rate:
            return out
        keeps.append(tfa.keep_words(q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.device))
        return (*out, keeps[-1])

    def dq_entry(q, k, v, b, lse, out, do, causal, scale, rate, keep):
        calls.append("dq")
        keeps.append(keep)
        delta = (do.float() * out.float()).sum(-1).reshape(-1, q.shape[2])
        deltas.append(delta)
        return plain_bwd(q, k, v, b, out, lse, do, causal, scale, rate, seeds[0])[0], delta

    def dkv_entry(q, k, v, b, lse, delta, do, causal, scale, rate, drop):
        calls.append("dkv")
        keeps.append(drop)
        deltas.append(delta)
        return plain_bwd(q, k, v, b, None, lse, do, causal, scale, rate, seeds[0])[1:]

    monkeypatch.setattr(tfa, "_use_kernel", lambda q: True)
    monkeypatch.setattr(tfa, "flash_attention_fwd", fwd_entry)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq_delta", dq_entry)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dkv", dkv_entry)
    ts = [_to_bf16(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*ts, bias=_to_bf16(bias), dropout_rate=rate,
                              generator=torch.Generator().manual_seed(3))
    out.backward(_to_bf16(do))
    assert calls == ["fwd", "dq", "dkv"]
    assert out.dtype == torch.bfloat16
    if rate:
        assert keeps[0].dtype == torch.int32 and keeps[0].shape == (2 * 3, 20, 1)
        assert keeps[1] is keeps[0] and keeps[2] is keeps[0]
    else:
        assert keeps == [None, None]
    assert deltas[1] is deltas[0] and deltas[0].dtype == torch.float32
    seed = tfa._draw_seed(torch.Generator().manual_seed(3), "cpu") if rate else None
    want = plain_bwd(*(_to_bf16(a) for a in (q, k, v, bias)), out.detach(), None, _to_bf16(do),
                     False, None, rate, seed)
    for t, w in zip(ts, want):
        assert t.grad.dtype == torch.bfloat16 and torch.equal(t.grad, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bf16_backward_folds_delta_into_the_dq_kernel(monkeypatch, dtype):
    """On ``meta`` tensors, with the entries' launches recorded: the bf16
    backward computes no delta in torch (no op runs before the dQ kernel)
    and hands the dQ entry ``out`` and an f32 ``[B*H, Lq]`` delta to write,
    which the dK/dV entry then reads; the f32 route still computes delta in
    torch and hands it to both kernels, with no ``out``."""
    import contextlib

    from torch.utils._python_dispatch import TorchDispatchMode

    b, h, lq, lk, d = 2, 3, 24, 40, 32
    q, do, out = (torch.empty(b, h, lq, d, device="meta", dtype=dtype) for _ in range(3))
    k, v = (torch.empty(b, h, lk, d, device="meta", dtype=dtype) for _ in range(2))
    lse = torch.empty(b * h, lq, device="meta")
    ops, launches = [], []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    def head(name, q, k, v, bias, lse, delta, dout, causal, scale, more=()):
        return [q, k, v, bias, lse, delta, dout, *more], [], None

    monkeypatch.setattr(tfa, "_bwd_args", head)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tfa, "_launch", lambda name, dt, args: launches.append((name, dt, args,
                                                                              len(ops))))
    with Record():
        tfa.flash_attention_bwd(q, k, v, None, out, lse, do)
    names = [name for name, *_ in launches]
    assert names == ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"]
    dq_args, dkv_args = launches[0][2], launches[1][2]
    delta = dq_args[5]
    assert delta.shape == (b * h, lq) and delta.dtype == torch.float32
    assert dkv_args[5] is delta
    before_dq = set(ops[:launches[0][3]])
    if dtype == torch.bfloat16:
        assert not {"aten.mul", "aten.sum"} & set(ops)
        assert dq_args[7] is out  # delta from out, in the kernel
    else:
        assert {"aten.mul", "aten.sum"} <= before_dq
        assert all(a is not out for a in dq_args)


def test_bf16_backward_takes_the_stored_mask_in_place_of_the_seed(monkeypatch):
    """The bf16 backward entries read the mask the bf16 forward returned:
    with dropout they refuse a missing mask or the seed in its place, and
    at rate 0 they need none; the bf16 dQ kernel computes delta itself, so
    the dQ entry that is handed a delta refuses bfloat16."""
    b, h, lq, lk, d = 2, 3, 24, 40, 32
    q = torch.zeros(b, h, lq, d, dtype=torch.bfloat16)
    k = torch.zeros(b, h, lk, d, dtype=torch.bfloat16)
    keep = tfa.keep_words(b, h, lq, lk, "cpu")
    assert tfa._keep_args("dkv", q, k, 0.25, keep) == [keep.data_ptr(), 1.0 / 0.75]
    assert tfa._keep_args("dkv", q, k, 0.0, None) == [None, 1.0]
    seed = torch.zeros(2, dtype=torch.int32)
    for bad in (None, seed, keep[:, :, :1].contiguous()):  # none, the seed, a word short
        with pytest.raises(ValueError, match="dropout mask"):
            tfa._keep_args("dkv", q, k, 0.25, bad)
    monkeypatch.setattr(tfa, "_bwd_args", lambda *a, **kw: ([], [], None))
    stat = torch.zeros(b * h, lq)
    with pytest.raises(TypeError, match="flash_attention_bwd_dq_delta"):
        tfa.flash_attention_bwd_dq(q, k, k, None, stat, stat, q)


def test_stored_mask_words_unpack_to_entries():
    """``unpack_keep`` reads entry (iq, ik) from bit ik % 32 of word ik // 32,
    the layout the bf16 forward stores and the backward reads."""
    b, h, lq, lk = 1, 2, 3, 40
    want = torch.from_numpy(np.random.RandomState(5).rand(b, h, lq, lk) < 0.5)
    words = torch.zeros(b * h, lq, 2, dtype=torch.int64)
    flat = want.reshape(b * h, lq, lk)
    for ik in range(lk):
        words[..., ik // 32] |= flat[..., ik].long() << (ik % 32)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    keep = tfa.keep_words(b, h, lq, lk, "cpu")
    assert keep.shape == words.shape and keep.dtype == torch.int32
    assert torch.equal(tfa.unpack_keep(words, b, h, lq, lk), want)


def test_bf16_reaches_the_kernel_path_and_float16_is_refused():
    """On ``meta`` tensors bf16 goes to the kernel entries, which refuse a
    tensor off the card; float16 has no kernel and raises TypeError before
    anything else, as does a dtype mix."""
    bf = torch.empty(1, 2, 16, 32, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(bf, bf, bf)
    stat = torch.empty(2, 16, device="meta")
    for entry in (tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            entry(bf, bf, bf, None, stat, stat, bf)
    half = bf.half()
    with pytest.raises(TypeError):
        tfa.flash_attention(half, half, half)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(bf, bf, bf.float())
    with pytest.raises(TypeError):
        tfa.flash_attention_bwd_dq(bf, bf, bf, None, stat.bfloat16(), stat, bf)


def test_bf16_cpu_calls_count_no_launch():
    q, k, v = (_to_bf16(a) for a in _qkv(1, 2, 16, 32, seed=3))
    before = {n: getattr(tfa, n) for n in tfa.__all__ if n.endswith("LAUNCHES")}
    tfa.flash_attention(q, k, v)
    assert {n: getattr(tfa, n) for n in before} == before


def test_plain_forward_follows_the_bf16_kernels_key_tile():
    """``_plain_fwd`` runs the online softmax over tiles of ``_KEY_TILES``
    keys, the bf16 forward kernel's ``BN`` at each head dim (its launch
    table, ``launch_d`` in ``csrc/flash_attention_bf16.cu``); in f32 the
    tiling moves nothing beyond rounding, so the plain forward equals the
    softmax."""
    import os
    import re

    from paddle_tpu_torch.ops.cuda import _build

    with open(os.path.join(_build.CSRC_DIR, "flash_attention_bf16.cu")) as f:
        src = f.read()
    (d_, bn_d, bn_else), = re.findall(r"constexpr int BN = D == (\d+) \? (\d+) : (\d+);", src)
    tiles = {d: int(bn_d) if d == int(d_) else int(bn_else) for d in tfa._HEAD_DIMS}
    assert tiles == tfa._KEY_TILES
    q, k, v = (torch.from_numpy(a).double() for a in _qkv(2, 2, 150, 32, seed=40))
    out, lse = tfa._plain_fwd(q, k, v, causal=True)
    torch.testing.assert_close(out, tfa._plain_attention(q, k, v, None, True, 32 ** -0.5),
                               atol=1e-12, rtol=0)
    s = tfa._scores(q, k, None, True, 32 ** -0.5)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(-1, 150), atol=1e-12, rtol=0)
