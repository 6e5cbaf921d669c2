"""Port parity: float16 autocast (``auto_cast(dtype="float16")`` with a ``GradScaler``).

The fifth config of ``BASELINE.json`` (ERNIE and the Transformer seq2seq
with the fused LayerNorm under fp16 AMP) on the CPU, held against the JAX
package on the same numpy inputs:

- the plain versions of the fp16 kernels (rows 1-7: the residual LayerNorm
  forward, its mixed case and its backward, the flash-attention forward and
  backward) against the JAX functions in fp16, which off the TPU run their
  jnp references (``_supported`` is false there);
- a tiny ERNIE and a tiny seq2seq forward under O1 fp16 against the JAX
  package's, bit for bit;
- one O1 fp16 step of each: the loss and every gradient, the loss scaled
  as ``GradScaler.scale`` scales it and the gradients unscaled as
  ``GradScaler.unscale_`` does, against ``jax.value_and_grad`` over
  ``_swapped_model`` (the JAX train step's own construction; the JAX eager
  tape does not differentiate AMP steps), each limit between the sound
  reading and a control, the same step in bf16, which must fail it;
- a forced overflow, where both packages find an inf, the port's step
  leaves every parameter as it was and the scale halves as the JAX
  ``GradScaler.update`` halves it;
- the kernel entries' dispatch on ``meta`` fp16 tensors: each picks its
  fp16 symbol and raises for want of a card, never a dtype ``TypeError``.

The kernels themselves are held against these plain versions on the card
by ``chip_smoke.py`` (phase 12s).
"""
import contextlib
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu.framework import autograd as jax_autograd  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.framework.tensor import Tensor as JaxTensor  # noqa: E402
from paddle_tpu.models import BertPretrainingCriterion as JaxCriterion  # noqa: E402
from paddle_tpu.models import ErnieForPretraining as JaxErnieForPretraining  # noqa: E402
from paddle_tpu.models import TransformerSeq2Seq as JaxSeq2Seq  # noqa: E402
from paddle_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from paddle_tpu.nn import functional as jF  # noqa: E402
from paddle_tpu.nn import transformer as jax_tf  # noqa: E402
from paddle_tpu.ops.pallas import layernorm_residual as _  # noqa: E402,F401
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_flash  # noqa: E402

from paddle_tpu_torch import amp as pamp  # noqa: E402
from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.models import BertConfig, BertPretrainingCriterion  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.nn import transformer as port_tf  # noqa: E402
from paddle_tpu_torch.ops import cuda as port_cuda  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from paddle_tpu_torch.ops.cuda import layernorm_residual as tlnr  # noqa: E402

jlnr = sys.modules["paddle_tpu.ops.pallas.layernorm_residual"]
torch.set_num_threads(1)

EPS = 1e-5


def _ulp16(a):
    """One fp16 ulp of the largest |entry| of ``a`` (11 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(float(np.abs(a).max()), 2.0 ** -14))) - 10)


def _f32(a):
    """A JAX or torch array as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulps(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / _ulp16(want))


@pytest.fixture(autouse=True)
def _x64_off():
    """The JAX side with 64-bit types off, the JAX package's own setting
    (this harness turns them on)."""
    with jax.enable_x64(False):
        yield


# -- rows 1 and 2: the residual LayerNorm ---------------------------------------------


def _ln_inputs(rows, h, seed):
    rng = np.random.RandomState(seed)
    x, r, dy = (rng.randn(rows, h).astype("f4") for _ in range(3))
    w, b = (rng.randn(h).astype("f4") for _ in range(2))
    return x, r, w, b, dy


@pytest.mark.parametrize("rows,h", [(37, 256), (8, 768), (16, 512), (5, 1000)])
@pytest.mark.parametrize("res", ["float16", "float32"])
def test_layernorm_plain_fp16_matches_jax(rows, h, res):
    """fp16 x on an fp16 residual (rows 1h, 2h) or on an f32 one (the mixed
    instance): the plain forward against the JAX ``layernorm_residual`` (its
    jnp reference off the TPU) and the op's gradients, through the plain
    backward, against ``jax.vjp`` of ``_reference`` on the same fp16 arrays.
    The output and dx to 1 fp16 ulp of their largest entry (both add in x's
    dtype or in f32, normalize in f32 and round once; read 0.5), the
    residual's f32 gradient, dw and db to 1e-5 of their largest (f32 sums in
    other orders). The plain backward alone, on the forward's statistics,
    to 1 ulp as well."""
    x, r, w, b, dy = _ln_inputs(rows, h, seed=rows + h)
    rd = jnp.float16 if res == "float16" else jnp.float32
    jx, jr = jnp.asarray(x).astype(jnp.float16), jnp.asarray(r).astype(rd)
    jw, jb = jnp.asarray(w), jnp.asarray(b)
    assert str(jlnr.layernorm_residual(jx, jr, jw, jb, EPS).dtype) == "float16"
    want, vjp = jax.vjp(lambda *a: jlnr._reference(*a, EPS), jx, jr, jw, jb)
    jdy = jnp.asarray(dy).astype(jnp.float16)
    gx, gr, gw, gb = vjp(jdy)
    tx = torch.tensor(_f32(jx)).half().requires_grad_()
    tr = torch.tensor(_f32(jr)).to(getattr(torch, res)).requires_grad_()
    tw, tb = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    y = tlnr.layernorm_residual(tx, tr, tw, tb, EPS)
    y.backward(torch.tensor(_f32(jdy)).half())
    assert y.dtype == tx.grad.dtype == torch.float16 and tr.grad.dtype == tr.dtype
    assert _ulps(y, want) <= 1.0
    assert _ulps(tx.grad, gx) <= 1.0
    for got, g in ((tr.grad, gr), (tw.grad, gw), (tb.grad, gb)):
        g = _f32(g)
        if got.dtype == torch.float16:
            assert _ulps(got, g) <= 1.0
        else:
            np.testing.assert_allclose(_f32(got), g, rtol=1e-5, atol=1e-5 * np.abs(g).max())
    if res == "float16":
        _, mean, rstd = tlnr._reference(tx.detach(), tr.detach(), tw.detach(), tb.detach(), EPS)
        da, dwp, dbp = tlnr._reference_bwd(tx.detach(), tr.detach(), tw.detach(), mean, rstd,
                                           torch.tensor(_f32(jdy)).half())
        assert da.dtype == torch.float16 and dwp.dtype == torch.float32
        assert _ulps(da, gx) <= 1.0


def test_layernorm_fp16_instances_count_apart_and_the_mixed_case_takes_no_cast():
    """The fp16 forward, its mixed instance (fp16 x on an f32 residual, no
    cast pass) and the fp16 backward have counts of their own, listed in
    ``KERNEL_COUNTERS``, and the C entry's dtype codes; the plain version
    counts none."""
    names = {"layernorm_residual_fwd_fp16": "FP16_LAUNCHES",
             "layernorm_residual_bwd_fp16": "FP16_BWD_LAUNCHES",
             "layernorm_residual_fwd_mixed_fp16": "FP16_MIXED_LAUNCHES"}
    for name, attr in names.items():
        assert port_cuda.KERNEL_COUNTERS[name] == (tlnr, attr)
    assert tlnr._FWD_DTYPES[(torch.float16, torch.float16)] == 3
    assert tlnr._FWD_DTYPES[(torch.float16, torch.float32)] == 4
    assert tlnr._DTYPES[torch.float16] == 2
    before = port_cuda.launch_counts()
    tlnr._count("LAUNCHES", torch.float16)
    tlnr._count("LAUNCHES", torch.float16, torch.float32)
    tlnr._count("BWD_LAUNCHES", torch.float16)
    after = port_cuda.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        name: 1 for name in names}
    x, r, w, b, _ = _ln_inputs(4, 256, seed=1)
    before = port_cuda.launch_counts()
    tlnr.layernorm_residual_fwd(torch.from_numpy(x).half(), torch.from_numpy(r),
                                torch.from_numpy(w), torch.from_numpy(b))
    assert port_cuda.launch_counts() == before
    assert tlnr._fwd_plan(768, torch.float16) == "row" and tlnr._fwd_plan(1000,
                                                                           torch.float16) == "block"


# -- rows 3-7: flash attention ---------------------------------------------------------


def _attn_case(bias_kind, lq, lk, d, seed):
    b, h = 2, 3
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(b, h, lq, d).astype("f4") for _ in range(2))
    k, v = (rng.randn(b, h, lk, d).astype("f4") for _ in range(2))
    if bias_kind == "pad":  # ERNIE's padding mask, -1e4 (exact in fp16)
        lens = rng.randint(lk // 2, lk + 1, size=b)
        keep = np.arange(lk)[None, :] < lens[:, None]
        bias = ((1.0 - keep) * -1e4).astype("f4")[:, None, None, :]
    elif bias_kind == "bool":  # the transformer's boolean mask: -1e9, -inf in fp16
        lens = rng.randint(lk // 2, lk + 1, size=b)
        keep = np.arange(lk)[None, :] < lens[:, None]
        bias = np.where(keep, 0.0, -1e9).astype("f4")[:, None, None, :]
    else:
        bias = rng.randn(b, h, lq, lk).astype("f4")
    return q, k, v, bias, do


@pytest.mark.parametrize("lq,lk,d", [(16, 16, 32), (128, 128, 64), (24, 40, 32), (40, 24, 32)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", ["pad", "full", "bool"])
def test_flash_plain_fp16_matches_jax(bias_kind, causal, lq, lk, d):
    """fp16 q, k, v and bias (the mask in q's dtype, as under AMP; the
    boolean mask's -1e9 becomes -inf) against the JAX ``flash_attention``
    on the same fp16 arrays (its jnp path) and ``jax.vjp``: the autograd
    route through the plain version (rows 3 and 4 forward, 5-7 backward)
    to 1 fp16 ulp of the largest entry, the kernels' plain forward
    (``_plain_fwd``: the unnormalized probabilities rounded, by key tiles)
    to 2 and their plain backward (``_plain_bwd``: dS rounded to fp16
    before its products, where the vjp keeps it f32) to 4."""
    q, k, v, bias, do = _attn_case(bias_kind, lq, lk, d, seed=lq + lk + d)
    j = [jnp.asarray(a).astype(jnp.float16) for a in (q, k, v, bias, do)]
    want, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, bias=j[3], causal=causal),
                        *j[:3])
    want_grads = vjp(j[4])
    th = [torch.from_numpy(_f32(a)).half() for a in j]
    ts = [t.clone().requires_grad_() for t in th[:3]]
    out = tfa.flash_attention(*ts, bias=th[3], causal=causal)
    out.backward(th[4])
    assert out.dtype == torch.float16 and all(t.grad.dtype == torch.float16 for t in ts)
    assert _ulps(out, want) <= 1.0
    for t, g in zip(ts, want_grads):
        assert _ulps(t.grad, g) <= 1.0
    pout, lse = tfa._plain_fwd(*th[:4], causal)
    assert pout.dtype == torch.float16 and lse.dtype == torch.float32
    assert _ulps(pout, want) <= 2.0
    for got, g in zip(tfa._plain_bwd(*th[:4], pout, lse, th[4], causal), want_grads):
        assert got.dtype == torch.float16 and _ulps(got, g) <= 4.0


def test_flash_plain_fp16_row_with_every_key_masked():
    """A query row whose keys are all masked by the boolean mask (-inf in
    fp16): the kernels' plain forward gives it a zero output and a finite
    lse (the TPU kernel's l == 0 guard), as the kernels do, where a
    softmax over the row (the JAX plain path) gives NaN; the other rows are
    the JAX package's."""
    q, k, v, _, _ = _attn_case("pad", 16, 16, 32, seed=3)
    bias = np.zeros((2, 1, 1, 16), "f4")
    bias[1] = -1e9  # the second batch row sees no key
    th = [torch.from_numpy(a).half() for a in (q, k, v, bias)]
    assert bool(torch.isinf(th[3][1]).all())
    out, lse = tfa._plain_fwd(*th, False)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.isfinite(lse).all()
    assert float(lse.reshape(2, 3, 16)[1].max()) == float(np.float32(-1e30))
    want = jax_flash(*(jnp.asarray(a).astype(jnp.float16) for a in (q, k, v, bias)))
    assert np.isnan(_f32(want)[1]).all()
    assert _ulps(out[0], _f32(want)[0]) <= 2.0


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_flash_fp16_routes_through_the_kernel_entries(monkeypatch, rate):
    """The card's autograd wiring on fp16 with the kernel entries standing
    in for the kernels (their plain versions): the forward stores its mask
    (here the seed the plain backward redraws it from), the dQ entry
    computes delta, the dK/dV entry reads it; fp16 output and gradients
    equal to the plain versions' bit for bit, each entry called once."""
    q, k, v, bias, do = _attn_case("pad", 20, 20, 32, seed=21)
    calls = []

    def fwd(q_, k_, v_, b_, causal, scale, rate_, seed):
        calls.append("fwd")
        res = tfa._plain_fwd(q_, k_, v_, b_, causal, scale, rate_, seed)
        return (*res, seed) if rate_ else res

    def dq_delta(q_, k_, v_, b_, lse, out, do_, causal, scale, rate_, keep):
        calls.append("dq")
        delta = (do_.float() * out.float()).sum(-1).reshape(-1, q_.shape[2])
        return tfa._plain_bwd(q_, k_, v_, b_, out, lse, do_, causal, scale, rate_, keep)[0], delta

    def dkv(q_, k_, v_, b_, lse, delta, do_, causal, scale, rate_, keep):
        calls.append("dkv")
        return tfa._plain_bwd(q_, k_, v_, b_, None, lse, do_, causal, scale, rate_, keep)[1:]

    monkeypatch.setattr(tfa, "_use_kernel", lambda q_: True)
    monkeypatch.setattr(tfa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq_delta", dq_delta)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dkv", dkv)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq", None)  # the f32 route is not taken
    gen = torch.Generator().manual_seed(4)
    th = [torch.from_numpy(a).half() for a in (q, k, v, bias, do)]
    ts = [t.clone().requires_grad_() for t in th[:3]]
    out = tfa.flash_attention(*ts, bias=th[3], dropout_rate=rate, generator=gen)
    out.backward(th[4])
    assert calls == ["fwd", "dq", "dkv"] and out.dtype == torch.float16
    seed = tfa._draw_seed(torch.Generator().manual_seed(4), "cpu") if rate else None
    pout, lse = tfa._plain_fwd(*th[:4], False, 32 ** -0.5, rate, seed)
    assert torch.equal(out.detach(), pout)
    want = tfa._plain_bwd(*th[:4], pout, lse, th[4], False, 32 ** -0.5, rate, seed)
    for t, w in zip(ts, want):
        assert t.grad.dtype == torch.float16 and torch.equal(t.grad, w)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernel_entries_pick_the_fp16_symbols_on_meta_tensors(monkeypatch, rate):
    """On ``meta`` fp16 tensors each entry reaches its launch with the fp16
    kernel (the ``*_f16`` symbols of the bf16 sources, the fp16 counts) and
    raises for want of a card there, never with a dtype ``TypeError``; the
    LayerNorm entries likewise pick dtype codes 3 (fp16), 4 (fp16 on an f32
    residual) and 2 (the fp16 backward)."""
    b, h, lq, lk, d = 2, 3, 24, 40, 32
    meta = dict(device="meta", dtype=torch.float16)
    q, do, out = (torch.empty(b, h, lq, d, **meta) for _ in range(3))
    k, v = (torch.empty(b, h, lk, d, **meta) for _ in range(2))
    lse = torch.empty(b * h, lq, device="meta")
    keep = torch.empty(b * h, lq, (lk + 31) // 32, device="meta", dtype=torch.int32)
    for fn, args in ((tfa.flash_attention_fwd, (q, k, v, None, False, None, 0.0)),
                     (tfa.flash_attention_bwd_dq_delta, (q, k, v, None, lse, out, do)),
                     (tfa.flash_attention_bwd_dkv, (q, k, v, None, lse, lse, do))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    picked = []

    class NoCard(RuntimeError):
        pass

    def launch(name, dtype, args):
        lib, counter = tfa._KERNELS[(name, dtype)]
        picked.append((lib, name + tfa._WGMMA_SUFFIX[dtype], counter))
        raise NoCard("no card to launch on")

    monkeypatch.setattr(tfa, "_kernel_args", lambda name, q_, *a, **kw: ([], [], None))
    monkeypatch.setattr(tfa, "_keep_args", lambda *a: [])
    monkeypatch.setattr(tfa, "_seed_args", lambda *a: [])
    monkeypatch.setattr(tfa, "keep_words", lambda *a: keep)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tfa, "_launch", launch)
    seed = torch.empty(2, device="meta", dtype=torch.int32)
    for fn, args in ((tfa.flash_attention_fwd, (q, k, v, None, False, None, rate, seed)),
                     (tfa.flash_attention_bwd_dq_delta, (q, k, v, None, lse, out, do, False,
                                                         None, rate, keep)),
                     (tfa.flash_attention_bwd_dkv, (q, k, v, None, lse, lse, do, False, None,
                                                    rate, keep))):
        with pytest.raises(NoCard):
            fn(*args)
    assert picked == [
        ("flash_attention_bf16", "flash_attention_fwd_f16", "FP16_LAUNCHES"),
        ("flash_attention_bwd_bf16", "flash_attention_bwd_dq_f16", "FP16_DQ_LAUNCHES"),
        ("flash_attention_bwd_bf16", "flash_attention_bwd_dkv_f16", "FP16_DKV_LAUNCHES")]
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        assert port_cuda.KERNEL_COUNTERS[f"flash_attention_{name}_fp16"] == (
            tfa, picked[("fwd", "bwd_dq", "bwd_dkv").index(name)][2])
    # the LayerNorm entries: the dtype code each hands the C entry
    codes = []

    class FakeLib:
        def __getattr__(self, symbol):
            def fn(*args):
                codes.append((symbol, args[-2]))
                raise NoCard("no card to launch on")
            fn.argtypes = True
            return fn

    monkeypatch.setattr(tlnr._build, "library", lambda name: FakeLib())
    monkeypatch.setattr(tlnr, "_check_kernel", lambda x2, tensors: None)
    monkeypatch.setattr(tlnr, "_aligned", lambda t: t)
    monkeypatch.setattr(tlnr, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type(
        "S", (), {"cuda_stream": 0})())
    x = torch.empty(8, 768, **meta)
    w = torch.empty(768, device="meta")
    st = torch.empty(8, device="meta")
    for r in (x, torch.empty(8, 768, device="meta")):
        with pytest.raises(NoCard):
            tlnr.layernorm_residual_fwd(x, r, w, w)
    with pytest.raises(NoCard):
        tlnr.layernorm_residual_bwd(x, x, w, st, st, x)
    assert codes == [("ptt_layernorm_residual_fwd", 3), ("ptt_layernorm_residual_fwd", 4),
                     ("ptt_layernorm_residual_bwd", 2)]


# -- the models: tiny ERNIE and seq2seq under O1 fp16 -----------------------------------


def _ernie_cfg(cls):
    return cls(vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=128, max_position_embeddings=64, hidden_act="relu",
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               use_flash_attention=True)


S2S = dict(src_vocab=40, tgt_vocab=40, d_model=64, nhead=2, num_layers=2, dim_feedforward=128,
           dropout=0.0, max_len=64, bos_id=0, eos_id=1, pad_id=2)


@pytest.fixture
def _flash_everywhere(monkeypatch):
    monkeypatch.setattr(jax_tf, "FLASH_ATTENTION_MIN_SEQ", 1)
    monkeypatch.setattr(port_tf, "FLASH_ATTENTION_MIN_SEQ", 1)


@pytest.fixture(scope="module")
def ernie_path(tmp_path_factory):
    paddle.seed(0)
    with jax.enable_x64(False):
        jm = JaxErnieForPretraining(_ernie_cfg(JaxBertConfig))
    path = str(tmp_path_factory.mktemp("fp16") / "ernie_tiny.pdparams")
    paddle.save(jm.state_dict(), path)
    return path


@pytest.fixture(scope="module")
def s2s_path(tmp_path_factory):
    paddle.seed(1)
    with jax.enable_x64(False):
        jm = JaxSeq2Seq(**S2S)
    path = str(tmp_path_factory.mktemp("fp16") / "s2s_tiny.pdparams")
    paddle.save(jm.state_dict(), path)
    return path


def _jax_ernie(path):
    paddle.seed(7)  # overwritten by the saved weights
    jm = JaxErnieForPretraining(_ernie_cfg(JaxBertConfig))
    jm.set_state_dict(paddle.load(path))
    return jm


def _jax_s2s(path):
    paddle.seed(7)
    jm = JaxSeq2Seq(**S2S)
    jm.set_state_dict(paddle.load(path))
    return jm


def _ernie_batch(seed=1):
    rng = np.random.RandomState(seed)
    b, l, p = 2, 16, 5
    ids = rng.randint(5, 512, (b, l)).astype("int64")
    ids[1, 11:] = 0  # a padded row: the -1e4 bias masks its tail
    types = (np.arange(l)[None, :] >= l // 2).astype("int64").repeat(b, 0)
    pos = np.stack([rng.choice(l - 6, p, replace=False) + i * l for i in range(b)]).ravel()
    mlm = rng.randint(0, 512, (b * p,)).astype("int64")
    mlm[1] = -100
    nsp = rng.randint(0, 2, (b, 1)).astype("int64")
    return [ids, types, pos.astype("int64"), mlm, nsp]


def _s2s_batch(seed=4):
    rng = np.random.RandomState(seed)
    b, ls, lt = 3, 12, 10
    src = rng.randint(3, 40, (b, ls)).astype("int64")
    src[1, 8:] = 2
    src[2, 5:] = 2
    tin = rng.randint(3, 40, (b, lt)).astype("int64")
    tin[:, 0] = 0
    tout = np.concatenate([tin[:, 1:], np.full((b, 1), 1, "int64")], axis=1)
    tout[2, 6:] = 2
    return [src, tin, tout]


def _ernie_loss(crit, amp_mod, dtype):
    def loss_fn(m, ids, types, pos, mlm, nsp):
        with amp_mod.auto_cast(level="O1", dtype=dtype):
            pred, rel = m(ids, types, masked_positions=pos)
            return crit(pred, rel, mlm, nsp)
    return loss_fn


def _s2s_loss(functional, amp_mod, dtype):
    def loss_fn(m, src, tin, tout):
        with amp_mod.auto_cast(level="O1", dtype=dtype):
            logits = m(src, tin)
            mask = (tout != 2).astype("float32") if hasattr(tout, "astype") else (
                tout != 2).float()
            ce = functional.cross_entropy(logits.reshape([-1, 40]), tout.reshape([-1]),
                                          reduction="none")
            return (ce * mask.reshape([-1])).sum() / mask.sum()
    return loss_fn


def _jt(a):
    return JaxTensor._from_array(jnp.asarray(a))


# The tiny seq2seq's fp16 logits against the JAX package's, in fp16 ulps of
# the largest: the two packages' f32 statistics round a residual
# LayerNorm's output an fp16 ulp apart here and there (the first norm
# already, read 1 ulp) and the layers carry that (read 2.0); the bf16
# forward, the control, reads 19.25.
S2S_LOGITS_ULPS = 6.0


def test_tiny_ernie_and_seq2seq_forwards_under_o1_fp16_match_jax(ernie_path, s2s_path,
                                                                 _flash_everywhere):
    """The tiny ERNIE's MLM and NSP logits (flash on) under
    ``auto_cast(dtype="float16")`` equal the JAX package's bit for bit (the
    same roundings at the same points), and the bf16 forward, the control,
    does not; the tiny seq2seq's teacher-forced logits come out fp16 within
    ``S2S_LOGITS_ULPS`` of the JAX package's, the bf16 control outside."""
    ids, types, pos, _, _ = _ernie_batch()
    jm = _jax_ernie(ernie_path)
    with jamp.auto_cast(dtype="float16"):
        w_pred, w_rel = jm(_jt(ids), _jt(types), masked_positions=_jt(pos))
    tm = convert.load_ernie_pretraining(ernie_path, _ernie_cfg(BertConfig))
    tin = [torch.from_numpy(a) for a in (ids, types, pos)]
    with torch.no_grad():
        with pamp.auto_cast(dtype="float16"):
            pred, rel = tm(tin[0], tin[1], masked_positions=tin[2])
        with pamp.auto_cast(dtype="bfloat16"):
            ctl = tm(tin[0], tin[1], masked_positions=tin[2])[0]
    assert np.array_equal(_f32(pred), _f32(w_pred._array))
    assert np.array_equal(_f32(rel), _f32(w_rel._array))
    assert not np.array_equal(_f32(ctl), _f32(w_pred._array))
    src, tgt, _ = _s2s_batch()
    js = _jax_s2s(s2s_path)
    with jamp.auto_cast(dtype="float16"):
        want = js(_jt(src), _jt(tgt))._array
    ts = convert.load_seq2seq(s2s_path, **S2S).eval()
    with torch.no_grad():
        with pamp.auto_cast(dtype="float16"):
            got = ts(torch.from_numpy(src), torch.from_numpy(tgt))
        with pamp.auto_cast(dtype="bfloat16"):
            control = ts(torch.from_numpy(src), torch.from_numpy(tgt))
    assert got.dtype == torch.float16 and str(want.dtype) == "float16"
    assert _ulps(got, want) <= S2S_LOGITS_ULPS < _ulps(control, want), (
        _ulps(got, want), _ulps(control, want))


# One O1 fp16 step of each tiny model against jax.value_and_grad over the
# JAX train step's own construction, the loss scaled by GradScaler's scale
# on both sides and the gradients multiplied by 1 / scale: the loss, the
# whole gradient's relative L2 error, the worst entry relative to the
# largest of its layer (the attention key biases left out: their gradient
# is zero up to rounding) and the share of gradient entries that differ in
# any bit. Read on the CPU (sound / control):
#   ERNIE (flash on, the -1e4 pad bias): loss 0 (one f32 ulp of the loss,
#   4.8e-7, stands for it) / bf16 5.2e-4; L2 4.2e-4 / 4.8e-3; worst 2.0e-3
#   / 1.1e-2; differing 0.353 / 0.964 (f32: 1.1e-4, 6.2e-4, 1.8e-3, 1.000).
#   Each limit near the geometric mean of the two; the bf16 step must fail
#   every one.
#   seq2seq (post-norm, relu FFN, boolean masks at -inf): the two packages'
#   f32 statistics round the residual LayerNorms' outputs an fp16 ulp apart
#   here and there (the sums run in other orders), and through 2 + 2 relu
#   layers at 30 tokens that moves the gradient as far as the f32 step is
#   (L2 0.0143 / f32 0.0145 / bf16 0.0247; worst 0.085 / 0.085 / 0.114;
#   differing 0.958 / 1.000 / 0.990). Only the loss tells the cast apart:
#   1.5e-5 / f32 2.9e-4 (bf16 2.3e-5, too near). So the f32 step is the
#   control, its loss limit the geometric mean, and the gradient limits
#   (2.5 times the reading) catch gross faults only, as chip_smoke.py's
#   BERT AMP limits do.
SCALE = 1024.0
FP16_STEP_LIMITS = {
    # (loss atol, gradient rel L2, worst entry of its layer's largest, share differing)
    "ernie": (1.5e-5, 1.4e-3, 4.5e-3, 0.6),
    "seq2seq": (6.5e-5, 0.036, 0.2, None),
}
# the control of each, and the limits it must fail (their indices)
FP16_STEP_CONTROL = {"ernie": ("bfloat16", (0, 1, 2, 3)), "seq2seq": ("float32", (0,))}


class _NoAmp:
    """An ``amp`` module whose scope casts nothing: the f32 control."""

    auto_cast = staticmethod(lambda **kw: contextlib.nullcontext())


def _layer_relative(got, want):
    layer_max = {}
    for name, g in want.items():
        layer = name.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0), float(np.abs(g).max()))
    return max(float(np.abs(got[n] - g).max()) / max(layer_max[n.rsplit(".", 1)[0]], 1e-30)
               for n, g in want.items() if not n.endswith("k_proj.bias"))


def _differing(got, want):
    """The share of gradient entries (not 0 on both sides) that differ."""
    differ = sum(int((got[n] != g).sum()) for n, g in want.items())
    return differ / sum(int(((got[n] != 0) | (g != 0)).sum()) for n, g in want.items())


def _rel_l2(got, want):
    num = sum(float(np.square(got[n].astype("f8") - g.astype("f8")).sum()) for n, g in want.items())
    den = sum(float(np.square(g.astype("f8")).sum()) for g in want.values())
    return math.sqrt(num / den)


def _jax_scaled_grads(jm, loss_fn, batch, scale):
    """(loss, {name: unscaled gradient}) of ``loss_fn(jm, *batch) *
    scale`` by ``jax.value_and_grad`` over ``_swapped_model``; the
    gradients multiplied by ``1 / scale`` as ``GradScaler.unscale_`` does."""
    params = {n: p._array for n, p in jm.named_parameters()}

    def loss_of(params):
        state = {"params": params, "frozen": {}, "buffers": {}}
        with jax_jit._swapped_model(jm, state), jax_autograd.no_grad():
            loss = loss_fn(jm, *[_jt(a) for a in batch])
        return loss._array * jnp.float32(scale)

    scaled, grads = jax.value_and_grad(loss_of)(params)
    inv = 1.0 / scale
    return (float(scaled) / scale,
            {n: np.asarray((g * inv).astype(jnp.float32)) for n, g in grads.items()})


def _port_scaled_grads(tm, loss_fn, batch, scale):
    """(loss, {name: gradient}, found_inf) of one port step through
    ``GradScaler``: ``scale(loss).backward()`` and ``unscale_``."""
    scaler = pamp.GradScaler(init_loss_scaling=scale)
    opt = port_opt.SGD(learning_rate=0.0, parameters=tm.parameters())
    loss = loss_fn(tm, *[torch.from_numpy(a) for a in batch])
    scaler.scale(loss).backward()
    scaler.unscale_(opt)
    return (float(loss.detach()), {n: p.grad.float().numpy() for n, p in tm.named_parameters()},
            scaler._found_inf)


def _models(ernie_path, s2s_path):
    return {
        "ernie": (lambda: _jax_ernie(ernie_path),
                  lambda: convert.load_ernie_pretraining(ernie_path, _ernie_cfg(BertConfig)),
                  lambda mod, dt: _ernie_loss(
                      (JaxCriterion if mod is jamp else BertPretrainingCriterion)(512), mod, dt),
                  _ernie_batch()),
        "seq2seq": (lambda: _jax_s2s(s2s_path),
                    lambda: convert.load_seq2seq(s2s_path, **S2S),
                    lambda mod, dt: _s2s_loss(jF if mod is jamp else F, mod, dt),
                    _s2s_batch()),
    }


@pytest.mark.parametrize("model", ["ernie", "seq2seq"])
def test_o1_fp16_step_loss_and_gradients_match_jax(ernie_path, s2s_path, _flash_everywhere,
                                                   model):
    """The loss and every gradient of one O1 fp16 step under a
    ``GradScaler`` against the JAX package's (``jax.value_and_grad`` over
    ``_swapped_model`` with the same scale folded in): within
    ``FP16_STEP_LIMITS``; the control of ``FP16_STEP_CONTROL`` (the step in
    bf16, or in f32) fails its limits; no inf is found on either side."""
    make_jax, make_port, loss_of, batch = _models(ernie_path, s2s_path)[model]
    want_loss, want = _jax_scaled_grads(make_jax(), loss_of(jamp, "float16"), batch, SCALE)
    assert all(np.isfinite(g).all() for g in want.values())

    def errors(dtype):
        amp_mod = _NoAmp if dtype == "float32" else pamp
        loss, grads, found = _port_scaled_grads(make_port(), loss_of(amp_mod, dtype), batch,
                                                SCALE)
        assert set(grads) == set(want) and not found
        return (abs(loss - want_loss), _rel_l2(grads, want), _layer_relative(grads, want),
                _differing(grads, want))

    limits = FP16_STEP_LIMITS[model]
    control_dtype, must_fail = FP16_STEP_CONTROL[model]
    sound, control = errors("float16"), errors(control_dtype)
    assert all(lim is None or e <= lim for e, lim in zip(sound, limits)), (sound, limits)
    assert all(control[i] > limits[i] for i in must_fail), (control, limits)


@pytest.mark.parametrize("model", ["ernie", "seq2seq"])
def test_forced_overflow_skips_the_step_and_halves_the_scale(ernie_path, s2s_path,
                                                             _flash_everywhere, model):
    """After a step taken at a scale fp16 holds, a step at a scale past its
    range: both packages' gradients hold an inf (the JAX ones through
    ``value_and_grad`` with the scale folded in), both scalers find it, the
    port's ``minimize`` leaves every parameter and every Adam moment as they
    were, bit for bit, and the scale halves as the JAX ``GradScaler.update``
    halves it on the same found-inf."""
    make_jax, make_port, loss_of, batch = _models(ernie_path, s2s_path)[model]
    big = 2.0 ** 40
    _, jgrads = _jax_scaled_grads(make_jax(), loss_of(jamp, "float16"), batch, big)
    jfound = not all(np.isfinite(g).all() for g in jgrads.values())
    kw = dict(init_loss_scaling=SCALE, decr_every_n_nan_or_inf=1, incr_every_n_steps=2)
    jscaler = jamp.GradScaler(**kw)
    tm = make_port()
    opt = port_opt.Adam(learning_rate=1e-3, parameters=tm.parameters())
    scaler = pamp.GradScaler(**kw)
    loss_fn = loss_of(pamp, "float16")
    tb = [torch.from_numpy(a) for a in batch]
    scaler.minimize(opt, scaler.scale(loss_fn(tm, *tb)))
    jscaler._found_inf = False
    jscaler.update()
    assert not scaler._found_inf and opt._accumulators
    params = {n: p.detach().clone() for n, p in tm.named_parameters()}
    moments = {k: [t.clone() for t in v] for k, v in opt._accumulators.items()}
    scaler.set_loss_scaling(big)
    jscaler.set_loss_scaling(big)
    scaler.minimize(opt, scaler.scale(loss_fn(tm, *tb)))
    jscaler._found_inf = jfound
    jscaler.update()
    assert jfound and scaler._found_inf
    assert scaler.get_loss_scaling() == jscaler.get_loss_scaling() == big / 2
    assert scaler.state_dict() == jscaler.state_dict()
    assert all(torch.equal(p.detach(), params[n]) for n, p in tm.named_parameters())
    assert all(torch.equal(a, b) for k, v in opt._accumulators.items()
               for a, b in zip(v, moments[k]))


def test_train_step_keeps_fp16_products_summed_in_f32():
    """``train_step`` turns off cuBLAS's reduced-precision reduction of fp16
    products, as of bf16 ones: a product's split-K sums stay f32."""
    from paddle_tpu_torch.framework.jit import train_step

    m = torch.nn.Linear(2, 2)
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = True
    train_step(m, port_opt.Momentum(parameters=m.parameters()), lambda m, x: m(x).sum(),
               device="cpu")
    assert torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction is False


@pytest.mark.parametrize("seed", range(3))
def test_smoke_scale_rule_is_the_jax_scalers(seed):
    """``chip_smoke.jax_scale_rule`` (phase 12s replays it on its runs'
    found-infs without importing JAX) gives, step for step, the scale the
    JAX ``GradScaler.update`` reaches on the same found-inf sequence, with
    the phase's scaler settings and others."""
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    rng = np.random.RandomState(seed)
    found = list(rng.rand(40) < 0.4)
    for kw in (chip_smoke.FP16_SCALER,
               dict(init_loss_scaling=8.0, incr_ratio=3.0, decr_ratio=0.5, incr_every_n_steps=3,
                    decr_every_n_nan_or_inf=2)):
        jscaler = jamp.GradScaler(**kw)
        want = []
        for f in found:
            jscaler._found_inf = bool(f)
            jscaler.update()
            want.append(jscaler.get_loss_scaling())
        assert chip_smoke.jax_scale_rule(found, **kw) == want
