"""Port parity: the Transformer encoder-decoder and the seq2seq model (``paddle_tpu_torch``).

A tiny ``TransformerSeq2Seq`` (d_model 32, 2 heads, 2 + 2 layers, FFN 64,
a 40-token vocabulary, dropout 0) built by the JAX package from a seed; its
weights cross through ``paddle_tpu.save`` and the port's reader
(``convert.load_seq2seq``), never through re-seeding, and the inputs are
the same numpy arrays (source rows with pad tails). The JAX side runs on
the CPU as its own tests run it: its fused LayerNorm takes the plain
reference there. Covered: the decoder layer (with and without
cross-attention, post- and pre-norm, the fused LayerNorm on and off), the
teacher-forced logits, greedy and beam-search decoding, the beam op pair
on constructed ties, three Adam steps through both ``train_step``s, the
forward under ``auto_cast`` (its dtype flow op by op, and its values with
the f32 answer as the control the limit must reject), and the card-only
paths raising on ``meta`` tensors.
"""
import contextlib
import copy
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.optimizer as jax_opt  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu import flags as jax_flags  # noqa: E402
from paddle_tpu import ops as jax_ops  # noqa: E402
from paddle_tpu.framework import autograd as jax_autograd  # noqa: E402
from paddle_tpu.framework import jit as jax_jit  # noqa: E402
from paddle_tpu.models import TransformerSeq2Seq as JaxSeq2Seq  # noqa: E402
from paddle_tpu.nn import functional as jF  # noqa: E402
from paddle_tpu.nn import transformer as jax_tf  # noqa: E402
from paddle_tpu.ops.registry import kernel as jax_kernel  # noqa: E402

import paddle_tpu_torch  # noqa: E402
from paddle_tpu_torch import amp as pamp  # noqa: E402
from paddle_tpu_torch import convert, flags  # noqa: E402
from paddle_tpu_torch import generation as port_generation  # noqa: E402
from paddle_tpu_torch import nn as port_nn  # noqa: E402
from paddle_tpu_torch import optimizer as port_opt  # noqa: E402
from paddle_tpu_torch.framework import autograd as port_autograd  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402
from paddle_tpu_torch.models import TransformerSeq2Seq  # noqa: E402
from paddle_tpu_torch.models import seq2seq as port_seq2seq  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.ops.cuda import layernorm_residual as tlnr  # noqa: E402
from paddle_tpu_torch.ops.registry import kernel as port_kernel  # noqa: E402

torch.set_num_threads(1)

V, D, HEADS, LAYERS, FFN, MAX_LEN = 40, 32, 2, 2, 64, 64
BOS, EOS, PAD = 0, 1, 2
KW = dict(src_vocab=V, tgt_vocab=V, d_model=D, nhead=HEADS, num_layers=LAYERS,
          dim_feedforward=FFN, dropout=0.0, max_len=MAX_LEN, bos_id=BOS, eos_id=EOS, pad_id=PAD)
# f32 through 2 + 2 layers in another summation order: logits up to 2.5
# read 7.2e-7 apart
LOGITS_ATOL = 1e-5
# beam scores: sums of 7 log-probabilities (~-15) in f32, read 1.9e-6 apart
SCORE_ATOL = 2e-5


def _src_tgt(b=3, ls=9, lt=7, seed=1):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, V, (b, ls)).astype("int64")
    src[1, 6:] = PAD  # pad tails: the pad mask does work
    src[2, 3:] = PAD
    tgt = rng.randint(3, V, (b, lt)).astype("int64")
    tgt[:, 0] = BOS
    return src, tgt


@pytest.fixture(autouse=True)
def _x64_off():
    """The JAX side with 64-bit types off, the JAX package's own setting
    (this harness turns them on)."""
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    paddle.seed(0)
    with jax.enable_x64(False):
        jm = JaxSeq2Seq(**KW)
    jm.eval()
    path = str(tmp_path_factory.mktemp("seq2seq") / "seq2seq_tiny.pdparams")
    paddle.save(jm.state_dict(), path)
    return jm, path


def _port(path):
    return convert.load_seq2seq(path, **KW).eval()


def _jt(a):
    return paddle.to_tensor(a)


@contextlib.contextmanager
def _fused_layernorm(on, monkeypatch):
    monkeypatch.setattr(jax_flags._REGISTRY["use_fused_layernorm"], "value", on)
    monkeypatch.setattr(flags._REGISTRY["use_fused_layernorm"], "value", on)
    yield


# -- names, signatures, masks ------------------------------------------------------

def _pinned(prefix):
    spec = os.path.join(os.path.dirname(__file__), os.pardir, "tools", "api_spec.txt")
    out = {}
    with open(spec) as f:
        for line in f:
            if line.startswith(prefix):
                name, _, sig = line.strip().removeprefix(prefix).partition("(")
                out[name] = "(" + sig
    return out


@pytest.mark.parametrize("qualified,extended", [
    ("nn.TransformerDecoderLayer", True), ("nn.TransformerDecoder", False),
    ("nn.Transformer", True), ("models.TransformerSeq2Seq", True),
    ("generation.decode_loop", False)])
def test_pinned_signatures_extended_only_by_generator_and_device(qualified, extended):
    """Each name resolves in the port with ``tools/api_spec.txt``'s
    signature, plus ``generator=None, device=None`` for the modules that
    draw parameters."""
    ns, _, name = qualified.rpartition(".")
    want = _pinned(f"paddle_tpu.{ns}.")[name]
    obj = getattr({"nn": port_nn, "models": paddle_tpu_torch.models,
                   "generation": port_generation}[ns], name)
    if extended:
        want = want[:-1] + ", generator=None, device=None)"
    assert str(inspect.signature(obj)) == want


def test_state_dict_matches_and_pos_enc_is_checked(saved):
    jm, path = saved
    tm = _port(path)
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    np.testing.assert_array_equal(tm.pos_enc.numpy(), np.asarray(jm.pos_enc.numpy()))
    np.testing.assert_array_equal(port_seq2seq._positional_encoding(MAX_LEN, D),
                                  np.asarray(jm.pos_enc.numpy()))
    state = paddle.load(path, return_numpy=True)
    state["pos_enc"] = state["pos_enc"] + np.float32(1e-6)
    with pytest.raises(ValueError, match="pos_enc"):
        convert.seq2seq_state_from_numpy(state, TransformerSeq2Seq(**KW))
    state = paddle.load(path, return_numpy=True)
    del state["out_proj.bias"]
    with pytest.raises(KeyError, match="out_proj.bias"):
        convert.seq2seq_state_from_numpy(state, TransformerSeq2Seq(**KW))


def test_square_subsequent_mask_matches_jax_on_the_callers_device():
    got = port_nn.Transformer.generate_square_subsequent_mask(6, device="cpu")
    want = np.asarray(jax_tf.Transformer.generate_square_subsequent_mask(6).numpy())
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    meta = port_nn.Transformer.generate_square_subsequent_mask(6, device="meta")
    assert meta.device.type == "meta" and meta.shape == (6, 6)


def test_transformer_base_defaults_and_embedding_init():
    """The defaults are Transformer-base; the seq2seq embeddings draw
    N(0, d**-0.5) from the model's generator, the same table from the same
    seed."""
    t = port_nn.Transformer(generator=torch.Generator().manual_seed(0))
    assert (t.d_model, t.nhead, len(t.encoder.layers), len(t.decoder.layers)) == (512, 8, 6, 6)
    assert t.encoder.layers[0].linear1.out_features == 2048
    a, b = (TransformerSeq2Seq(500, 500, d_model=64, generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a.src_emb.weight, b.src_emb.weight)
    assert abs(float(a.src_emb.weight.std()) - 64 ** -0.5) < 0.01
    assert not torch.equal(a.src_emb.weight, a.tgt_emb.weight)


def test_kv_cache_and_missing_memory_raise():
    """The int8 and paged caches run through a decoder layer's
    self-attention (once they raised): the paged one as the ring does, bit
    for bit. A layer without its memory, and ring attention, still raise;
    ``kdim`` (once it raised) gives the key projection its own width."""
    from paddle_tpu_torch.nn.transformer import (
        PagedStaticCache,
        QuantizedStaticCache,
        StaticCache,
    )

    layer = port_nn.TransformerDecoderLayer(D, HEADS, FFN, dropout=0.0).eval()
    x = torch.randn(1, 3, D, generator=torch.Generator().manual_seed(1))
    pos = torch.zeros(1, dtype=torch.int32)
    hd = D // HEADS
    with torch.no_grad():
        q = QuantizedStaticCache(torch.zeros(1, HEADS, 4, hd, dtype=torch.int8),
                                 torch.zeros(1, HEADS, 4, hd, dtype=torch.int8),
                                 torch.zeros(1, HEADS, 4), torch.zeros(1, HEADS, 4), pos)
        out8, c8 = layer(x, x, cache=q)
        ring = layer.self_attn(x, cache=StaticCache(torch.zeros(1, HEADS, 4, hd),
                                                    torch.zeros(1, HEADS, 4, hd), pos))[0]
        paged = layer.self_attn(x, cache=PagedStaticCache(
            torch.zeros(3, HEADS, 2, hd), torch.zeros(3, HEADS, 2, hd),
            torch.tensor([[2, 1]], dtype=torch.int32), pos))[0]
    assert c8 is q and out8.shape == x.shape and torch.isfinite(out8).all()
    assert bool(q.k.any()) and torch.equal(paged, ring)
    with pytest.raises(ValueError, match="with_cross_attention=False"):
        layer(x)
    assert tuple(port_nn.MultiHeadAttention(D, HEADS, kdim=16).k_proj.weight.shape) == (16, D)
    with pytest.raises(NotImplementedError, match="ring"):
        port_nn.MultiHeadAttention(D, HEADS, use_ring_attention=True)


# -- the decoder layer ---------------------------------------------------------------

@pytest.mark.parametrize("cross", [True, False])
@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_decoder_layer_matches_jax(monkeypatch, cross, normalize_before, fused):
    """One decoder layer from the JAX layer's weights: causal self-attention
    (and cross-attention over a padded memory), post- or pre-norm, the
    fused LayerNorm on and off in both packages. Without cross-attention
    the layer holds no cross-attention parameters and takes no memory."""
    rng = np.random.RandomState(5)
    tgt = rng.randn(2, 5, D).astype("f4")
    mem = rng.randn(2, 6, D).astype("f4")
    mem_mask = np.zeros((2, 1, 1, 6), "f4")
    mem_mask[1, ..., 4:] = -1e9
    causal = np.triu(np.full((5, 5), -1e9, "f4"), 1)
    with _fused_layernorm(fused, monkeypatch):
        paddle.seed(3)
        jl = jax_tf.TransformerDecoderLayer(D, HEADS, FFN, dropout=0.0,
                                            normalize_before=normalize_before,
                                            with_cross_attention=cross)
        jl.eval()
        tl = port_nn.TransformerDecoderLayer(D, HEADS, FFN, dropout=0.0,
                                             normalize_before=normalize_before,
                                             with_cross_attention=cross).eval()
        np_state = {n: np.asarray(p.numpy()) for n, p in jl.state_dict().items()}
        tl.load_state_dict(convert._state_from_numpy(np_state, tl))
        if cross:
            want = jl(_jt(tgt), _jt(mem), _jt(causal), _jt(mem_mask))
            got = tl(*map(torch.from_numpy, (tgt, mem, causal, mem_mask)))
        else:
            assert not any("cross_attn" in n or "norm2" in n for n in tl.state_dict())
            want = jl(_jt(tgt), None, _jt(causal))
            got = tl(torch.from_numpy(tgt), None, torch.from_numpy(causal))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want.numpy()), atol=1e-5,
                               rtol=1e-5)


def test_fused_layernorm_runs_once_a_post_norm_pair(monkeypatch):
    """A post-norm forward of the seq2seq model calls the fused op 2 times an
    encoder layer and 3 times a decoder layer; a pre-norm layer never."""
    calls = []
    real = tlnr.layernorm_residual
    monkeypatch.setattr(tlnr, "layernorm_residual", lambda *a, **k: calls.append(1) or real(
        *a, **k))
    m = TransformerSeq2Seq(**KW, generator=torch.Generator().manual_seed(0))
    src, tgt = _src_tgt()
    m(torch.from_numpy(src), torch.from_numpy(tgt))
    assert len(calls) == 2 * LAYERS + 3 * LAYERS
    calls.clear()
    layer = port_nn.TransformerDecoderLayer(D, HEADS, FFN, dropout=0.0, normalize_before=True)
    layer(torch.zeros(1, 3, D), torch.zeros(1, 2, D))
    assert not calls


# -- the model -------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_teacher_forced_logits_match_jax(saved, monkeypatch, fused):
    jm, path = saved
    src, tgt = _src_tgt()
    with _fused_layernorm(fused, monkeypatch):
        want = np.asarray(jm(_jt(src), _jt(tgt)).numpy())
        tm = _port(path)
        got = tm(torch.from_numpy(src), torch.from_numpy(tgt)).detach().numpy()
    assert got.shape == (3, 7, V)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL, rtol=0)


def _jax_step_logits(jm, src, ys):
    """The JAX model's next-token logits for ``ys`` (the decode loop's)."""
    memory = jm.encode(_jt(src))
    return np.asarray(jm.decode_logits(memory, jm._pad_mask(_jt(src)), _jt(ys))[:, -1].numpy())


def test_greedy_decode_tokens_equal_jax(saved):
    jm, path = saved
    src, _ = _src_tgt()
    want = np.asarray(jm.greedy_decode(_jt(src), max_len=8).numpy())
    got = _port(path).greedy_decode(torch.from_numpy(src), max_len=8)
    assert got.dtype == torch.int64 and got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # the comparison is sound: every step's top two logits are well apart
    for t in range(1, 8):
        top2 = np.sort(_jax_step_logits(jm, src, want[:, :t]), axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 100 * LOGITS_ATOL
    assert len(set(want[:, 1:].ravel().tolist())) > 2  # not one token repeated


def test_greedy_decode_stops_at_eos(saved):
    """``stop_at_eos``: the host reads each step's tokens and stops once
    every row has emitted EOS, as the JAX loop does."""
    jm, path = saved
    tm = _port(path)
    src, _ = _src_tgt()
    with torch.no_grad():
        tm.out_proj.bias[EOS] += 1e3  # every row emits EOS first
    got = tm.greedy_decode(torch.from_numpy(src), max_len=8, stop_at_eos=True)
    assert got.shape == (3, 2) and (got[:, 1] == EOS).all()
    assert tm.greedy_decode(torch.from_numpy(src), max_len=8).shape == (3, 8)


def test_decode_loop_takes_the_first_index_among_ties():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    ys = port_generation.decode_loop(lambda ys: logits, torch.zeros(2, 1, dtype=torch.int64), 3)
    assert ys.tolist() == [[0, 1, 1], [0, 0, 0]]


def test_beam_search_matches_jax(saved):
    jm, path = saved
    src, _ = _src_tgt()
    w_seqs, w_scores = jm.beam_search(_jt(src), beam_size=3, max_len=8)
    seqs, scores = _port(path).beam_search(torch.from_numpy(src), beam_size=3, max_len=8)
    w_seqs = np.asarray(w_seqs)
    assert seqs.dtype == torch.int32 and str(w_seqs.dtype) == "int32"
    assert seqs.shape == (7, 3, 3) and scores.shape == (3, 3)
    np.testing.assert_array_equal(seqs.numpy(), w_seqs)
    np.testing.assert_allclose(scores.numpy(), np.asarray(w_scores), atol=SCORE_ATOL, rtol=0)
    # the best hypothesis reads as a sequence of real tokens
    assert (seqs.numpy() < V).all() and (seqs.numpy() >= 0).all()


def _jax_beam_step(logp, scores, k, first):
    return [np.asarray(a) for a in jax_kernel("beam_search_step")(
        jnp.asarray(logp), jnp.asarray(scores), beam_size=k, first_step=first)]


@pytest.mark.parametrize("first", [True, False])
def test_beam_search_step_orders_ties_as_lax_top_k(first):
    """Ties as beam search makes them: most probabilities clamp to
    ``log(1e-9)``, and two beams carry equal scores. Among equal totals
    ``lax.top_k`` puts the lower flat index first; the port must too."""
    b, k, v = 2, 4, 6
    logp = np.full((b, k, v), np.log(np.float32(1e-9)), "f4")
    logp[0, :, 2] = -0.5
    logp[0, 1, 4] = -0.5
    logp[1, 2, :] = -1.0
    scores = np.array([[-1.0, -1.0, -2.0, -1.0], [-3.0, -3.0, -3.0, -3.0]], "f4")
    want = _jax_beam_step(logp, scores, k, first)
    got = port_kernel("beam_search_step")(torch.from_numpy(logp), torch.from_numpy(scores),
                                          beam_size=k, first_step=first)
    assert [g.dtype for g in got] == [torch.float32, torch.int32, torch.int32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if not first:  # the case is a tie case: some kept totals are equal
        assert len(set(want[0][0].tolist())) < k


def test_beam_search_decode_matches_jax():
    rng = np.random.RandomState(2)
    t, b, k = 6, 3, 4
    parents = rng.randint(0, k, (t, b, k)).astype("int32")
    tokens = rng.randint(0, V, (t, b, k)).astype("int32")
    final = rng.randn(b, k).astype("f4")
    w_seqs, w_final = jax_kernel("beam_search_decode")(jnp.asarray(parents),
                                                       jnp.asarray(tokens), jnp.asarray(final))
    seqs, got_final = port_kernel("beam_search_decode")(
        torch.from_numpy(parents), torch.from_numpy(tokens), torch.from_numpy(final))
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(w_seqs))
    assert seqs.dtype == torch.int32
    np.testing.assert_array_equal(got_final.numpy(), final)


# -- training -----------------------------------------------------------------------------

def _masked_ce(functional):
    """The pad-masked cross entropy of ``tests/test_book.py``'s WMT14 test,
    for either package."""
    def loss_fn(m, s, ti, tn):
        logits = m(s, ti)
        mask = (tn != PAD).astype("float32") if hasattr(tn, "astype") else (tn != PAD).float()
        ce = functional.cross_entropy(logits.reshape([-1, V]), tn.reshape([-1]),
                                      reduction="none")
        return (ce * mask.reshape([-1])).sum() / mask.sum()
    return loss_fn


def _train_batch(seed=4):
    src, tgt = _src_tgt(b=4, seed=seed)
    tgt_next = np.concatenate([tgt[:, 1:], np.full((4, 1), EOS, "int64")], axis=1)
    tgt_next[3, 4:] = PAD  # padded target positions count nowhere
    return [src, tgt, tgt_next]


# Adam (beta2 0.98, epsilon 1e-9, lr 1e-3), three steps from the same
# weights. The losses agree to f32 rounding carried through three steps
# (read 7.2e-7 apart). The parameters are held by their updates (after -
# before), leaving out the attention's key biases: their gradient is zero
# up to rounding (softmax ignores a shift along a row), and Adam turns
# rounding into lr-sized steps of either sign there, in either package, so
# the two updates are held to 6 lr apart (each within 3 lr). Against the JAX step with 64-bit
# types on (this harness's setting) the port's updates are the same to f32
# rounding (read: relative L2 2.0e-6, no entry 1e-5 apart). With them off
# (the JAX package's own setting) the JAX step itself moves: Adam turns
# the other rounding of its first encoder layer's gradients into update
# differences up to 3.5e-4 on 0.25% of the entries (relative L2 9.4e-4),
# the same distance from the port's as from its own 64-bit run.
TRAIN_LOSS_ATOL = 1e-5
ADAM = dict(learning_rate=1e-3, beta1=0.9, beta2=0.98, epsilon=1e-9)
UPDATE_LIMITS = {True: dict(rel_l2=1e-5, apart=0.0), False: dict(rel_l2=5e-3, apart=0.01)}
UPDATE_APART = 1e-5  # an entry's update this far from the JAX one's counts as apart
KEY_BIAS_GRAD_OF_LAYER = 1e-5  # the key bias's gradient, of its layer's largest entry


@pytest.mark.parametrize("x64", [False, True])
def test_three_adam_steps_match_jax_train_step(saved, x64):
    jm0, path = saved
    jm = copy.deepcopy(jm0)
    init = {n: np.asarray(p.numpy()).astype("f8") for n, p in jm.named_parameters()}
    batch = _train_batch()
    with jax.enable_x64(x64):
        jstep = jax_jit.train_step(jm, jax_opt.Adam(parameters=jm.parameters(), **ADAM),
                                   _masked_ce(jF), jit=False)
        want = [float(np.asarray(jstep(*batch)["loss"])) for _ in range(3)]
        jstep.sync()
    tm = _port(path)
    tstep = train_step(tm, port_opt.Adam(parameters=tm.parameters(), **ADAM), _masked_ce(F),
                       jit=False, device="cpu")
    got = [float(tstep(*batch)["loss"])]
    grads = {n: p.grad.abs().max().item() for n, p in tm.named_parameters()}
    got += [float(tstep(*batch)["loss"]) for _ in range(2)]
    assert got[2] < got[0]
    np.testing.assert_allclose(got, want, atol=TRAIN_LOSS_ATOL, rtol=0)
    jparams = dict(jm.named_parameters())
    num = den = 0.0
    apart = total = 0
    for name, p in tm.named_parameters():
        step_jax = np.asarray(jparams[name].numpy()).astype("f8") - init[name]
        d = p.detach().numpy().astype("f8") - init[name] - step_jax
        if name.endswith("k_proj.bias"):
            layer = name.rpartition(".")[0].rpartition(".")[0]
            largest = max(g for n, g in grads.items() if n.startswith(layer + "."))
            assert grads[name] <= KEY_BIAS_GRAD_OF_LAYER * largest, name
            assert np.abs(d).max() <= 6 * ADAM["learning_rate"], name
            continue
        num, den = num + float((d ** 2).sum()), den + float((step_jax ** 2).sum())
        apart, total = apart + int((np.abs(d) > UPDATE_APART).sum()), total + d.size
    lim = UPDATE_LIMITS[x64]
    assert (num / den) ** 0.5 <= lim["rel_l2"] and apart / total <= lim["apart"], (
        (num / den) ** 0.5, apart / total)


# -- AMP ----------------------------------------------------------------------------------

_KERNEL_OPS = {"fused_layernorm_residual", "flash_attention"}
_CARRY_OPS = {"layer_norm", "gelu", "lookup_table"}
_RECORDED = jamp.WHITE_LIST | jamp.BLACK_LIST | _KERNEL_OPS | _CARRY_OPS


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _dtypes(xs):
    return tuple(_dtype_name(x.dtype) for x in xs if x is not None)


def _first_dtype(out):
    return _dtype_name((out[0] if isinstance(out, (tuple, list)) else out).dtype)


@contextlib.contextmanager
def _jax_flow(monkeypatch):
    """[op, input dtypes after the cast, first output dtype] of every op the
    JAX package dispatches (its hook and ``apply_op`` wrapped)."""
    rec = []
    hook, apply_op = jax_autograd._amp_hook, jax_autograd.apply_op

    def recording_hook(op_type, arrays):
        out = hook(op_type, arrays)
        rec.append([op_type, _dtypes(out)])
        return out

    def recording_apply_op(op_type, *args, **kw):
        n = len(rec)
        out = apply_op(op_type, *args, **kw)
        rec[n].append(_first_dtype(out))
        return out

    monkeypatch.setattr(jax_autograd, "apply_op", recording_apply_op)
    monkeypatch.setattr(jax_ops, "apply_op", recording_apply_op)
    jax_autograd.set_amp_hook(recording_hook)
    try:
        yield rec
    finally:
        jax_autograd.set_amp_hook(hook)


@contextlib.contextmanager
def _port_flow(monkeypatch):
    """The same record of the port's ops: its hook and its op functions."""
    rec = []
    hook = port_autograd._amp_hook

    def recording_hook(op_type, tensors):
        out = hook(op_type, tensors)
        rec.append([op_type, _dtypes(out)])
        return out

    def wrap(fn):
        def call(*args, **kw):
            n = len(rec)
            out = fn(*args, **kw)
            if len(rec) > n:
                rec[n].append(_first_dtype(out))
            return out
        return call

    for mod, name in [(F, n) for n in ("linear", "matmul", "softmax", "layer_norm", "embedding",
                                       "cross_entropy")] + [(tlnr, "layernorm_residual")]:
        monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    port_autograd.set_amp_hook(recording_hook)
    try:
        yield rec
    finally:
        port_autograd.set_amp_hook(hook)


def _amp_loss(amp_mod, functional):
    loss = _masked_ce(functional)

    def loss_fn(m, *batch):
        with amp_mod.auto_cast():
            return loss(m, *batch)
    return loss_fn


def test_amp_forward_dtype_flow_matches_jax(saved, monkeypatch):
    """The forward and the masked loss under ``auto_cast`` (O1): every
    recorded op in the same order with the same dtypes. The products are
    bf16; the cross-attention's pad mask and the causal mask are added in
    q's dtype (bf16) and the softmax takes f32; each stack's first residual
    LayerNorm is the mixed case (a bf16 sublayer output on the f32
    embedding sum), every later one bf16; the loss takes the bf16 logits to
    f32."""
    jm, path = saved
    batch = _train_batch()
    # 64-bit types on, so that the JAX ids are int64 as torch's are (off,
    # they are int32); no float dtype depends on it
    with jax.enable_x64(True), _jax_flow(monkeypatch) as jrec:
        _amp_loss(jamp, jF)(jm, *map(_jt, batch))
    # the loss's two f32 sums are tensor methods: the JAX Tensor's dispatch
    # reduce_sum, the port's are torch's own
    want = [tuple(r) for r in jrec if r[0] in _RECORDED]
    assert want[-2:] == [("reduce_sum", ("float32",), "float32")] * 2
    want = want[:-2]
    tm = _port(path)
    with _port_flow(monkeypatch) as trec:
        _amp_loss(pamp, F)(tm, *map(torch.from_numpy, batch))
    got = [tuple(r) for r in trec if r[0] in _RECORDED]
    assert got == want
    ops = [r[0] for r in got]
    assert ops.count("fused_layernorm_residual") == 2 * LAYERS + 3 * LAYERS
    mixed = [r for r in got if r[0] == "fused_layernorm_residual"
             and r[1][:2] == ("bfloat16", "float32")]
    assert len(mixed) == 2  # the first norm of each stack
    assert ops.count("softmax") == 3 * LAYERS
    assert all(r[1] == ("float32",) and r[2] == "float32" for r in got if r[0] == "softmax")
    ce = [r for r in got if r[0] == "cross_entropy"]
    assert ce == [("cross_entropy", ("float32", "int64"), "float32")]


# The AMP logits against the JAX package's under auto_cast, both run op by
# op on the CPU, relative to the largest |logit|: read 0 (the same bf16
# roundings); the port's f32 logits are 7.0e-3 away, which the limit must
# reject.
AMP_LOGITS_REL = 2e-4


def test_amp_forward_values_match_jax(saved):
    jm, path = saved
    src, tgt = _src_tgt()
    with jamp.auto_cast():
        want = np.asarray(jm(_jt(src), _jt(tgt)).numpy()).astype("f4")
    tm = _port(path)
    with pamp.auto_cast():
        got = tm(torch.from_numpy(src), torch.from_numpy(tgt))
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    err = np.abs(got.float().detach().numpy() - want).max() / scale
    f32 = tm(torch.from_numpy(src), torch.from_numpy(tgt)).detach().numpy()
    control = np.abs(f32 - want).max() / scale
    assert err <= AMP_LOGITS_REL < control, (err, control)


# -- the card's paths -----------------------------------------------------------------------

def test_card_paths_raise_on_meta_tensors(saved):
    """Off the CPU the fused LayerNorm must run its kernel: on ``meta``
    tensors (neither CPU nor CUDA) the forward and both decoders raise
    instead of running the plain version."""
    _, path = saved
    tm = _port(path).to("meta")
    src, tgt = (torch.from_numpy(a).to("meta") for a in _src_tgt())
    for call in (lambda: tm(src, tgt), lambda: tm.greedy_decode(src, max_len=3),
                 lambda: tm.beam_search(src, beam_size=2, max_len=3)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_entry_points_without_a_card_raise(saved, monkeypatch):
    _, path = saved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = _port(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_step(tm, port_opt.Adam(parameters=tm.parameters()), _masked_ce(F))
