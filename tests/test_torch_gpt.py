"""Port parity: GPT, the ring KV cache and the cached attention (``paddle_tpu_torch``).

A tiny GPT (``gpt_tiny_config()``: 2 layers, 64 wide, 4 heads, a 211-token
vocabulary, dropout 0) built by the JAX package from a seed; its weights
cross as numpy through ``convert.gpt_state_from_numpy`` (and, in the save
tests, through ``save_gpt_model`` directories both ways); the inputs are
the same numpy arrays. The JAX side runs on the CPU with 64-bit types off,
the JAX package's own setting. Covered: the logits; the masks and the ring
writes bit for bit, without and across a wrap (the JAX writes are
functional, the port's in place); decoding through the cache against the
full forward (``tests/test_generation.py:187-211``'s goldens) and against
the JAX decode; the decoder layer's cached paths pre- and post-norm and the
concat cache; the cache helpers; the saved directories; the layer-skip
draft; and the caches that are not ported raising.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu.generation import cache as jcache  # noqa: E402
from paddle_tpu.nn import transformer as jtf  # noqa: E402

from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import models as pmodels  # noqa: E402
from paddle_tpu_torch.errors import UnimplementedError  # noqa: E402
from paddle_tpu_torch.generation import cache as pcache  # noqa: E402
from paddle_tpu_torch.nn import transformer as ptf  # noqa: E402

torch.set_num_threads(1)

# f32 through 2 layers and the tied head in another summation order:
# logits of magnitude ~1 read ~1e-6 apart
LOGITS_ATOL = 1e-5
# the cached decode against the full forward: the JAX package's golden
# tolerance (tests/test_generation.py), one program against another
CACHE_ATOL = 2e-4


@pytest.fixture(autouse=True)
def _x64_off():
    """The JAX side with 64-bit types off, the JAX package's own setting
    (this harness turns them on)."""
    with jax.enable_x64(False):
        yield


def _jax_lm(window=None, seed=3, layers=None):
    paddle.seed(seed)
    cfg = jmodels.gpt_tiny_config()
    cfg.attention_window = window
    if layers is not None:
        cfg.num_hidden_layers = layers
    m = jmodels.GPTForCausalLM(cfg)
    m.eval()
    return m


def _np_state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_lm(jm):
    cfg = pmodels.GPTConfig(**vars(jm.config))
    pm = pmodels.GPTForCausalLM(cfg)
    pm.load_state_dict(convert.gpt_state_from_numpy(_np_state(jm), pm))
    return pm.eval()


def _jax_logits(jm, ids, **kw):
    return np.asarray(jm(np.asarray(ids, "int32"), **kw).numpy())


def _port_logits(pm, ids):
    with torch.no_grad():
        return pm(torch.as_tensor(np.asarray(ids, np.int64))).numpy()


# -- the model --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 6])
def test_logits_match_jax(window):
    jm = _jax_lm(window)
    pm = _port_lm(jm)
    ids = np.random.RandomState(5).randint(3, 200, size=(2, 17))
    got, want = _port_logits(pm, ids), _jax_logits(jm, ids)
    assert got.shape == want.shape == (2, 17, 211)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_ATOL)


def test_state_dict_names_shapes_and_tied_head():
    jm = _jax_lm()
    pm = _port_lm(jm)
    jstate = _np_state(jm)
    pstate = pm.state_dict()
    assert list(pstate) == list(jstate)
    assert all(tuple(pstate[k].shape) == jstate[k].shape for k in jstate)
    # the head is the word embedding table, named once
    assert not any("lm_head" in k or "decoder" in k for k in pstate)
    assert pm.cache_spec() == jm.cache_spec() == (2, 4, 16)


def test_default_config_is_gpt2_small():
    cfg = pmodels.GPTConfig()
    assert vars(cfg) == vars(jmodels.GPTConfig())
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.max_position_embeddings, cfg.vocab_size) == (
        12, 768, 12, 3072, 1024, 50304)


# -- masks ------------------------------------------------------------------------------


@pytest.mark.parametrize("length,window", [(1, None), (9, None), (9, 4), (17, 6), (5, 1)])
def test_causal_mask_bit_equal(length, window):
    got = ptf.causal_mask(length, window=window).numpy()
    want = np.asarray(jtf.causal_mask(length, window=window).numpy())
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("store,window", [(4, None), (6, None), (8, 6), (9, 4)])
def test_decode_and_verify_masks_bit_equal(store, window):
    pos = np.array([0, 2, 3, 5, 7, 11, 30], np.int32)
    got = pcache.decode_mask(torch.from_numpy(pos), store, window=window).numpy()
    want = np.asarray(jcache.decode_mask(jnp.asarray(pos), store, window=window))
    assert got.shape == want.shape == (7, 1, 1, store) and np.array_equal(got, want)
    got = pcache.verify_mask(torch.from_numpy(pos), store, 3, window=window).numpy()
    want = np.asarray(jcache.verify_mask(jnp.asarray(pos), store, 3, window=window))
    assert got.shape == want.shape == (7, 1, 3, store) and np.array_equal(got, want)


@pytest.mark.parametrize("bucket,cache_len,length", [(4, 6, 3), (8, 8, 8), (8, 16, 1),
                                                     (16, 16, 11)])
def test_prefill_mask_bit_equal(bucket, cache_len, length):
    want = np.asarray(jcache.prefill_mask(bucket, cache_len, jnp.asarray(length)))
    for n in (length, torch.tensor([length])):  # a number, or a device input of one element
        got = pcache.prefill_mask(bucket, cache_len, n).numpy()
        assert got.shape == want.shape == (1, 1, bucket, cache_len)
        assert np.array_equal(got, want)


# -- ring writes ------------------------------------------------------------------------


def _ring_case(c, pos, t, seed):
    rng = np.random.RandomState(seed)
    b, h, d = len(pos), 2, 8
    kc = rng.randn(b, h, c, d).astype(np.float32)
    vc = rng.randn(b, h, c, d).astype(np.float32)
    k = rng.randn(b, h, t, d).astype(np.float32)
    v = rng.randn(b, h, t, d).astype(np.float32)
    return kc, vc, np.asarray(pos, np.int32), k, v


@pytest.mark.parametrize("c,pos,t", [
    (6, [0, 3], 1),          # decode, no wrap
    (4, [5, 7], 1),          # decode past the window: ring indices 1 and 3
    (8, [0, 2], 5),          # a prefill span, no wrap
    (6, [4, 9], 4),          # a span across the wrap, rows at their own offsets
])
def test_ring_writes_bit_equal(c, pos, t):
    """The step's keys and values land where the JAX scatter puts them,
    bit for bit (the ``[B, T, H, D]`` payload of the split advanced index),
    in the port's cache tensors themselves."""
    kc, vc, p, k, v = _ring_case(c, pos, t, seed=c + t)
    jmha = jtf.MultiHeadAttention(16, 2)
    jk, jv, jnew = jmha._update_static_cache(
        jtf.StaticCache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(p)),
        paddle.to_tensor(k), paddle.to_tensor(v))
    cache = ptf.StaticCache(torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
                            torch.from_numpy(p))
    pk, pv, pnew = ptf.MultiHeadAttention._update_static_cache(
        cache, torch.from_numpy(k), torch.from_numpy(v))
    assert pk is cache.k and pv is cache.v and pnew is cache  # in place
    assert np.array_equal(pk.numpy(), np.asarray(jnew.k))
    assert np.array_equal(pv.numpy(), np.asarray(jnew.v))
    assert np.array_equal(pk.numpy(), np.asarray(jk.numpy()))
    changed = np.nonzero((pk.numpy() != kc).any(axis=(1, 3)))
    assert len(changed[0]) == len(pos) * min(t, c)


# -- decoding through the cache ------------------------------------------------------


def _incremental(m, ids, cache_len, jax_side):
    """Token-by-token decode through the ring (the JAX package's golden
    loop): logits per position."""
    spec = m.cache_spec()
    if jax_side:
        ck, cv, pos = jcache.init_cache(spec[0], 1, spec[1], cache_len, spec[2])
    else:
        ck, cv, pos = pcache.init_cache(spec[0], 1, spec[1], cache_len, spec[2])
    outs = []
    for t, tok in enumerate(ids):
        if jax_side:
            caches = jcache.layer_caches(ck, cv, pos)
            logits, new = m(np.asarray([[tok]], "int32"), position_ids=np.asarray([[t]], "int32"),
                            attention_mask=jnp.asarray(jcache.decode_mask(pos, cache_len)),
                            caches=caches)
            ck, cv = jcache.stack_layer_caches(new)
            pos = pos + 1
            outs.append(np.asarray(logits.numpy())[0, 0])
        else:
            with torch.no_grad():
                logits, _ = m(torch.tensor([[tok]]), position_ids=torch.tensor([[t]]),
                              attention_mask=pcache.decode_mask(pos, cache_len),
                              caches=pcache.layer_caches(ck, cv, pos))
            pos.add_(1)
            outs.append(logits.numpy()[0, 0])
    return np.stack(outs)


@pytest.mark.parametrize("window,cache_len,n", [(None, 16, 10), (6, 6, 17)])
def test_cached_decode_matches_full_forward_and_jax(window, cache_len, n):
    """Within the window and past it (the ring keeps the last C tokens, the
    full forward's sliding window of width C): the port's cached decode
    equals its full forward and the JAX cached decode."""
    jm = _jax_lm(window)
    pm = _port_lm(jm)
    ids = np.random.RandomState(7).randint(3, 200, size=n)
    full = _port_logits(pm, ids[None])[0]
    inc = _incremental(pm, ids, cache_len, jax_side=False)
    np.testing.assert_allclose(inc, full, rtol=0, atol=CACHE_ATOL)
    np.testing.assert_allclose(inc, _incremental(jm, ids, cache_len, jax_side=True), rtol=0,
                               atol=LOGITS_ATOL)
    if window is not None:  # the control: without the window the past-wrap positions part
        wide = pmodels.GPTForCausalLM(pmodels.GPTConfig(**{**vars(pm.config),
                                                           "attention_window": None}))
        wide.load_state_dict(pm.state_dict())
        far = np.abs(inc - _port_logits(wide.eval(), ids[None])[0])[cache_len:].max()
        assert far > 100 * CACHE_ATOL, far


@pytest.mark.parametrize("normalize_before", [True, False])
def test_decoder_layer_cached_paths_match_jax(normalize_before):
    """A decoder-only layer decoding 5 steps through a ring (C = 4: it
    wraps) and through the concat cache, pre-norm (GPT's plain LayerNorms)
    and post-norm (the fused residual LayerNorm's plain version on the
    CPU), against the JAX layer on the same weights."""
    paddle.seed(11)
    jl = jtf.TransformerDecoderLayer(16, 2, 32, dropout=0.0, normalize_before=normalize_before,
                                     with_cross_attention=False)
    jl.eval()
    pl = ptf.TransformerDecoderLayer(16, 2, 32, dropout=0.0, normalize_before=normalize_before,
                                     with_cross_attention=False)
    pl.load_state_dict(convert._state_from_numpy(
        {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}, pl))
    pl.eval()
    xs = np.random.RandomState(2).randn(5, 2, 1, 16).astype(np.float32)
    jring = jl.self_attn.gen_static_cache(2, 4)
    pring = pl.self_attn.gen_static_cache(2, 4)
    jcat = jl.self_attn.gen_cache(paddle.to_tensor(xs[0]))
    pcat = pl.self_attn.gen_cache(torch.from_numpy(xs[0]))
    for step, x in enumerate(xs):
        pos = np.full(2, step, np.int32)
        jring = jtf.StaticCache(jring.k, jring.v, jnp.asarray(pos))
        pring = ptf.StaticCache(pring.k, pring.v, torch.from_numpy(pos))
        jmask = jcache.decode_mask(jnp.asarray(pos), 4)
        jout, jring = jl(paddle.to_tensor(x), tgt_mask=paddle.to_tensor(np.asarray(jmask)),
                         cache=jring)
        with torch.no_grad():
            pout, pring2 = pl(torch.from_numpy(x), tgt_mask=pcache.decode_mask(pring.pos, 4),
                              cache=pring)
        assert pring2 is pring
        np.testing.assert_allclose(pout.numpy(), np.asarray(jout.numpy()), rtol=0, atol=1e-5)
        np.testing.assert_allclose(pring.k.numpy(), np.asarray(jring.k), rtol=0, atol=1e-5)
        jout, jcat = jl(paddle.to_tensor(x), cache=jcat)
        with torch.no_grad():
            pout, pcat = pl(torch.from_numpy(x), cache=pcat)
        np.testing.assert_allclose(pout.numpy(), np.asarray(jout.numpy()), rtol=0, atol=1e-5)
        assert pcat[0].shape == (2, 2, step + 1, 8)


# -- cache helpers -------------------------------------------------------------------


def test_insert_slot_in_place_with_device_inputs():
    """``insert_slot`` installs a slot's planes and length into the live
    tensors (slot and length as tensors of one element, the captured
    prefill's inputs), equal to the JAX functional update."""
    rng = np.random.RandomState(0)
    ck, cv, pos = pcache.init_cache(2, 3, 2, 5, 4)
    ptrs = [t.data_ptr() for t in (ck, cv, pos)]
    new_k = rng.randn(2, 2, 5, 4).astype(np.float32)
    new_v = rng.randn(2, 2, 5, 4).astype(np.float32)
    out = pcache.insert_slot(ck, cv, pos, torch.tensor([1]), torch.from_numpy(new_k),
                             torch.from_numpy(new_v), torch.tensor([4]))
    assert [t.data_ptr() for t in out] == ptrs
    jk, jv, jpos = jcache.init_cache(2, 3, 2, 5, 4)
    jk, jv, jpos = jcache.insert_slot(jk, jv, jpos, 1, jnp.asarray(new_k), jnp.asarray(new_v), 4)
    assert np.array_equal(ck.numpy(), np.asarray(jk))
    assert np.array_equal(cv.numpy(), np.asarray(jv))
    assert np.array_equal(pos.numpy(), np.asarray(jpos)) and pos.dtype == torch.int32
    pcache.insert_slot_kv((ck, cv, pos), 2, (torch.from_numpy(new_k), torch.from_numpy(new_v)), 3)
    assert pos.tolist() == [0, 4, 3] and torch.equal(cv[:, 2], torch.from_numpy(new_v))


def test_cache_sizes_views_and_padding_match_jax():
    kv = pcache.init_cache(3, 2, 4, 16, 8)
    assert [tuple(a.shape) for a in kv] == [(3, 2, 4, 16, 8)] * 2 + [(2,)]
    assert pcache.cache_nbytes(kv) == jcache.cache_nbytes(jcache.init_cache(3, 2, 4, 16, 8))
    for dtype in ("float32", "int8"):
        assert pcache.kv_bytes_per_token(12, 12, 64, dtype) == jcache.kv_bytes_per_token(
            12, 12, 64, dtype)
    assert pcache.kv_bytes_per_token(12, 12, 64) == 73728  # GPT-2 small
    layers = pcache.layer_caches(kv)
    assert len(layers) == 3 and all(c.pos is kv[2] for c in layers)
    layers[1].k.fill_(1.0)  # a view of the stacked tensor
    assert float(kv[0][1].sum()) == 2 * 4 * 16 * 8 and float(kv[0][0].sum()) == 0
    sk, sv = pcache.stack_layer_caches(layers)
    assert torch.equal(sk, kv[0]) and torch.equal(sv, kv[1])
    planes = np.random.RandomState(1).randn(3, 4, 16, 8).astype(np.float32)
    got = pcache.pad_slot_arrays((torch.from_numpy(planes),), 20)[0].numpy()
    want = np.asarray(jcache.pad_slot_arrays((jnp.asarray(planes),), 20)[0])
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        pcache.pad_slot_arrays((torch.from_numpy(planes),), 8)


# -- persistence and the draft ------------------------------------------------------


def test_jax_saved_directory_loads_in_the_port_and_back(tmp_path):
    jm = _jax_lm(window=8)
    jdir = jmodels.save_gpt_model(jm, str(tmp_path / "jax"))
    pm = pmodels.load_gpt_model(jdir)
    assert not pm.training and pm.config.attention_window == 8
    ids = np.random.RandomState(3).randint(3, 200, size=(2, 12))
    want = _jax_logits(jm, ids)
    np.testing.assert_allclose(_port_logits(pm, ids), want, rtol=0, atol=LOGITS_ATOL)
    back = jmodels.load_gpt_model(pmodels.save_gpt_model(pm, str(tmp_path / "port")))
    assert np.array_equal(_jax_logits(back, ids), want)  # the same bits round trip
    path = str(tmp_path / "gpt.pdparams")
    paddle.save(jm.state_dict(), path)
    got = convert.load_gpt(path, pmodels.GPTConfig(**vars(jm.config)))
    assert np.array_equal(_port_logits(got, ids), _port_logits(pm, ids))


def test_truncated_draft_matches_jax():
    jm = _jax_lm()
    pm = _port_lm(jm)
    jd, pd = jmodels.truncated_draft(jm, 1), pmodels.truncated_draft(pm, 1)
    assert pd.config.num_hidden_layers == 1 and not pd.training
    assert torch.equal(pd.gpt.word_embeddings.weight, pm.gpt.word_embeddings.weight)
    ids = np.random.RandomState(4).randint(3, 200, size=(1, 9))
    np.testing.assert_allclose(_port_logits(pd, ids), _jax_logits(jd, ids), rtol=0,
                               atol=LOGITS_ATOL)


# -- what is not ported --------------------------------------------------------------


def test_int8_and_paged_caches_raise_naming_their_entries():
    mha = ptf.MultiHeadAttention(16, 2)
    x = torch.zeros(1, 1, 16)
    pos = torch.zeros(1, dtype=torch.int32)
    cases = [(ptf.QuantizedStaticCache(x, x, x, x, pos), "entry 1"),
             (ptf.PagedStaticCache(x, x, x, pos), "entry 2"),
             (ptf.QuantizedPagedCache(x, x, x, x, x, pos), "entry 2")]
    for cache, entry in cases:
        with pytest.raises(UnimplementedError, match=f"Queue A item 3, {entry}"):
            mha(x, cache=cache)
    with pytest.raises(UnimplementedError, match="Queue A item 3, entry 1"):
        pcache.init_cache(1, 1, 1, 4, 4, dtype="int8")
    with pytest.raises(UnimplementedError, match="Queue A item 3, entry 1"):
        pcache.layer_caches(x, x, x, x, pos)
