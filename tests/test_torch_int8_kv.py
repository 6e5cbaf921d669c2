"""Port parity: the int8 KV cache (``quantize_kv``, ``QuantizedStaticCache``, the int8 ring engine).

A tiny GPT built by the JAX package from a seed (64-bit types off, the JAX
package's setting), its weights moved as numpy through
``convert.gpt_state_from_numpy``. Covered: ``quantize_kv`` and
``dequantize_kv`` bit-equal to the JAX functions on the same input, with
all-zero vectors and constructed half-way ties (both round half to even);
the int8 cache's shapes, bytes and helpers against the JAX ones; the
quantized ring write bit for bit against the JAX write, across a wrap;
int8 incremental decoding against the JAX package's int8 decoding and
against the full forward across a wrap, within the JAX package's envelope
(5% of the logit scale, ``tests/test_quant_e2e.py:113``) with the argmax
equal; the int8 engine's greedy tokens and graph count against the JAX
int8 engine's tokens and ``generation::compile`` count; the flag, the
memory plan byte for byte.

The port's K/V differ from JAX's by ~1e-7, so on different inputs a value
at a .5 boundary can land one int8 step apart: ``quantize_kv`` is held bit
for bit only on the same input, decoding to the envelope.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu import profiler as jprofiler  # noqa: E402
from paddle_tpu.generation import COMPILE_COUNTER as J_COMPILES  # noqa: E402
from paddle_tpu.generation import GenerationEngine as JEngine  # noqa: E402
from paddle_tpu.generation import cache as jcache  # noqa: E402
from paddle_tpu.nn import transformer as jtf  # noqa: E402

from paddle_tpu_torch import convert, flags  # noqa: E402
from paddle_tpu_torch import models as pmodels  # noqa: E402
from paddle_tpu_torch.errors import InvalidArgumentError  # noqa: E402
from paddle_tpu_torch.generation import GenerationEngine  # noqa: E402
from paddle_tpu_torch.generation import cache as pcache  # noqa: E402
from paddle_tpu_torch.nn import transformer as ptf  # noqa: E402
from tests.test_torch_generation import graphs  # noqa: E402,F401

torch.set_num_threads(1)

# the JAX package's int8 envelope: cached int8 logits within this share of
# the largest |logit| of the reference (tests/test_quant_e2e.py:113)
ENVELOPE = 0.05
# the f32 ring against the full forward (the JAX package's golden tolerance)
CACHE_ATOL = 2e-4


@pytest.fixture(autouse=True)
def _x64_off():
    with jax.enable_x64(False):
        yield


def _models(window=16, seed=3):
    paddle.seed(seed)
    cfg = jmodels.gpt_tiny_config()
    cfg.attention_window = window
    jm = jmodels.GPTForCausalLM(cfg)
    jm.eval()
    pm = pmodels.GPTForCausalLM(pmodels.GPTConfig(**vars(cfg)))
    pm.load_state_dict(convert.gpt_state_from_numpy(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}, pm))
    return jm, pm.eval()


def _ties():
    """Vectors of 16 whose ``x / scale * 127`` lands exactly on ``k + 0.5``
    in float32 at several entries (scale 127: the vector holds 127)."""
    cand = (np.arange(127, dtype=np.float32) + np.float32(0.5))
    exact = (cand / np.float32(127.0) * np.float32(127.0)) == cand
    ties = cand[exact]
    assert ties.size >= 16  # enough constructed ties, odd and even k
    assert {int(t) % 2 for t in ties} == {0, 1}
    rows = ties[:45].reshape(3, 15)
    return np.concatenate([rows, np.full((3, 1), 127.0, np.float32)], axis=1) * np.array(
        [[1.0], [-1.0], [1.0]], np.float32)


@pytest.mark.parametrize("case", ["random", "zeros", "ties", "tiny"])
def test_quantize_kv_bit_equal_to_jax(case):
    rng = np.random.RandomState(0)
    x = {"random": lambda: (rng.randn(2, 3, 5, 16) * 4).astype(np.float32),
         "zeros": lambda: np.zeros((2, 1, 3, 8), np.float32),
         "ties": _ties,
         "tiny": lambda: (rng.randn(4, 8) * 1e-9).astype(np.float32)}[case]()
    if case == "zeros":
        x[1, 0, 1] = rng.randn(8)  # zero vectors beside a live one
    q, s = ptf.quantize_kv(torch.from_numpy(x))
    jq, js = jtf.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    back = ptf.dequantize_kv(q, s).numpy()
    assert np.array_equal(back, np.asarray(jtf.dequantize_kv(jq, js)))
    assert np.isfinite(back).all()
    if case == "ties":  # half to even, as jnp.round
        scaled = x / np.abs(x).max(-1, keepdims=True) * np.float32(127.0)
        assert np.array_equal(q.numpy(), np.round(scaled).astype(np.int8))
        assert (np.abs(scaled - np.trunc(scaled)) == 0.5).sum() >= 30
    if case == "zeros":
        assert not back[0].any() and s[0].max().item() == np.float32(ptf.KV_QUANT_EPS)
    bound = s.numpy()[..., None] / 127 / 2 + 1e-6  # half a step of the vector's scale
    assert (np.abs(back - x) <= bound).all()


def test_int8_cache_shapes_bytes_and_helpers_match_jax():
    kv = pcache.init_cache(2, 4, 2, 8, 16, dtype="int8")
    jkv = jcache.init_cache(2, 4, 2, 8, 16, dtype="int8")
    assert len(kv) == 5
    assert [tuple(a.shape) for a in kv] == [tuple(a.shape) for a in jkv]
    assert [str(a.dtype).split(".")[-1] for a in kv] == [str(a.dtype) for a in jkv]
    assert pcache.cache_nbytes(kv) == jcache.cache_nbytes(jkv)
    fp = pcache.init_cache(2, 4, 2, 8, 16)
    assert pcache.cache_nbytes(fp) / pcache.cache_nbytes(kv) > 3.0
    assert pcache.kv_bytes_per_token(2, 2, 16, "int8") == 2 * 2 * 2 * 20
    assert pcache.kv_bytes_per_token(12, 12, 64, "int8") == 19584  # GPT-2 small
    assert pcache.kv_bytes_per_token(12, 12, 64) / 19584 == 73728 / 19584
    layers = pcache.layer_caches(kv)
    assert all(isinstance(c, ptf.QuantizedStaticCache) for c in layers)
    assert all(c.pos is kv[-1] for c in layers)
    stacked = pcache.stack_layer_caches(layers)
    assert len(stacked) == 4 and all(torch.equal(a, b) for a, b in zip(stacked, kv[:-1]))
    rng = np.random.RandomState(1)
    planes = (rng.randint(-127, 128, (2, 2, 8, 16)).astype(np.int8),
              rng.randint(-127, 128, (2, 2, 8, 16)).astype(np.int8),
              rng.rand(2, 2, 8).astype(np.float32), rng.rand(2, 2, 8).astype(np.float32))
    got = pcache.insert_slot_kv(kv, 2, tuple(torch.from_numpy(p) for p in planes), 5)
    assert got is kv
    want = jcache.insert_slot_kv(jkv, 2, tuple(jnp.asarray(p) for p in planes), 5)
    for a, b in zip(kv, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(InvalidArgumentError):
        pcache.insert_slot_kv(kv, 0, planes[:2], 1)
    with pytest.raises(InvalidArgumentError):
        pcache.init_cache(1, 1, 1, 4, 4, dtype="int4")


@pytest.mark.parametrize("t", [1, 5])
def test_quantized_ring_write_bit_equal_to_jax(t):
    """The same K/V written at each row's ``pos`` (row 1 across the wrap of
    a ring of 8): int8 values, scales and the dequantized windows equal to
    the JAX write's."""
    rng = np.random.RandomState(t)
    b, h, c, d = 2, 3, 8, 16
    state = [rng.randint(-127, 128, (b, h, c, d)).astype(np.int8),
             rng.randint(-127, 128, (b, h, c, d)).astype(np.int8),
             rng.rand(b, h, c).astype(np.float32), rng.rand(b, h, c).astype(np.float32)]
    pos = np.array([2, 6], np.int32)
    k = rng.randn(b, h, t, d).astype(np.float32)
    v = rng.randn(b, h, t, d).astype(np.float32)
    pc = ptf.QuantizedStaticCache(*(torch.from_numpy(a.copy()) for a in state),
                                  torch.from_numpy(pos))
    kw, vw, new = ptf.MultiHeadAttention._update_static_cache(pc, torch.from_numpy(k),
                                                              torch.from_numpy(v))
    jc = jtf.QuantizedStaticCache(*(jnp.asarray(a) for a in state), jnp.asarray(pos))
    mha = jtf.MultiHeadAttention(h * d, h)
    jkw, jvw, jnew = mha._update_static_cache(jc, jnp.asarray(k), jnp.asarray(v))
    assert new is pc
    for a, ja in zip(new[:4], jnew[:4]):
        assert np.array_equal(a.numpy(), np.asarray(ja))
    assert np.array_equal(kw.numpy(), np.asarray(jkw.numpy()))
    assert np.array_equal(vw.numpy(), np.asarray(jvw.numpy()))


def _p_incremental(pm, ids, cache_len, dtype):
    spec = pm.cache_spec()
    kv = pcache.init_cache(spec[0], 1, spec[1], cache_len, spec[2], dtype)
    outs = []
    with torch.no_grad():
        for t, tok in enumerate(ids):
            mask = pcache.decode_mask(kv[-1], cache_len)
            logits, _ = pm(torch.tensor([[int(tok)]]), position_ids=torch.tensor([[t]]),
                           attention_mask=mask, caches=pcache.layer_caches(kv))
            kv[-1].add_(1)
            outs.append(logits[0, 0].numpy().copy())
    return np.stack(outs)


def _j_incremental(jm, ids, cache_len, dtype):
    spec = jm.cache_spec()
    kv = jcache.init_cache(spec[0], 1, spec[1], cache_len, spec[2], dtype=dtype)
    outs = []
    for t, tok in enumerate(ids):
        logits, new = jm(np.asarray([[tok]], "int32"), position_ids=np.asarray([[t]], "int32"),
                         attention_mask=jnp.asarray(jcache.decode_mask(kv[-1], cache_len)),
                         caches=jcache.layer_caches(*kv))
        kv = jcache.stack_layer_caches(new) + (kv[-1] + 1,)
        outs.append(np.asarray(logits.numpy())[0, 0])
    return np.stack(outs)


def test_int8_decoding_within_the_envelope_of_jax_and_the_full_forward():
    """17 tokens through a ring of 6 (it wraps at 6): the port's int8
    logits against the JAX package's int8 logits and against the full
    f32 forward under the window, within 5% of the logit scale, argmax
    equal; the f32 ring stays the exact baseline."""
    w = 6
    jm, pm = _models(window=w, seed=3)
    ids = np.random.RandomState(7).randint(3, 200, size=17)
    with torch.no_grad():
        full = pm(torch.from_numpy(ids[None].astype(np.int64)))[0].numpy()
    scale = np.abs(full).max()
    inc8 = _p_incremental(pm, ids, w, "int8")
    j8 = _j_incremental(jm, ids, w, "int8")
    assert np.abs(inc8 - full).max() < ENVELOPE * scale
    assert np.abs(inc8 - j8).max() < ENVELOPE * scale
    np.testing.assert_array_equal(inc8.argmax(-1), full.argmax(-1))
    np.testing.assert_array_equal(inc8.argmax(-1), j8.argmax(-1))
    inc32 = _p_incremental(pm, ids, w, "float32")
    np.testing.assert_allclose(inc32, full, rtol=0, atol=CACHE_ATOL)
    assert np.abs(inc8 - inc32).max() > 1e-4  # the int8 read really is quantized


def test_int8_engine_tokens_and_graphs_equal_the_jax_int8_engine(graphs):
    """The captured int8 engine: ``len(buckets) + 1`` graphs at warmup (the
    JAX int8 engine's compile count), none after, greedy tokens equal to
    the JAX int8 engine's; the cache 3.2x smaller at head_dim 16."""
    jm, pm = _models(window=16, seed=3)
    kw = dict(slots=2, cache_len=16, prefill_buckets=(4, 8), seed=2)
    prompts = [[5, 9, 4], [7, 3], [11, 2, 8, 13, 4, 6], [3]]
    before = jprofiler.counters().get(J_COMPILES, 0)
    jeng = JEngine(jm, kv_cache_dtype="int8", **kw).warmup()
    j_warm = jprofiler.counters().get(J_COMPILES, 0) - before
    want = jeng.generate(prompts, max_new_tokens=8, temperature=0.0)
    eng = GenerationEngine(pm, kv_cache_dtype="int8", device="cpu", **kw).warmup()
    assert eng.compile_count() == eng.graphs() == len(graphs) == j_warm == 3
    got = eng.generate(prompts, max_new_tokens=8, temperature=0.0)
    assert got == want
    assert eng.extra_compiles() == 0 and sum(g.graph.replays for g in graphs) > 8
    assert len(eng.kv) == 5 and eng.kv[0].dtype == torch.int8
    assert eng.cache_nbytes() == jeng.cache_nbytes()
    assert eng.kv_bytes_per_token() == jeng.kv_bytes_per_token()
    ratio = GenerationEngine(pm, device="cpu", **kw).cache_nbytes() / eng.cache_nbytes()
    assert ratio >= 1.8


def test_int8_flag_validation_and_memory_plan(monkeypatch):
    jm, pm = _models(window=16)
    monkeypatch.setattr(flags._REGISTRY["generation_kv_cache_dtype"], "value", "int8")
    eng = GenerationEngine(pm, slots=3, cache_len=16, prefill_buckets=(4,), device="cpu")
    assert eng.kv_cache_dtype == "int8" and len(eng.kv) == 5
    monkeypatch.undo()
    with pytest.raises(InvalidArgumentError, match="kv_cache_dtype"):
        GenerationEngine(pm, slots=1, cache_len=16, prefill_buckets=(4,), device="cpu",
                         kv_cache_dtype="int4")
    jeng = JEngine(jm, slots=3, cache_len=16, prefill_buckets=(4,), kv_cache_dtype="int8")
    assert eng.slot_nbytes() == jeng.slot_nbytes()
    assert eng.hbm_required_bytes() == jeng.hbm_required_bytes()
    assert eng.hbm_required_bytes() - eng.param_nbytes() == eng.cache_nbytes()
    assert eng.cache_nbytes() == sum(a.numel() * a.element_size() for a in eng.kv)
    budget = eng.param_nbytes() + 5 * eng.slot_nbytes() + 1
    assert eng.suggest_decode_slots(budget) == jeng.suggest_decode_slots(budget) == 5
    f32 = GenerationEngine(pm, slots=3, cache_len=16, prefill_buckets=(4,), device="cpu")
    assert f32.suggest_decode_slots(budget, "int8") == 5
    assert f32.suggest_decode_slots(budget) < 5
