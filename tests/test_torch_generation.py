"""Port parity: sampling and the generation engine (``paddle_tpu_torch.generation``).

A tiny GPT built by the JAX package from a seed (64-bit types off, the JAX
package's setting), its weights moved as numpy through
``convert.gpt_state_from_numpy``. Covered: ``top_k_filter`` bit for bit;
``sample_logits``' greedy rows equal to the argmax in a mixed batch, and its
sampled rows by a chi-square test over 20,000 draws (the PRNG streams
differ from JAX's by design, so the distribution is held, not the draws);
the engine's greedy tokens equal to the JAX ``GenerationEngine``'s on five
prompts, where every top-two gap of the reference is above 1e-3; the
capture path, on the CPU through a stand-in graph whose replay runs the
captured body again on its static inputs: graphs ``== expected_compiles()``
after warmup and no more after traffic, as the JAX compile counter counts,
tokens equal to the eager engine's, the persistent cache written in place;
EOS and length stopping; validation; memory planning against the JAX
engine's; speculative decoding and the handoff running through the calls
that raised before they were ported (the router still raises), and the
int8 and paged caches running.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
scipy_stats = pytest.importorskip("scipy.stats")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu import profiler as jprofiler  # noqa: E402
from paddle_tpu.generation import COMPILE_COUNTER as J_COMPILES  # noqa: E402
from paddle_tpu.generation import GenerationEngine as JEngine  # noqa: E402
from paddle_tpu.generation import sampling as jsampling  # noqa: E402

from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import models as pmodels  # noqa: E402
from paddle_tpu_torch.errors import (  # noqa: E402
    InvalidArgumentError,
    PreconditionNotMetError,
)
from paddle_tpu_torch.generation import engine as pengine  # noqa: E402
from paddle_tpu_torch.generation import sampling as psampling  # noqa: E402
from paddle_tpu_torch.generation import GenerationEngine, MemoryBudgetError  # noqa: E402
from paddle_tpu_torch.runtime import compiled  # noqa: E402

torch.set_num_threads(1)

# greedy tokens are held only where the reference's top-two logit gap is
# above this (f32 logits of two programs part by ~1e-6)
GAP = 1e-3
# chi-square p-value a sound sampler clears (and the controls must not)
P_MIN = 1e-3


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


def _prompts(n, seed=0, lo=1, hi=9):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(3, 200, size=int(rng.randint(lo, hi)))) for _ in range(n)]


class _ReplayingGraph:
    """``torch.cuda.CUDAGraph``'s surface; ``replay`` runs the captured body
    again on the entry's static inputs and writes its outputs in place."""

    def __init__(self):
        self.replays = 0
        self.body = None

    def register_generator_state(self, gen):
        self.generator = gen

    def replay(self):
        self.replays += 1
        self.body()


@pytest.fixture
def graphs(monkeypatch):
    """The engine's capture path on the CPU; yields the captured entries."""
    captured = []
    capture = compiled.GraphStore.capture

    def capturing(self, sig, fn, inputs, generators=()):
        entry = capture(self, sig, fn, inputs, generators)

        def body():
            for dst, src in zip(entry.outputs, fn(*entry.inputs)):
                dst.copy_(src)

        entry.graph.body = body
        captured.append(entry)
        return entry

    @contextlib.contextmanager
    def graph(g, **kw):
        yield g

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _ReplayingGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(compiled.GraphStore, "capture", capturing)
    monkeypatch.setattr(pengine, "_captures", lambda device: True)
    monkeypatch.setattr(pengine, "_first_run", lambda device, fn: fn())
    yield captured


# -- sampling --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 5, 50, 211, 300])
def test_top_k_filter_bit_equal(k):
    logits = np.random.RandomState(0).randn(4, 211).astype(np.float32)
    logits[1, :20] = logits[1, 0]  # a run of ties at the threshold
    logits[2] = 0.5  # a row of ties
    got = psampling.top_k_filter(torch.from_numpy(logits), k).numpy()
    want = np.asarray(jsampling.top_k_filter(jnp.asarray(logits), k))
    assert np.array_equal(got, want)


def test_greedy_rows_of_a_mixed_batch_are_the_argmax():
    logits = np.random.RandomState(1).randn(6, 211).astype(np.float32)
    logits[3, [7, 40]] = logits[3].max() + 1.0  # a tie: the first index wins
    temps = np.array([0.0, 1.0, 0.0, 0.0, 2.0, -1.0], np.float32)
    gen = torch.Generator().manual_seed(0)
    got = psampling.sample_logits(torch.from_numpy(logits), gen, torch.from_numpy(temps),
                                  top_k=5).numpy()
    want = np.asarray(jsampling.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0),
                                              jnp.asarray(temps), top_k=5))
    greedy = temps <= 0
    assert np.array_equal(got[greedy], want[greedy])
    assert np.array_equal(got[greedy], logits.argmax(-1)[greedy]) and got[3] == 7
    top5 = np.argsort(-logits, axis=-1)[:, :5]
    assert all(got[r] in top5[r] for r in np.nonzero(~greedy)[0])
    # a scalar temperature of 0 is greedy for every row, whatever the draws
    assert np.array_equal(psampling.sample_logits(torch.from_numpy(logits), gen, 0.0).numpy(),
                          logits.argmax(-1))


def _chi2_p(counts, probs):
    """The chi-square p-value of ``counts`` against ``probs``, bins with an
    expectation under 5 pooled."""
    exp = probs * counts.sum()
    small = exp < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(exp[~small], exp[small].sum())
    keep = exp > 0
    return scipy_stats.chisquare(obs[keep], exp[keep]).pvalue


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 5), (1.5, 20)])
def test_sampled_rows_follow_the_softmax(temperature, top_k):
    """20,000 draws from one row of logits over the tiny vocabulary against
    ``softmax(top_k(logits) / T)``; the same draws against the distribution
    at twice the temperature are the control the test must reject."""
    logits = (np.random.RandomState(2).randn(211) * 1.5).astype(np.float32)
    draws = psampling.sample_logits(
        torch.from_numpy(np.tile(logits, (20000, 1))), torch.Generator().manual_seed(5),
        temperature, top_k=top_k).numpy()
    counts = np.bincount(draws, minlength=211).astype(np.float64)

    def probs(t):
        z = np.asarray(jsampling.top_k_filter(jnp.asarray(logits[None]), top_k))[0]
        z = z.astype(np.float64) / t
        e = np.exp(z - z.max())
        return e / e.sum()

    if top_k:
        assert counts[probs(temperature) == 0].sum() == 0  # nothing outside the top k
    assert _chi2_p(counts, probs(temperature)) > P_MIN
    assert _chi2_p(counts, probs(2 * temperature)) < P_MIN


# -- the engine against the JAX engine ------------------------------------------------


def _gaps(jm, prompt, tokens):
    """The top-two logit gap of the JAX full forward at every generated
    position."""
    ids = np.asarray(prompt + tokens, "int32")[None]
    logits = np.asarray(jm(ids).numpy())[0, len(prompt) - 1:-1]
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_engine_greedy_tokens_equal_the_jax_engine():
    jm, pm = _models(window=16)
    prompts = _prompts(5, seed=4)
    kw = dict(slots=2, cache_len=16, prefill_buckets=(4, 8), seed=1)
    want = JEngine(jm, **kw).warmup().generate(prompts, max_new_tokens=7, temperature=0.0)
    eng = GenerationEngine(pm, device="cpu", **kw).warmup()
    got = eng.generate(prompts, max_new_tokens=7, temperature=0.0)
    assert got == want
    for p, toks in zip(prompts, want):
        assert len(toks) == 7 or toks[-1] == jm.config.eos_token_id
        assert _gaps(jm, p, toks).min() > GAP


def test_engine_logits_equal_the_full_forward_across_a_wrap():
    """A 6-token prompt decoded 20 steps through a ring of 8 (window 8):
    every step's logits against the full forward under the window."""
    jm, pm = _models(window=8)
    eng = GenerationEngine(pm, slots=2, cache_len=8, prefill_buckets=(4, 8), device="cpu")
    prompt = _prompts(1, seed=9, lo=6, hi=7)[0]
    toks = [eng.admit(1, prompt)]
    rows = [eng.last_logits[0].clone()]
    for _ in range(20):
        last = np.array([0, toks[-1]], np.int32)
        toks.append(int(eng.step(last, np.zeros(2, np.float32))[1]))
        rows.append(eng.last_logits[1].clone())
    with torch.no_grad():
        full = pm(torch.tensor([prompt + toks[:-1]]))[0, len(prompt) - 1:].numpy()
    np.testing.assert_allclose(torch.stack(rows).numpy(), full, rtol=0, atol=2e-4)
    assert eng.kv[2].tolist() == [20, 26]


def test_capture_path_counts_graphs_as_the_jax_engine_compiles(graphs):
    """Warmup captures exactly ``len(buckets) + 1`` graphs (the JAX engine's
    compiles); mixed traffic captures none; the replays' tokens equal an
    eager engine's; the persistent cache keeps its storage through warmup,
    traffic and reset."""
    jm, pm = _models(window=32)
    kw = dict(slots=2, cache_len=32, prefill_buckets=(4, 8), seed=1)
    before = jprofiler.counters().get(J_COMPILES, 0)
    jeng = JEngine(jm, **kw).warmup()
    j_warm = jprofiler.counters().get(J_COMPILES, 0) - before
    eng = GenerationEngine(pm, device="cpu", **kw)
    with pytest.raises(PreconditionNotMetError):
        eng.extra_compiles()  # before warmup: nothing to compare
    ptrs = [t.data_ptr() for t in eng.kv]
    eng.warmup()
    assert eng.compile_count() == eng.graphs() == len(graphs) == j_warm == 3
    assert eng.expected_compiles() == jeng.expected_compiles() == 3
    assert not eng.kv[0].any() and not eng.kv[2].any()  # warmup's reset
    prompts = _prompts(8, seed=0)
    got = eng.generate(prompts, max_new_tokens=5, temperature=0.0)
    want = GenerationEngine(pm, device="cpu", jit=False, **kw).generate(
        prompts, max_new_tokens=5, temperature=0.0)
    assert got == want
    jeng.generate(prompts, max_new_tokens=5, temperature=0.0)
    assert jprofiler.counters().get(J_COMPILES, 0) - before == j_warm
    assert eng.extra_compiles() == 0 and eng.compile_count() == 3
    assert sum(g.graph.replays for g in graphs) > 8
    eng.reset()
    assert [t.data_ptr() for t in eng.kv] == ptrs
    eng.warmup()  # idempotent
    assert eng.compile_count() == 3
    # TF32 is part of every signature: switching it on captures anew
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        eng.admit(0, [5, 6, 7])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert eng.extra_compiles() == 1


def test_one_prefill_graph_serves_every_slot(graphs):
    jm, pm = _models(window=16)
    eng = GenerationEngine(pm, slots=3, cache_len=16, prefill_buckets=(8,), device="cpu")
    eager = GenerationEngine(pm, slots=3, cache_len=16, prefill_buckets=(8,), device="cpu",
                             jit=False)
    for slot, prompt in enumerate(_prompts(3, seed=2)):
        assert eng.admit(slot, prompt) == eager.admit(slot, prompt)
    assert len(eng._stores["prefill"]) == 1
    for a, b in zip(eng.kv, eager.kv):
        assert torch.equal(a, b)


def test_sampled_generation_reproduces_from_the_seed():
    _, pm = _models(window=16)
    runs = [GenerationEngine(pm, slots=2, cache_len=16, prefill_buckets=(4, 8), seed=7,
                             device="cpu").generate(_prompts(3, seed=1), max_new_tokens=6,
                                                    temperature=1.0, stop_at_eos=False)
            for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(0 <= t < 211 for toks in runs[0] for t in toks)
    other = GenerationEngine(pm, slots=2, cache_len=16, prefill_buckets=(4, 8), seed=8,
                             device="cpu").generate(_prompts(3, seed=1), max_new_tokens=6,
                                                    temperature=1.0, stop_at_eos=False)
    assert other != runs[0]


def test_stopping_at_eos_and_length():
    _, pm = _models(window=16)
    eng = GenerationEngine(pm, slots=1, cache_len=16, prefill_buckets=(4,), device="cpu")
    free = eng.generate([[5, 9, 4]], max_new_tokens=6, stop_at_eos=False)[0]
    assert len(free) == 6
    eng.eos_id = free[2]
    first = free.index(eng.eos_id)
    stopped = eng.generate([[5, 9, 4]], max_new_tokens=6)[0]
    assert stopped == free[:first + 1] and stopped[-1] == eng.eos_id
    assert eng.generate([[5, 9, 4]], max_new_tokens=6, stop_at_eos=False)[0] == free
    # static batching: a new group only once every slot has drained
    assert eng.generate([[5, 9, 4]] * 2, max_new_tokens=3, stop_at_eos=False,
                        continuous=False) == [free[:3]] * 2


def test_validation():
    _, pm = _models(window=None)
    eng = GenerationEngine(pm, slots=1, cache_len=16, prefill_buckets=(4, 8), device="cpu")
    for prompt, budget in (([], 4), ([1] * 9, 4), ([1, 2], 0), ([1, 2], 10 ** 6),
                           ([1, 211], 4), ([-1], 4)):
        with pytest.raises(InvalidArgumentError):
            eng.validate(prompt, budget)
    assert eng.validate([1, 2, 3], 4) == 3
    assert eng.bucket_for(5) == 8 and eng.has_capacity([1, 2])
    with pytest.raises(InvalidArgumentError):
        GenerationEngine(pm, slots=1, cache_len=4, prefill_buckets=(8,), device="cpu")
    with pytest.raises(InvalidArgumentError):
        GenerationEngine(pm, slots=0, cache_len=16, prefill_buckets=(8,), device="cpu")
    with pytest.raises(InvalidArgumentError):
        eng.expected_compiles("train")


def test_memory_planning_matches_the_jax_engine():
    jm, pm = _models(window=32)
    kw = dict(slots=3, cache_len=32, prefill_buckets=(8,))
    jeng, eng = JEngine(jm, **kw), GenerationEngine(pm, device="cpu", **kw)
    assert eng.param_nbytes() == jeng.param_nbytes()
    assert eng.slot_nbytes() == jeng.slot_nbytes()
    assert eng.slot_nbytes("int8") == jeng.slot_nbytes("int8")
    assert eng.hbm_required_bytes() == jeng.hbm_required_bytes()
    assert eng.hbm_required_bytes() == eng.param_nbytes() + eng.cache_nbytes()
    assert eng.cache_nbytes() == jeng.cache_nbytes()
    assert eng.kv_bytes_per_token() == jeng.kv_bytes_per_token()
    budget = eng.param_nbytes() + 2 * eng.slot_nbytes() + 10
    assert eng.suggest_decode_slots(budget) == jeng.suggest_decode_slots(budget) == 2
    assert eng.check_memory_budget("strict", budget_bytes=10 ** 9) == eng.hbm_required_bytes()
    assert eng.check_memory_budget("off") is None
    with pytest.raises(MemoryBudgetError, match="suggest_decode_slots"):
        eng.check_memory_budget("strict", budget_bytes=budget)
    with pytest.warns(RuntimeWarning):
        eng.check_memory_budget("warn", budget_bytes=budget)
    assert eng.suggest_decode_slots() == 0  # the CPU's budget is unknown


def test_unported_paths_raise_naming_their_entries(monkeypatch):
    """Speculative decoding (entry 3), the handoff (entry 4) and the router
    (entry 5) run through the calls that raised before they were ported;
    the int8 and paged caches (entries 1 and 2) construct and run, from
    arguments and from the flags."""
    from paddle_tpu_torch.generation import PageSlab
    from paddle_tpu_torch.serving import Router

    _, pm = _models()
    kw = dict(slots=1, cache_len=16, prefill_buckets=(8,), device="cpu")
    spec = GenerationEngine(pm, **kw, draft_model=pm)
    assert spec.speculative and spec.draft_k == 4 and spec.store_len == 20
    for extra in (dict(kv_cache_dtype="int8"), dict(kv_cache_layout="paged"),
                  dict(kv_cache_dtype="int8", kv_cache_layout="paged")):
        eng = GenerationEngine(pm, **kw, **extra)
        assert len(eng.generate([[5, 6, 7]], max_new_tokens=3)[0]) == 3
    eng = GenerationEngine(pm, **kw)
    with pytest.raises(InvalidArgumentError, match="draft model"):
        eng.spec_step([0], [0.0])
    assert eng.spec_stats()["enabled"] is False
    first = spec.admit(0, [1, 2], 0.0)
    ts, counts = spec.spec_step([first], [0.0])
    assert ts.shape == (1, 5) and 1 <= counts[0] <= 5
    assert spec.spec_stats()["rounds"] == 1
    planes, n, tok = eng.prefill_export([1, 2])
    assert n == 2 and len(planes) == 2 and planes[0].shape == (2, 4, 16, 16)
    assert eng.admit_prefilled(0, planes, n, tok) == tok
    with pytest.raises(InvalidArgumentError, match="paged"):
        eng.admit_prefilled_pages(0, [], 2, 1)
    assert eng.expected_compiles("prefill") == 1 and eng.expected_compiles("decode") == 1
    assert spec.expected_compiles("decode") == 3
    paged = GenerationEngine(pm, **kw, kv_cache_layout="paged", kv_page_size=4)
    pages, n, tok = paged.prefill_export_pages([1, 2, 3, 4, 5])
    assert [p["hash"] is not None for p in pages] == [True, False]
    assert paged.admit_prefilled_pages(0, pages, n, tok, page_size=4) == tok
    assert isinstance(PageSlab(pages, n, tok, 4, {}), tuple)
    GenerationEngine(pm, **kw).warmup(kind="decode")
    router = Router(probe_interval_s=0.05).start()  # an empty fleet: up, not ready
    try:
        assert router.healthz()["ready"] is False and router.healthy_count == 0
        assert router.loadz()["kind"] == "router"
    finally:
        router.stop()
    # the paging surface answers on the ring, as the JAX engine's does
    assert eng.paging_stats() == {"layout": "ring"}
    assert eng.known_page_hashes(["a"]) == set()
    assert eng.page_nbytes() == 16 * eng.kv_bytes_per_token()
    from paddle_tpu_torch import flags

    monkeypatch.setattr(flags._REGISTRY["kv_cache_layout"], "value", "paged")
    assert GenerationEngine(pm, **kw).paging_stats()["layout"] == "paged"


def test_the_engine_needs_a_card_unless_told_otherwise(monkeypatch):
    _, pm = _models()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(pm, slots=1, cache_len=16, prefill_buckets=(8,))
