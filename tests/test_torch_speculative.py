"""Port parity: speculative decoding (``GenerationEngine(draft_model=...)`` and its batcher and server paths).

A tiny GPT made by the JAX package from a seed (64-bit types off, its
setting), its weights moved as numpy through ``convert.gpt_state_from_numpy``,
and its one-layer ``truncated_draft`` in each package. Covered: the port's
speculative greedy tokens equal to the JAX speculative engine's and to the
port's plain engine, f32 and int8, past the ring's wrap, with the same
``spec_stats()`` rounds, proposals and acceptances; co-batched equal to
solo; a self-draft's acceptance; budget truncation; validation;
``expected_compiles`` for every backend kind with and without a draft,
against the JAX engine's and the graphs the capture path really makes (on
the CPU through the stand-in graph of ``tests/test_torch_generation.py``,
whose replay re-runs the captured body), captured tokens equal to eager
ones; the memory plan against the JAX engine's; sampled generation
reproduced from the seed; and the batcher's rounds (EOS and budget cuts,
a failed round failing its busy requests only) and ``/statz``
``speculative`` over HTTP.
"""
import json
from urllib.request import Request, urlopen

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu.generation import GenerationEngine as JEngine  # noqa: E402

from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import models as pmodels  # noqa: E402
from paddle_tpu_torch.errors import InvalidArgumentError  # noqa: E402
from paddle_tpu_torch.generation import GenerationEngine  # noqa: E402
from paddle_tpu_torch.serving import ContinuousBatcher, GenerationServer  # noqa: E402
from tests.test_torch_generation import graphs  # noqa: E402,F401

torch.set_num_threads(1)

CACHE = 24
BUCKETS = (4, 8)


@pytest.fixture(autouse=True)
def _x64_off():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def models():
    """(JAX target, JAX draft, port target, port draft): the same weights."""
    with jax.enable_x64(False):
        paddle.seed(3)
        cfg = jmodels.gpt_tiny_config()
        cfg.attention_window = CACHE
        jm = jmodels.GPTForCausalLM(cfg)
        jm.eval()
        state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
        jd = jmodels.truncated_draft(jm, num_layers=1)
    pm = pmodels.GPTForCausalLM(pmodels.GPTConfig(**vars(cfg)))
    pm.load_state_dict(convert.gpt_state_from_numpy(state, pm))
    pm.eval()
    return jm, jd, pm, pmodels.truncated_draft(pm, 1)


def _engine(model, slots=2, **kw):
    return GenerationEngine(model, slots=slots, cache_len=CACHE, prefill_buckets=BUCKETS,
                            seed=7, device="cpu", **kw)


def _jengine(model, slots=2, **kw):
    return JEngine(model, slots=slots, cache_len=CACHE, prefill_buckets=BUCKETS, seed=7, **kw)


def _prompts(n, rng_seed=0, lo=1, hi=9):
    rng = np.random.RandomState(rng_seed)
    return [list(map(int, rng.randint(3, 200, size=int(rng.randint(lo, hi)))))
            for _ in range(n)]


def _counts(stats):
    return stats["rounds"], stats["proposed"], stats["accepted"]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_spec_greedy_tokens_equal_jax_and_the_plain_engine(models, dtype):
    """Speculative greedy decoding equals the port's plain engine and the
    JAX speculative engine token for token on budgets past the ring's wrap,
    and counts the same rounds, proposals and acceptances."""
    jm, jd, pm, pd = models
    plain = _engine(pm, kv_cache_dtype=dtype).warmup()
    spec = _engine(pm, kv_cache_dtype=dtype, draft_model=pd, draft_k=3).warmup()
    jspec = _jengine(jm, kv_cache_dtype=dtype, draft_model=jd, draft_k=3).warmup()
    assert spec.store_len == CACHE + 3
    for p in _prompts(5, rng_seed=1):
        want = plain.generate([p], max_new_tokens=CACHE + 9, temperature=0.0,
                              stop_at_eos=False)[0]
        got = spec.generate([p], max_new_tokens=CACHE + 9, temperature=0.0,
                            stop_at_eos=False)[0]
        jgot = jspec.generate([p], max_new_tokens=CACHE + 9, temperature=0.0,
                              stop_at_eos=False)[0]
        assert got == want == jgot, (p, got, want, jgot)
    stats = spec.spec_stats()
    assert _counts(stats) == _counts(jspec.spec_stats())
    assert stats["rounds"] > 0 and stats["proposed"] == 3 * stats["rounds"]
    assert stats["acceptance_rate"] == jspec.spec_stats()["acceptance_rate"]
    assert spec.extra_compiles() == 0


def test_spec_cobatched_greedy_parity(models):
    """Slots sharing rounds change nothing: continuous-batched equals one
    at a time, and equals the JAX engine's co-batched run."""
    jm, jd, pm, pd = models
    spec = _engine(pm, slots=3, draft_model=pd, draft_k=4).warmup()
    solo = _engine(pm, slots=3, draft_model=pd, draft_k=4).warmup()
    jspec = _jengine(jm, slots=3, draft_model=jd, draft_k=4).warmup()
    prompts = _prompts(7, rng_seed=2)
    together = spec.generate(prompts, max_new_tokens=12, temperature=0.0, stop_at_eos=False)
    alone = [solo.generate([p], max_new_tokens=12, temperature=0.0, stop_at_eos=False)[0]
             for p in prompts]
    assert together == alone == jspec.generate(prompts, max_new_tokens=12, temperature=0.0,
                                               stop_at_eos=False)
    assert _counts(spec.spec_stats()) == _counts(jspec.spec_stats())
    assert spec.extra_compiles() == 0


def test_self_draft_acceptance_near_total(models):
    """Draft == target: proposals are the target's own chain except where
    the one-row and the (k+1)-row forwards round a near-tie apart."""
    _, _, pm, _ = models
    spec = _engine(pm, draft_model=pm, draft_k=3).warmup()
    spec.generate(_prompts(3, rng_seed=4), max_new_tokens=13, temperature=0.0,
                  stop_at_eos=False)
    stats = spec.spec_stats()
    assert stats["proposed"] > 0 and stats["acceptance_rate"] > 0.6, stats
    # one tensor each: the self-draft's weights count once
    assert spec.param_nbytes() == _engine(pm).param_nbytes()


def _drive(eng, kind):
    """Traffic of a backend kind after its warmup."""
    if kind == "prefill":
        for p in _prompts(4, rng_seed=9):
            eng.prefill_export(p)
        return
    if kind == "decode":
        for s, p in enumerate(_prompts(2, rng_seed=9)):
            eng.admit_prefilled(s, eng._fresh_slot_planes(), len(p), 5,
                                prompt=p if eng.speculative else None)
        zeros = np.zeros(eng.slots, np.int32), np.zeros(eng.slots, np.float32)
        for _ in range(3):
            eng.spec_step(*zeros) if eng.speculative else eng.step(*zeros)
        return
    eng.generate(_prompts(5, rng_seed=9), max_new_tokens=9, temperature=0.0)


@pytest.mark.parametrize("speculative", [False, True])
@pytest.mark.parametrize("kind", ["generate", "prefill", "decode"])
def test_expected_compiles_of_every_kind(models, graphs, kind, speculative):
    """``expected_compiles(kind)`` equals the JAX engine's, warmup captures
    exactly that many graphs, and the kind's traffic captures none."""
    jm, jd, pm, pd = models
    kw = dict(draft_model=pd, draft_k=2) if speculative else {}
    jkw = dict(draft_model=jd, draft_k=2) if speculative else {}
    eng = _engine(pm, **kw)
    want = {"generate": len(BUCKETS) + 1, "prefill": len(BUCKETS), "decode": 1}[kind]
    if speculative and kind != "prefill":
        want += 1 + (len(BUCKETS) if kind == "decode" else 0)
    assert eng.expected_compiles(kind) == _jengine(jm, **jkw).expected_compiles(kind) == want
    eng.warmup(kind=kind)
    assert eng.compile_count() == eng.graphs() == len(graphs) == want
    _drive(eng, kind)
    assert eng.extra_compiles() == 0 and eng.graphs() == want
    assert sum(g.graph.replays for g in graphs) > 0
    with pytest.raises(InvalidArgumentError):
        eng.expected_compiles("router")


def test_spec_captured_tokens_equal_eager(models, graphs):
    """The draft and verify graphs replayed give the eager engine's tokens,
    and the target ring and the draft ring keep their storage through
    warmup, traffic and reset."""
    _, _, pm, pd = models
    eng = _engine(pm, draft_model=pd, draft_k=3)
    ptrs = [t.data_ptr() for t in eng.kv + eng._kv_draft]
    eng.warmup()
    assert len(eng._stores["draft"]) == len(eng._stores["verify"]) == 1
    assert len(eng._stores["decode"]) == 0
    prompts = _prompts(6, rng_seed=3)
    got = eng.generate(prompts, max_new_tokens=CACHE + 4, temperature=0.0)
    want = _engine(pm, draft_model=pd, draft_k=3, jit=False).generate(
        prompts, max_new_tokens=CACHE + 4, temperature=0.0)
    assert got == want
    assert eng.extra_compiles() == 0
    eng.reset()
    assert [t.data_ptr() for t in eng.kv + eng._kv_draft] == ptrs
    assert not any(t.any() for t in eng.kv + eng._kv_draft)


def test_spec_budget_truncation(models):
    """A round emitting more than the remaining budget is cut at it."""
    _, _, pm, pd = models
    spec = _engine(pm, draft_model=pd, draft_k=4).warmup()
    plain = _engine(pm).warmup()
    for budget in (1, 2, 3, 7):
        p = [5, 9, 3]
        want = plain.generate([p], max_new_tokens=budget, temperature=0.0,
                              stop_at_eos=False)[0]
        got = spec.generate([p], max_new_tokens=budget, temperature=0.0, stop_at_eos=False)[0]
        assert got == want and len(got) == budget


def test_spec_validation(models):
    _, _, pm, pd = models
    with pytest.raises(InvalidArgumentError, match="draft_k"):
        _engine(pm, draft_model=pd, draft_k=0)
    small = pmodels.gpt_tiny_config()
    small.vocab_size = 7  # proposals are target token ids
    with pytest.raises(InvalidArgumentError, match="vocab"):
        _engine(pm, draft_model=pmodels.GPTForCausalLM(small))
    short = pmodels.gpt_tiny_config()
    short.max_position_embeddings = 16  # fewer positions than the target's
    with pytest.raises(InvalidArgumentError, match="max_position_embeddings"):
        _engine(pm, draft_model=pmodels.GPTForCausalLM(short))
    with pytest.raises(InvalidArgumentError, match="draft model"):
        _engine(pm).spec_step(np.zeros(2, np.int32), np.zeros(2, np.float32))
    with pytest.raises(InvalidArgumentError, match="paged"):
        _engine(pm, draft_model=pd, kv_cache_layout="paged", kv_page_size=4)
    assert _engine(pm).spec_stats() == {"enabled": False, "draft_k": 0, "rounds": 0,
                                        "proposed": 0, "accepted": 0,
                                        "acceptance_rate": None}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_spec_memory_plan_matches_the_jax_engine(models, dtype):
    """Weights, cache and slot bytes with the draft ring, as the JAX engine
    plans them, and the plan equal to the real tensors."""
    jm, jd, pm, pd = models
    eng = _engine(pm, kv_cache_dtype=dtype, draft_model=pd, draft_k=3)
    jeng = _jengine(jm, kv_cache_dtype=dtype, draft_model=jd, draft_k=3)
    assert eng.param_nbytes() == jeng.param_nbytes()
    assert eng.cache_nbytes() == jeng.cache_nbytes()
    assert eng.slot_nbytes() == jeng.slot_nbytes()
    assert eng.hbm_required_bytes() == jeng.hbm_required_bytes()
    assert eng.hbm_required_bytes() == eng.param_nbytes() + eng.cache_nbytes()
    plain = _engine(pm, kv_cache_dtype=dtype)
    assert eng.cache_nbytes() > plain.cache_nbytes()
    budget = eng.param_nbytes() + 2 * eng.slot_nbytes() + 10
    assert eng.suggest_decode_slots(budget) == jeng.suggest_decode_slots(budget) == 2


def test_spec_step_accounting_scoped_to_busy_slots(models):
    _, _, pm, pd = models
    eng = _engine(pm, slots=3, draft_model=pd, draft_k=2).warmup()
    last = np.zeros(3, np.int32)
    for s, p in enumerate(_prompts(3, rng_seed=5)):
        last[s] = eng.admit(s, p, 0.0)
    ts, counts = eng.spec_step(last, np.zeros(3, np.float32), busy=[0, 2])
    assert ts.shape == (3, 3) and ts.dtype == np.int32 and counts.dtype == np.int32
    assert ((1 <= counts) & (counts <= 3)).all()
    stats = eng.spec_stats()
    assert (stats["rounds"], stats["proposed"]) == (1, 4)
    assert stats["accepted"] == int(counts[0] + counts[2] - 2)
    eng.spec_step(ts[np.arange(3), counts - 1], np.zeros(3, np.float32), busy=[])
    assert eng.spec_stats()["rounds"] == 1  # a round with no busy slot counts nothing


def test_sampled_spec_generation_reproduces_from_the_seed(models):
    _, _, pm, pd = models

    def run(seed):
        eng = GenerationEngine(pm, slots=2, cache_len=CACHE, prefill_buckets=BUCKETS,
                               seed=seed, device="cpu", draft_model=pd, draft_k=3)
        return eng.generate(_prompts(3, rng_seed=1), max_new_tokens=10, temperature=1.0,
                            stop_at_eos=False)

    a, b = run(7), run(7)
    assert a == b and all(len(t) == 10 for t in a)
    assert all(0 <= t < pm.config.vocab_size for toks in a for t in toks)
    assert run(8) != a


# -- the batcher and the server -----------------------------------------------------------


def test_batcher_rounds_equal_solo_and_stop_at_eos_and_budget(models):
    """The batcher's rounds deliver each request the plain engine's tokens,
    cut at its own budget, and at EOS mid-round."""
    _, _, pm, pd = models
    plain = _engine(pm, slots=1).warmup()
    sched = ContinuousBatcher(_engine(pm, slots=2, draft_model=pd, draft_k=3).warmup(),
                              queue_capacity=16).start()
    try:
        prompts = _prompts(5, rng_seed=6)
        budgets = [1, 4, 7, 12, 30]
        reqs = [sched.submit(p, max_new_tokens=n, temperature=0.0)
                for p, n in zip(prompts, budgets)]
        outs = [r.wait(60) for r in reqs]
        for p, n, out, r in zip(prompts, budgets, outs, reqs):
            want = plain.generate([p], max_new_tokens=n, temperature=0.0)[0]
            assert out == want
            assert r.finish_reason == ("eos" if want[-1] == plain.eos_id and len(want) < n
                                       else "length")
        # EOS mid-round: the request stops at the first EOS it emits
        full = plain.generate([prompts[4]], max_new_tokens=12, temperature=0.0,
                              stop_at_eos=False)[0]
        eos = full[5]
        sched.engine.eos_id = eos
        got = sched.submit(prompts[4], max_new_tokens=12, temperature=0.0).wait(60)
        assert got == full[:full.index(eos) + 1]
        assert sched.stats["errors"] == 0
        assert sched.quantiles("token")["count"] > 0
    finally:
        sched.stop(drain=False)


def test_failed_round_fails_only_its_busy_requests(models, monkeypatch):
    _, _, pm, pd = models
    eng = _engine(pm, slots=2, draft_model=pd, draft_k=2).warmup()
    sched = ContinuousBatcher(eng, queue_capacity=8)
    calls = {"n": 0}
    real = eng.spec_step

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("round failed")
        return real(*args, **kw)

    monkeypatch.setattr(eng, "spec_step", flaky)
    first = [sched.submit([5, 6, 7], max_new_tokens=6), sched.submit([8, 9], max_new_tokens=6)]
    sched.start()
    try:
        for r in first:
            with pytest.raises(RuntimeError, match="round failed"):
                r.wait(60)
        assert len(sched.submit([5, 6, 7], max_new_tokens=6).wait(60)) == 6
        assert sched.stats["errors"] == 2 and sched.live_slots == 0
    finally:
        sched.stop(drain=False)


def test_speculative_server_generate_and_statz(models):
    """``/generate`` through a speculative server equals the plain engine;
    ``/statz`` reports ``speculative`` as ``spec_stats()`` and the draft
    and verify graphs in ``compiles``."""
    _, _, pm, pd = models
    plain = _engine(pm, slots=1).warmup()
    srv = GenerationServer(pm, slots=2, cache_len=CACHE, prefill_buckets=BUCKETS,
                           draft_model=pd, draft_k=3, device="cpu", queue_capacity=8).start()
    try:
        for p in _prompts(3, rng_seed=8):
            body = json.dumps({"prompt": p, "max_new_tokens": 9, "temperature": 0.0}).encode()
            out = json.loads(urlopen(Request(srv.url + "/generate", data=body),
                                     timeout=60).read())
            assert out["tokens"] == plain.generate([p], max_new_tokens=9, temperature=0.0)[0]
        sz = json.loads(urlopen(srv.url + "/statz").read())
        assert sz["speculative"] == srv.engine.spec_stats()
        assert sz["speculative"]["enabled"] and sz["speculative"]["rounds"] > 0
        assert sz["compiles"]["decode"] == 2
        assert sz["compiles"]["expected"] == len(BUCKETS) + 2
        assert sz["compiles"]["unexpected"] == 0
    finally:
        srv.stop(drain=False)
