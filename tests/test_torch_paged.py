"""Port parity: the paged KV layout (``paddle_tpu_torch.generation.paging``, ``PagedStaticCache``, the paged engine).

A tiny GPT built by the JAX package from a seed (64-bit types off, the JAX
package's setting), its weights moved as numpy through
``convert.gpt_state_from_numpy``. Covered, each against the JAX package:
``chain_hashes`` (the same hex strings), ``PagePool`` and ``PrefixIndex``
driven operation by operation through a seeded random sequence,
``split_planes``, ``page_nbytes``, ``init_paged_cache`` and the suffix
prefill mask; the paged write and gather bit for bit, f32 and int8; the
paged engine's greedy tokens, f32 and int8, equal to the JAX paged
engine's and to the port's ring engine's; a page-boundary wrap (window 6,
page 2) through copy-on-write and through the pressure valve, with
``paging_stats()`` equal to the JAX engine's; prefix reuse; pool
exhaustion and ``has_capacity``; the memory plan byte for byte in both
layouts and both dtypes; the batcher returning pages and waiting for the
pool; ``/statz``'s ``paging`` block over HTTP. On the capture path (a
stand-in graph whose replay re-runs the captured body, ``graphs``):
``len(buckets) + 1`` graphs and none after, and a replay that reads no
host state (the host mirrors raise while a body runs).

Greedy tokens are compared where the prompts and weights give top-two
gaps far above f32 rounding (``tests/test_torch_generation.py``); the
paged attention gathers the ring's window, so the same bits go in.
"""
import json
import random
from urllib.request import urlopen

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu.errors import InvalidArgumentError as JInvalidArgumentError  # noqa: E402
from paddle_tpu.generation import GenerationEngine as JEngine  # noqa: E402
from paddle_tpu.generation import paging as jpaging  # noqa: E402
from paddle_tpu.nn import transformer as jtf  # noqa: E402

from paddle_tpu_torch import convert, flags  # noqa: E402
from paddle_tpu_torch import models as pmodels  # noqa: E402
from paddle_tpu_torch.errors import InvalidArgumentError  # noqa: E402
from paddle_tpu_torch.generation import (  # noqa: E402
    TRASH_PAGE,
    GenerationEngine,
    MemoryBudgetError,
    PagePool,
    PagePoolExhaustedError,
    PrefixIndex,
    chain_hashes,
    split_planes,
)
from paddle_tpu_torch.generation import paging as ppaging  # noqa: E402
from paddle_tpu_torch.nn import transformer as ptf  # noqa: E402
from paddle_tpu_torch.serving import ContinuousBatcher, GenerationServer  # noqa: E402
from tests.test_torch_generation import graphs  # noqa: E402,F401

torch.set_num_threads(1)

CACHE = 16
BUCKETS = (4, 8)
PS = 4  # tokens a page in most tests: 4 pages a slot


@pytest.fixture(autouse=True)
def _x64_off():
    with jax.enable_x64(False):
        yield


def _models(window=CACHE, seed=3):
    paddle.seed(seed)
    cfg = jmodels.gpt_tiny_config()
    cfg.attention_window = window
    jm = jmodels.GPTForCausalLM(cfg)
    jm.eval()
    pm = pmodels.GPTForCausalLM(pmodels.GPTConfig(**vars(cfg)))
    pm.load_state_dict(convert.gpt_state_from_numpy(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}, pm))
    return jm, pm.eval()


@pytest.fixture(scope="module")
def models():
    with jax.enable_x64(False):
        return _models()


def _kw(slots=2, page_size=PS, **kw):
    return dict(slots=slots, cache_len=CACHE, prefill_buckets=BUCKETS, seed=7,
                kv_cache_layout="paged", kv_page_size=page_size, **kw)


def _paged(pm, **kw):
    return GenerationEngine(pm, device="cpu", **_kw(**kw))


def _ring(pm, slots=2, **kw):
    return GenerationEngine(pm, slots=slots, cache_len=CACHE, prefill_buckets=BUCKETS, seed=7,
                            device="cpu", **kw)


def _prompts(n, rng_seed=0, lo=1, hi=9):
    rng = np.random.RandomState(rng_seed)
    return [list(rng.randint(3, 200, size=int(rng.randint(lo, hi)))) for _ in range(n)]


# -- host bookkeeping -------------------------------------------------------------------


@pytest.mark.parametrize("ps", [1, 2, 4, 16])
def test_chain_hashes_equal_jax(ps):
    rng = np.random.RandomState(ps)
    for n in (0, ps - 1, ps, 3 * ps + 1, 50):
        toks = [int(t) for t in rng.randint(0, 50304, size=max(n, 0))]
        got = chain_hashes(toks, ps)
        assert got == jpaging.chain_hashes(toks, ps)
        assert len(got) == max(n, 0) // ps and all(len(h) == 32 for h in got)
    big = [2 ** 40, 7, 2 ** 31 - 1, 0]  # past int32: the bytes are int64
    assert chain_hashes(big, 2) == jpaging.chain_hashes(big, 2)
    assert chain_hashes(np.asarray(big), 2) == chain_hashes(big, 2)


def _drive(pool_cls, index_cls, seed, steps=200):
    """A seeded random sequence of pool and index operations; the log of
    every result (or the exception's class name) and the final state."""
    rng = random.Random(seed)
    pool = pool_cls(12, page_size=2)
    index = index_cls(pool)
    chains = [list(range(100 * c, 100 * c + rng.randint(2, 12))) for c in range(6)]
    chains += [chains[0][:4] + [9, 9, 9, 9], chains[1][:2] + [7, 7]]  # shared prefixes
    held = []  # pages the sequence holds a reference on
    log = []
    for _ in range(steps):
        op = rng.choice(["alloc", "alloc", "retain", "release", "insert", "match", "known",
                         "evict", "forget", "evictable", "trash"])
        try:
            if op == "alloc":
                pid = pool.alloc()
                if pid is not None:
                    held.append(int(pid))
                out = pid
            elif op == "retain":
                pid = rng.choice(held) if held and rng.random() < 0.8 else rng.randint(1, 12)
                pool.retain(pid)
                held.append(pid)
                out = pid
            elif op == "release":
                pid = held.pop(rng.randrange(len(held))) if held else rng.randint(0, 12)
                out = (pid, pool.release(pid))
            elif op == "insert":
                hashes = chain_hashes(rng.choice(chains), 2)
                pages = [rng.choice(held) if held else 0 for _ in hashes]
                index.insert(hashes, pages)
                out = pages
            elif op == "match":
                out = index.match(chain_hashes(rng.choice(chains), 2))
            elif op == "known":
                out = sorted(index.known(chain_hashes(rng.choice(chains), 2)))
            elif op == "evict":
                out = index.evict(rng.randint(0, 4))
            elif op == "forget":
                out = index.forget_page(rng.randint(0, 12))
            elif op == "evictable":
                out = index.evictable()
            else:
                out = pool.retain(0)
        except Exception as e:  # noqa: BLE001 — the error's kind is compared
            out = type(e).__name__
        log.append((op, out, pool.free_pages(), pool.used_pages(), pool.shared_pages(),
                    pool.peak_used, index.stats()))
    return log, pool.ref.tolist(), sorted(pool._free)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_index_match_jax_operation_by_operation(seed):
    got = _drive(PagePool, PrefixIndex, seed)
    want = _drive(jpaging.PagePool, jpaging.PrefixIndex, seed)
    names = {"InvalidArgumentError"}
    for g, w in zip(got[0], want[0]):
        assert g == w or (g[1] in names and w[1] in names and g[2:] == w[2:]), (g, w)
    assert got[1:] == want[1:]
    ops = [e[0] for e in got[0]]
    outs = [e[1] for e in got[0]]
    # the sequence reaches every path: hits, evictions, errors
    assert {"insert", "match", "evict", "forget"} <= set(ops)
    assert "InvalidArgumentError" in outs and got[0][-1][6]["hits"] > 0
    assert max(e[6]["evictions"] for e in got[0]) > 0
    assert issubclass(PagePoolExhaustedError, InvalidArgumentError)
    assert issubclass(jpaging.PagePoolExhaustedError, JInvalidArgumentError)


def test_pool_and_index_semantics():
    """The JAX package's own pool and index cases (``tests/test_paged_kv.py``)."""
    pool = PagePool(8, page_size=2)
    idx = PrefixIndex(pool)
    toks = list(range(12))
    hashes = chain_hashes(toks, 2)
    pages = [pool.alloc() for _ in range(6)]
    idx.insert(hashes, pages)
    assert pool.free_pages() == 2 and idx.pages == 6
    assert idx.match(hashes[:3]) == pages[:3]
    assert idx.match(chain_hashes([99] + toks[1:], 2)) == []
    for p in pages:
        pool.release(p)
    assert idx.evictable() == 1
    assert idx.evict(2) == 2 and pool.free_pages() == 4 and idx.pages == 4
    assert idx.forget_page(pages[0]) == 4 and pool.free_pages() == 8
    assert idx.forget_page(pages[0]) == 0
    with pytest.raises(InvalidArgumentError):
        pool.release(pages[0])
    with pytest.raises(InvalidArgumentError):
        pool.retain(TRASH_PAGE)
    with pytest.raises(InvalidArgumentError):
        idx.insert(hashes[:1], [TRASH_PAGE])
    with pytest.raises(InvalidArgumentError):
        PagePool(0, 2)


def test_split_planes_page_nbytes_and_init_match_jax():
    k = np.arange(2 * 3 * 8 * 5, dtype=np.float32).reshape(2, 3, 8, 5)
    s = np.arange(2 * 3 * 8, dtype=np.float32).reshape(2, 3, 8)
    for planes in ((k, k + 1), (torch.from_numpy(k), torch.from_numpy(s))):
        got = split_planes(planes, 4)
        want = jpaging.split_planes(tuple(np.asarray(p) for p in planes), 4)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(g, w))
    with pytest.raises(InvalidArgumentError):
        split_planes((k,), 3)
    for dtype in ("float32", "int8"):
        assert ppaging.page_nbytes(12, 12, 64, 16, dtype) == jpaging.page_nbytes(
            12, 12, 64, 16, dtype)
        got = ppaging.init_paged_cache(2, 3, 5, 4, 6, 3, 4, dtype)
        want = jpaging.init_paged_cache(2, 3, 5, 4, 6, 3, 4, dtype=dtype)
        assert len(got) == len(want) == (6 if dtype == "int8" else 4)
        for a, b in zip(got, want):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            assert np.array_equal(a.numpy(), np.asarray(b))
        layers = ppaging.paged_layer_caches(got)
        assert len(layers) == 2 and layers[1].table is got[-2]
        assert type(layers[0]).__name__ == type(jpaging.paged_layer_caches(want)[0]).__name__
        stacked = ppaging.stack_paged_planes(layers)
        assert all(torch.equal(a, b) for a, b in zip(stacked, got[:-2]))
    assert ppaging.page_nbytes(12, 12, 64, 16) == 1_179_648  # GPT-2 small, a page
    assert ppaging.page_nbytes(12, 12, 64, 16, "int8") == 313_344


@pytest.mark.parametrize("shared,length", [(0, 5), (4, 3), (8, 8), (12, 1)])
def test_suffix_prefill_mask_equals_jax(shared, length):
    got = ppaging.suffix_prefill_mask(8, CACHE, torch.tensor([shared]), torch.tensor([length]))
    want = jpaging.suffix_prefill_mask(8, CACHE, jnp.int32(shared), jnp.int32(length))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("t", [1, 3])
def test_paged_write_and_gather_bit_equal_to_jax(quant, t):
    """The same K/V through a table of scattered pages (row 0 wraps from
    logical page 3 back into page 0): the pool after the write and the
    gathered windows equal to the JAX paged write's."""
    rng = np.random.RandomState(2 * t + quant)
    p, h, ps, d, np_ = 9, 2, 4, 8, 4
    pool = [rng.randn(p, h, ps, d).astype(np.float32) for _ in range(2)]
    if quant:
        pool = [rng.randint(-127, 128, (p, h, ps, d)).astype(np.int8) for _ in range(2)]
        pool += [rng.rand(p, h, ps).astype(np.float32) for _ in range(2)]
    table = np.array([[3, 7, 1, 5], [2, 0, 8, 6]], np.int32)
    pos = np.array([15, 5], np.int32)
    k = rng.randn(2, h, t, d).astype(np.float32)
    v = rng.randn(2, h, t, d).astype(np.float32)
    pcls, jcls = ((ptf.QuantizedPagedCache, jtf.QuantizedPagedCache) if quant
                  else (ptf.PagedStaticCache, jtf.PagedStaticCache))
    pc = pcls(*(torch.from_numpy(a.copy()) for a in pool), torch.from_numpy(table),
              torch.from_numpy(pos))
    kw, vw, new = ptf.MultiHeadAttention._update_static_cache(pc, torch.from_numpy(k),
                                                              torch.from_numpy(v))
    jc = jcls(*(jnp.asarray(a) for a in pool), jnp.asarray(table), jnp.asarray(pos))
    jkw, jvw, jnew = jtf.MultiHeadAttention(h * d, h)._update_paged_cache(
        jc, jnp.asarray(k), jnp.asarray(v))
    assert new is pc and kw.shape == (2, h, np_ * ps, d)
    for a, ja in zip(new[:-2], jnew[:-2]):
        assert np.array_equal(a.numpy(), np.asarray(ja))
    assert np.array_equal(kw.numpy(), np.asarray(jkw.numpy()))
    assert np.array_equal(vw.numpy(), np.asarray(jvw.numpy()))


# -- the engine ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_paged_greedy_tokens_equal_jax_paged_and_the_ring(models, graphs, dtype):
    """Captured: warmup makes ``len(buckets) + 1`` graphs and traffic none;
    greedy tokens equal to the JAX paged engine's and the port's ring
    engine's (same dtype); every vacated slot's pages come back."""
    jm, pm = models
    prompts = _prompts(6, rng_seed=2)
    want = JEngine(jm, **_kw(kv_cache_dtype=dtype)).warmup().generate(
        prompts, max_new_tokens=6, temperature=0.0)
    ring = _ring(pm, kv_cache_dtype=dtype, jit=False).generate(prompts, max_new_tokens=6,
                                                               temperature=0.0)
    eng = _paged(pm, kv_cache_dtype=dtype).warmup()
    assert eng.graphs() == eng.compile_count() == len(graphs) == len(BUCKETS) + 1
    got = eng.generate(prompts, max_new_tokens=6, temperature=0.0)
    assert got == want == ring
    assert eng.extra_compiles() == 0
    st = eng.paging_stats()
    assert st["pages_free"] + st["prefix_index"]["pages"] == st["pages_total"]
    assert len(eng.kv) == (6 if dtype == "int8" else 4)


def _wrap_run(engine_cls, m, slots, pool_pages, device_kw):
    prompts = [[5, 9, 4], [7], [11, 2], [3, 4, 5, 6]]
    eng = engine_cls(m, slots=slots, cache_len=6, prefill_buckets=(4,), seed=2,
                     kv_cache_layout="paged", kv_page_size=2, kv_pool_pages=pool_pages,
                     **device_kw).warmup()
    toks = eng.generate(prompts, max_new_tokens=12, temperature=0.0)
    return toks, eng.paging_stats(), eng


@pytest.mark.parametrize("slots,pool_pages", [(2, 0), (1, 3)])
def test_page_boundary_wrap_with_copy_on_write_and_the_valve(graphs, slots, pool_pages):
    """Window 6, page 2, 12 tokens decoded: the ring wraps across pages and
    back into pages the prefix index holds. With the default pool the
    write copies them (copy-on-write); with one slot and a pool of one
    window no copy page exists and the index forgets the chain (the
    pressure valve). Tokens equal to the ring engine's and the JAX paged
    engine's, ``paging_stats()`` equal to the JAX engine's."""
    jm, pm = _models(window=6, seed=5)
    ring = GenerationEngine(pm, slots=slots, cache_len=6, prefill_buckets=(4,), seed=2,
                            device="cpu").warmup()
    prompts = [[5, 9, 4], [7], [11, 2], [3, 4, 5, 6]]
    want_ring = ring.generate(prompts, max_new_tokens=12, temperature=0.0)
    got, st, eng = _wrap_run(GenerationEngine, pm, slots, pool_pages, {"device": "cpu"})
    want, jst, _ = _wrap_run(JEngine, jm, slots, pool_pages, {})
    assert got == want == want_ring
    assert st == jst
    assert eng.extra_compiles() == 0
    if pool_pages:
        assert st["prefix_index"]["evictions"] > 0 and st["pages_total"] == 3
    else:
        assert st["cow_copies"] > 0


def test_prefix_reuse_tokens_and_paging_stats_equal_jax(models):
    """Three prompts sharing a full page: the second and third map it and
    prefill only their suffix; tokens equal to the ring engine's and the
    JAX paged engine's, ``paging_stats()`` equal to the JAX dict (its
    registry gauges and flight events are the monitor's, not ported)."""
    jm, pm = models
    rng = np.random.RandomState(9)
    shared = [int(t) for t in rng.randint(3, 200, size=4)]
    reqs = [shared + [t, t + 1, t + 2, t + 3] for t in (7, 19, 31)]
    want_ring = _ring(pm).generate(reqs, max_new_tokens=5, temperature=0.0, stop_at_eos=False)

    def drive(eng):
        out = []
        for i, r in enumerate(reqs):
            seq = [eng.admit(0, r, 0.0, tenant=f"t{i % 2}")]
            last = np.zeros(2, np.int32)
            for _ in range(4):
                last[0] = seq[-1]
                seq.append(int(eng.step(last, np.zeros(2, np.float32))[0]))
            eng.release_slot(0)
            out.append(seq)
        return out, eng.paging_stats()

    got, st = drive(_paged(pm).warmup())
    want, jst = drive(JEngine(jm, **_kw()).warmup())
    assert got == want == want_ring
    assert st == jst
    assert st["prefix_index"]["hits"] == 2
    assert st["per_tenant"]["t0"]["shared_tokens"] == 4
    assert st["per_tenant"]["t1"]["shared_tokens"] == 4


def test_pool_exhaustion_and_has_capacity(models):
    jm, pm = models
    a, b, c = list(range(10, 18)), list(range(30, 38)), list(range(60, 68))
    eng = _paged(pm, slots=3, kv_pool_pages=4).warmup()
    jeng = JEngine(jm, **_kw(slots=3, kv_pool_pages=4)).warmup()
    for e in (eng, jeng):
        e.admit(0, a, 0.0)
        e.admit(1, b, 0.0)
    free_before = eng.paging_stats()["pages_free"]
    assert not eng.has_capacity(c) and not jeng.has_capacity(c)
    assert not eng.has_capacity(5) and eng.has_capacity(np.int64(0))
    with pytest.raises(PagePoolExhaustedError):
        eng.admit(2, c, 0.0)
    with pytest.raises(jpaging.PagePoolExhaustedError):
        jeng.admit(2, c, 0.0)
    assert eng.paging_stats()["pages_free"] == free_before  # nothing half-allocated
    for e in (eng, jeng):
        e.release_slot(0)
        e.release_slot(1)
    assert eng.has_capacity(c) and jeng.has_capacity(c)
    assert eng.admit(2, c, 0.0) == jeng.admit(2, c, 0.0)
    assert eng.paging_stats() == jeng.paging_stats()
    assert eng.extra_compiles() == 0
    assert _ring(pm).has_capacity(c)


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_hbm_required_byte_exact_both_layouts(models, layout, dtype):
    jm, pm = models
    kw = dict(slots=3, cache_len=CACHE, prefill_buckets=BUCKETS, kv_cache_dtype=dtype,
              kv_cache_layout=layout, kv_page_size=PS)
    eng, jeng = GenerationEngine(pm, device="cpu", **kw), JEngine(jm, **kw)
    predicted = eng.hbm_required_bytes() - eng.param_nbytes()
    real = sum(a.numel() * a.element_size() for a in eng.kv)
    assert predicted == real == eng.cache_nbytes() == jeng.cache_nbytes()
    assert eng.hbm_required_bytes() == jeng.hbm_required_bytes()
    assert eng.slot_nbytes() == jeng.slot_nbytes()
    assert eng.page_nbytes() == jeng.page_nbytes()
    assert eng.hbm_required_bytes(slots=7) == jeng.hbm_required_bytes(slots=7)


def test_suggest_decode_slots_paged_geometry_and_strict_plan(models, monkeypatch):
    jm, pm = models
    eng = _paged(pm)
    pnb = eng.page_nbytes()
    per_slot = (CACHE // PS) * pnb + (CACHE // PS) * 4 + 4
    assert eng.slot_nbytes() == per_slot
    budget = eng.param_nbytes() + pnb + 5 * per_slot + per_slot // 2
    assert eng.suggest_decode_slots(budget) == 5
    assert eng.suggest_decode_slots(budget) == JEngine(jm, **_kw()).suggest_decode_slots(budget)
    assert eng.suggest_decode_slots(budget, "int8") > 5
    assert _ring(pm).slot_nbytes() == CACHE * eng.kv_bytes_per_token() + 4
    # an over-budget pool is refused at construction; a smaller one admitted
    need = eng.hbm_required_bytes(slots=8)
    monkeypatch.setattr(flags._REGISTRY["memory_budget_check"], "value", "strict")
    monkeypatch.setattr(GenerationEngine, "_budget_bytes", lambda self: need - 1)
    with pytest.raises(MemoryBudgetError, match="paged"):
        _paged(pm, slots=8)
    assert _paged(pm, slots=2).paged


def test_paged_validation(models):
    _, pm = models
    for bad in (dict(page_size=3), dict(page_size=0), dict(kv_pool_pages=-1),
                dict(kv_pool_pages=3)):
        with pytest.raises(InvalidArgumentError):
            _paged(pm, **bad)
    with pytest.raises(InvalidArgumentError, match="ring | paged"):
        GenerationEngine(pm, slots=1, cache_len=CACHE, prefill_buckets=BUCKETS, device="cpu",
                         kv_cache_layout="tiled")


def test_capture_path_reads_no_host_state(models, graphs):
    """Every replay runs with the host mirrors (table, positions, live
    slots) raising on any use, through full and suffix prefills,
    copy-on-write, release and reset: the bodies read only their device
    inputs and the persistent tensors. Tokens equal to the eager paged
    engine's, the cache tensors keep their storage, no capture after
    warmup."""
    _, pm = models

    class _Unreadable:
        def __getattr__(self, name):
            raise AssertionError(f"a graph body read host state ({name})")

        def __getitem__(self, key):
            raise AssertionError("a graph body read host state")

        def __len__(self):
            raise AssertionError("a graph body read host state")

        __iter__ = __array__ = __index__ = __bool__ = __int__ = __len__

    eng = GenerationEngine(pm, device="cpu", **_kw(kv_cache_dtype="int8", page_size=2))
    eng.warmup()

    def guard(body):
        def run():
            saved = {n: eng.__dict__[n] for n in ("_table_host", "_table_buf", "_pos_host",
                                                  "_slot_live", "_pool", "_index")}
            eng.__dict__.update({n: _Unreadable() for n in saved})
            try:
                body()
            finally:
                eng.__dict__.update(saved)
        return run

    for entry in graphs:
        entry.graph.body = guard(entry.graph.body)
    ptrs = [t.data_ptr() for t in eng.kv]
    rng = np.random.RandomState(4)
    shared = [int(t) for t in rng.randint(3, 200, size=6)]
    prompts = [shared + [int(t)] * k for k, t in zip((1, 2, 1, 2), (8, 9, 10, 11))]
    prompts += _prompts(3, rng_seed=5, lo=2, hi=8)
    got = eng.generate(prompts, max_new_tokens=14, temperature=0.0)
    eager = GenerationEngine(pm, device="cpu", jit=False, **_kw(kv_cache_dtype="int8",
                                                                page_size=2))
    assert got == eager.generate(prompts, max_new_tokens=14, temperature=0.0)
    st = eng.paging_stats()
    assert st == eager.paging_stats()
    assert st["prefix_index"]["hits"] >= 2 and st["cow_copies"] > 0
    assert sum(g.graph.replays for g in graphs) > 14 and eng.extra_compiles() == 0
    eng.reset()
    assert [t.data_ptr() for t in eng.kv] == ptrs
    assert not eng.kv[-2].any() and not eng.kv[0].any()


# -- scheduling and serving -------------------------------------------------------------


def test_batcher_releases_pages_and_waits_for_the_pool(models):
    """A pool of one window and two pages, two slots: more requests than
    the pool holds at once all complete (the head waits for pages), and a
    drained scheduler leaves every page not in the index free."""
    _, pm = models
    eng = _paged(pm, slots=2, kv_pool_pages=CACHE // PS + 2).warmup()
    total = eng.paging_stats()["pages_total"]
    sched = ContinuousBatcher(eng, queue_capacity=16).start()
    try:
        reqs = [sched.submit(p, max_new_tokens=4, temperature=0.0)
                for p in _prompts(5, rng_seed=4, lo=5, hi=9)]
        outs = [r.wait(timeout=120) for r in reqs]
        assert all(1 <= len(o) <= 4 for o in outs)
        assert sched.extra_compiles() == 0
    finally:
        sched.stop(drain=False)
    st = eng.paging_stats()
    assert st["pages_free"] + st["prefix_index"]["pages"] == total
    assert outs == _ring(pm).generate(_prompts(5, rng_seed=4, lo=5, hi=9), max_new_tokens=4,
                                      temperature=0.0)


def test_batcher_admits_when_idle_and_only_the_index_holds_pages(models):
    """A pool of one window (8 tokens, pages of 2) that the index keeps as
    one chain of 4 pages: with no slot busy, ``has_capacity`` counts only
    the chain's leaf, yet admission evicts the whole chain; the head is
    admitted, not left waiting for pages no slot will free."""
    _, pm = models
    kw = dict(slots=1, cache_len=8, prefill_buckets=(4, 8), seed=7, device="cpu")
    eng = GenerationEngine(pm, kv_cache_layout="paged", kv_page_size=2, kv_pool_pages=4,
                           **kw).warmup()
    eng.generate([list(range(10, 18))], max_new_tokens=1, temperature=0.0)
    st = eng.paging_stats()
    assert (st["prefix_index"]["pages"], st["pages_free"]) == (4, 0)
    nxt = list(range(40, 47))
    assert not eng.has_capacity(nxt)
    sched = ContinuousBatcher(eng, queue_capacity=4).start()
    try:
        out = sched.submit(nxt, max_new_tokens=3, temperature=0.0).wait(timeout=60)
    finally:
        sched.stop(drain=False)
    assert out == GenerationEngine(pm, **kw).generate([nxt], max_new_tokens=3,
                                                      temperature=0.0)[0]
    assert len(out) == 3


def test_failed_admission_returns_its_pages(models, monkeypatch):
    _, pm = models
    eng = _paged(pm, slots=2).warmup()
    total = eng.paging_stats()["pages_total"]

    def broken(*args):
        raise RuntimeError("prefill failed")

    monkeypatch.setattr(eng, "_paged_prefill_body", broken)
    sched = ContinuousBatcher(eng, queue_capacity=4).start()
    try:
        with pytest.raises(RuntimeError, match="prefill failed"):
            sched.submit([5, 6, 7, 8, 9], max_new_tokens=3).wait(timeout=60)
    finally:
        sched.stop(drain=False)
    st = eng.paging_stats()
    assert st["pages_free"] + st["prefix_index"]["pages"] == total
    assert not any(eng._slot_live)


def test_statz_paging_over_http(models):
    """``/statz`` carries the ``paging`` block (the JAX dict's keys, tenant
    accounting of the requests), ``/healthz`` the layout; a ring server
    reports its layout only."""
    jm, pm = models
    srv = GenerationServer(pm, port=0, slots=2, cache_len=CACHE, prefill_buckets=BUCKETS,
                           kv_cache_layout="paged", kv_page_size=PS, kv_cache_dtype="int8",
                           queue_capacity=8, device="cpu").start()
    try:
        shared = [5, 6, 7, 8]  # one full page
        for i, tail in enumerate(([13], [14, 15], [16])):
            body = json.dumps({"prompt": shared + tail, "max_new_tokens": 3,
                               "temperature": 0.0, "tenant": f"t{i % 2}"}).encode()
            with urlopen(srv.url + "/generate", data=body, timeout=60) as r:
                assert len(json.loads(r.read())["tokens"]) == 3
        sz = json.loads(urlopen(srv.url + "/statz", timeout=60).read())
        hz = json.loads(urlopen(srv.url + "/healthz", timeout=60).read())
    finally:
        srv.stop(drain=False)
    assert hz["kv_cache_layout"] == "paged"
    pg = sz["paging"]
    jkeys = set(JEngine(jm, **_kw()).paging_stats())
    assert set(pg) == jkeys and pg["layout"] == "paged" and pg["page_size"] == PS
    assert pg["prefix_index"]["hits"] == 2 and set(pg["per_tenant"]) == {"t0", "t1"}
    assert pg["per_tenant"]["t0"]["shared_tokens"] == pg["per_tenant"]["t1"]["shared_tokens"] == 4
    assert sz["generation"]["kv_cache_dtype"] == "int8"
    assert sz["compiles"]["unexpected"] == 0
    ring = GenerationServer(pm, port=0, slots=1, cache_len=CACHE, prefill_buckets=BUCKETS,
                            device="cpu")
    try:
        assert ring.statz()["paging"] == {"layout": "ring"}
    finally:
        ring.stop()


def test_paged_flags_build_a_paged_engine(models, monkeypatch):
    _, pm = models
    for name, value in (("kv_cache_layout", "paged"), ("generation_kv_page_size", 8),
                        ("generation_kv_pool_pages", 5)):
        monkeypatch.setattr(flags._REGISTRY[name], "value", value)
    eng = GenerationEngine(pm, slots=2, cache_len=CACHE, prefill_buckets=BUCKETS, device="cpu")
    st = eng.paging_stats()
    assert (st["layout"], st["page_size"], st["pages_total"]) == ("paged", 8, 5)
    assert eng.kv[0].shape[1] == 6  # 5 usable + the trash page
