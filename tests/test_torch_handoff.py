"""Port parity: the disaggregated prefill/decode handoff (``paddle_tpu_torch.generation.handoff`` and the engine's and servers' handoff paths).

A tiny GPT made by the JAX package from a seed (64-bit types off, its
setting), its weights moved as numpy through ``convert.gpt_state_from_numpy``.
Covered: ``pack_kv_slab`` and ``pack_kv_pages`` bytes equal to the JAX
package's for the same numpy planes and meta; every malformed slab refused
by both packages alike; a JAX ``prefill_export`` slab admitted by the
port's ``admit_prefilled`` decoding the JAX single engine's tokens, and the
reverse; the port's exported planes within 1e-5 of the JAX engine's in f32
and bit-equal in int8; the port-to-port round trip past the ring's wrap;
arity, geometry and prompt refusals; the page handoff with ``known_hashes``
and the refusal of an unknown header-only page with no page taken
(``tests/test_paged_kv.py:416-496``); a prefill tier holding no decode
cache; the batcher's handoff admissions; and the ``prefill`` and ``decode``
server kinds (``tests/test_speculative.py:219-481`` without the router):
routes, 404 naming the kind, ``/prefix_known``, 400s, and slabs crossing
between the JAX and the port servers over HTTP.
"""
import json
import struct
import sys
import threading
import time
import zlib
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu.generation import GenerationEngine as JEngine  # noqa: E402
from paddle_tpu.generation import handoff as jhandoff  # noqa: E402
from paddle_tpu.serving import GenerationServer as JServer  # noqa: E402

from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import models as pmodels  # noqa: E402
from paddle_tpu_torch.errors import InvalidArgumentError, PreconditionNotMetError  # noqa: E402
from paddle_tpu_torch.generation import (  # noqa: E402
    GenerationEngine,
    HandoffError,
    chain_hashes,
    pack_kv_pages,
    pack_kv_slab,
    unpack_kv_pages,
    unpack_kv_slab,
)
from paddle_tpu_torch.serving import ContinuousBatcher, GenerationServer  # noqa: E402

torch.set_num_threads(1)

CACHE = 24
BUCKETS = (4, 8)
PS = 4  # tokens a page: 6 pages a slot


@pytest.fixture(autouse=True)
def _x64_off():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def models():
    with jax.enable_x64(False):
        paddle.seed(3)
        cfg = jmodels.gpt_tiny_config()
        cfg.attention_window = CACHE
        jm = jmodels.GPTForCausalLM(cfg)
        jm.eval()
        state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    pm = pmodels.GPTForCausalLM(pmodels.GPTConfig(**vars(cfg)))
    pm.load_state_dict(convert.gpt_state_from_numpy(state, pm))
    return jm, pm.eval()


def _engine(model, slots=2, **kw):
    return GenerationEngine(model, slots=slots, cache_len=CACHE, prefill_buckets=BUCKETS,
                            seed=7, device="cpu", **kw)


def _jengine(model, slots=2, **kw):
    return JEngine(model, slots=slots, cache_len=CACHE, prefill_buckets=BUCKETS, seed=7, **kw)


def _paged(model, slots=2, **kw):
    return _engine(model, slots=slots, kv_cache_layout="paged", kv_page_size=PS, **kw)


def _prompts(n, rng_seed=0, lo=1, hi=9):
    rng = np.random.RandomState(rng_seed)
    return [list(map(int, rng.randint(3, 200, size=int(rng.randint(lo, hi)))))
            for _ in range(n)]


def _decode_slot(eng, slot, first, steps):
    """``steps`` greedy decode steps of ``slot`` after its admission:
    the first token and the ones decoded."""
    got = [int(first)]
    last = np.zeros(eng.slots, np.int32)
    temps = np.zeros(eng.slots, np.float32)
    last[slot] = first
    for _ in range(steps):
        nxt = eng.step(last, temps)
        got.append(int(nxt[slot]))
        last[slot] = nxt[slot]
    return got


def _planes(dtype, seed=0, c=CACHE):
    rng = np.random.RandomState(seed)
    shape = (2, 2, c, 16)
    if dtype == "int8":
        return (rng.randint(-127, 128, shape).astype(np.int8),
                rng.randint(-127, 128, shape).astype(np.int8),
                rng.rand(*shape[:-1]).astype(np.float32),
                rng.rand(*shape[:-1]).astype(np.float32))
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


# -- the wire formats ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pack_kv_slab_bytes_equal_jax(dtype):
    planes = _planes(dtype)
    meta = {"params": {"prompt": [5, 6, 7], "max_new_tokens": 4, "temperature": 0.0,
                       "deadline_ms": None, "stream": False, "tenant": "t"},
            "cache": {"layers": 2, "heads": 2, "head_dim": 16, "cache_len": CACHE,
                      "kv_dtype": dtype}}
    blob = pack_kv_slab(planes, 3, 17, meta=meta)
    assert blob == jhandoff.pack_kv_slab(planes, 3, 17, meta=meta)
    assert blob[:4] == b"PTKV"
    # a tensor on the host packs as its numpy array does
    assert pack_kv_slab(tuple(torch.from_numpy(p) for p in planes), 3, 17, meta=meta) == blob
    got, n, tok, m = unpack_kv_slab(blob)
    assert (n, tok, m) == (3, 17, meta)
    for a, b in zip(got, planes):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pack_kv_pages_bytes_equal_jax(dtype):
    planes = _planes(dtype, seed=1, c=PS)
    pages = [{"id": 0, "hash": "ab" * 16, "planes": None, "refcount": 3},
             {"id": 1, "hash": "cd" * 16, "planes": planes},
             {"id": 2, "hash": None, "planes": tuple(p[..., :PS, :] if p.ndim == 4 else p
                                                      for p in planes)}]
    blob = pack_kv_pages(pages, 10, 9, PS, meta={"x": [1, 2]})
    assert blob == jhandoff.pack_kv_pages(pages, 10, 9, PS, meta={"x": [1, 2]})
    assert blob[:4] == b"PTKP"
    slab = unpack_kv_pages(blob)
    assert (slab.length, slab.first_token, slab.page_size, slab.meta) == (10, 9, PS,
                                                                          {"x": [1, 2]})
    assert slab.pages[0]["planes"] is None and slab.pages[0]["hash"] == "ab" * 16
    np.testing.assert_array_equal(slab.pages[1]["planes"][0], planes[0])


def _reframe(blob, mutate):
    """``blob`` with its header edited by ``mutate`` and a fresh CRC: a
    corrupt slab that passes the checksum."""
    head = struct.Struct(">4sHI")
    magic, version, hlen = head.unpack_from(blob, 0)
    header = json.loads(blob[head.size:head.size + hlen])
    mutate(header)
    hb = json.dumps(header, separators=(",", ":")).encode()
    body = head.pack(magic, version, len(hb)) + hb + blob[head.size + hlen:-4]
    return body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def _forge_slab(spec):
    header = json.dumps({"planes": [spec], "length": 1, "first_token": 0, "meta": {}},
                        separators=(",", ":")).encode()
    body = struct.pack(">4sHI", b"PTKV", 1, len(header)) + header
    return body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def _slab_cases():
    arr = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    blob = pack_kv_slab((arr, arr), 3, 17, meta={"x": 1})
    return {
        "truncated payload": blob[:-5], "truncated header": blob[:10],
        "flipped byte": blob[:40] + b"\x7f" + blob[41:], "bad magic": b"nope" + blob[4:],
        "trailing bytes": blob + b"extra", "empty": b"",
        "version 2": blob[:4] + struct.pack(">H", 2) + blob[6:],
        "object dtype": _forge_slab({"shape": [1], "dtype": "object"}),
        "negative dim": _forge_slab({"shape": [-1, 4], "dtype": "float32"}),
        "str dtype": _forge_slab({"shape": [2], "dtype": "str"}),
        "complex dtype": _forge_slab({"shape": [2], "dtype": "complex128"}),
        "plane overruns": _forge_slab({"shape": [1000], "dtype": "float32"}),
        "header not json": _reframe(blob, lambda h: h.update(length="x")),
    }


def _pages_blob():
    k = np.arange(2 * 2 * 4 * 3, dtype=np.float32).reshape(2, 2, 4, 3)
    return pack_kv_pages([{"id": 0, "hash": "ab" * 16, "planes": (k, k + 1)},
                          {"id": 1, "hash": None, "planes": (k + 2, k + 3)}], 6, 5, 4)


def _pages_cases():
    blob = _pages_blob()
    head = struct.Struct(">4sHI")
    hlen = head.unpack_from(blob, 0)[2]
    flipped = bytearray(blob[:-4])
    flipped[head.size + hlen + 8] ^= 0x40
    flipped = bytes(flipped) + struct.pack(">I", zlib.crc32(bytes(flipped)) & 0xFFFFFFFF)
    return {
        "truncated": blob[:-3], "v1 magic": b"PTKV" + blob[4:], "empty": b"",
        "trailing": blob + b"x",
        "page list short": _reframe(blob, lambda h: h["pages"].pop()),
        "duplicate ids": _reframe(blob, lambda h: h["pages"][1].update(id=0)),
        "refcount overflow": _reframe(blob, lambda h: h["pages"][0].update(refcount=1 << 31)),
        "refcount negative": _reframe(blob, lambda h: h["pages"][0].update(refcount=-1)),
        "payload hash mismatch": flipped,
        "absent page without a hash": _reframe(
            blob, lambda h: h["pages"][1].update(present=False, planes=None, hash=None)),
        "present page without planes": _reframe(blob, lambda h: h["pages"][0].update(
            planes=None)),
        "zero page size": _reframe(blob, lambda h: h.update(page_size=0)),
    }


@pytest.mark.parametrize("case", sorted(_slab_cases()))
def test_malformed_slabs_refused_as_jax_refuses_them(case):
    bad = _slab_cases()[case]
    with pytest.raises(jhandoff.HandoffError):
        jhandoff.unpack_kv_slab(bad)
    with pytest.raises(HandoffError):
        unpack_kv_slab(bad)


@pytest.mark.parametrize("case", sorted(_pages_cases()))
def test_malformed_page_slabs_refused_as_jax_refuses_them(case):
    bad = _pages_cases()[case]
    with pytest.raises(jhandoff.HandoffError):
        jhandoff.unpack_kv_pages(bad)
    with pytest.raises(HandoffError):
        unpack_kv_pages(bad)


def test_pack_refuses_a_refcount_overflow():
    k = np.zeros((2, 2, 4, 3), np.float32)
    page = [{"id": 0, "hash": None, "planes": (k, k), "refcount": 1 << 31}]
    with pytest.raises(HandoffError, match="refcount"):
        pack_kv_pages(page, 4, 1, 4)
    assert issubclass(HandoffError, InvalidArgumentError)


# -- the engine's handoff ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_exported_planes_match_the_jax_engine(models, dtype):
    """The same prompt exported by both engines: planes within 1e-5 in f32,
    bit-equal in int8; the same first token and length."""
    jm, pm = models
    jpre = _jengine(jm, slots=1, kv_cache_dtype=dtype).warmup(kind="prefill")
    pre = _engine(pm, slots=1, kv_cache_dtype=dtype).warmup(kind="prefill")
    for p in _prompts(3, rng_seed=6):
        jplanes, jn, jtok = jpre.prefill_export(p, temperature=0.0)
        planes, n, tok = pre.prefill_export(p, temperature=0.0)
        assert (n, tok) == (jn, jtok)
        assert len(planes) == len(jplanes) == (4 if dtype == "int8" else 2)
        for a, b in zip(planes, jplanes):
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            if a.dtype == np.int8:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_slabs_cross_between_the_packages(models, dtype):
    """A JAX prefill tier's slab admitted by the port's decode engine, and
    the port's by the JAX one, each decoding the JAX single engine's
    greedy tokens past the ring's wrap."""
    jm, pm = models
    ref = _jengine(jm, slots=1, kv_cache_dtype=dtype).warmup()
    jpre = _jengine(jm, slots=1, kv_cache_dtype=dtype).warmup(kind="prefill")
    jdec = _jengine(jm, kv_cache_dtype=dtype).warmup(kind="decode")
    pre = _engine(pm, slots=1, kv_cache_dtype=dtype).warmup(kind="prefill")
    dec = _engine(pm, kv_cache_dtype=dtype).warmup(kind="decode")
    for p in _prompts(2, rng_seed=7):
        want = ref.generate([p], max_new_tokens=CACHE + 6, temperature=0.0,
                            stop_at_eos=False)[0]
        planes, n, tok, _ = unpack_kv_slab(jhandoff.pack_kv_slab(
            *jpre.prefill_export(p, temperature=0.0)))
        assert _decode_slot(dec, 1, dec.admit_prefilled(1, planes, n, tok), CACHE + 5) == want
        planes, n, tok, _ = jhandoff.unpack_kv_slab(pack_kv_slab(
            *pre.prefill_export(p, temperature=0.0)))
        jgot = [jdec.admit_prefilled(0, planes, n, tok)]
        last, temps = np.zeros(2, np.int32), np.zeros(2, np.float32)
        last[0] = jgot[0]
        for _ in range(CACHE + 5):
            nxt = jdec.step(last, temps)
            jgot.append(int(nxt[0]))
            last[0] = nxt[0]
        assert jgot == want
    assert dec.extra_compiles() == 0


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_handoff_bytes_roundtrip_decode_parity(models, dtype):
    """Export -> bytes -> another engine's ``admit_prefilled`` -> decoding
    equal to the single engine's, past the wrap; the prefill tier's decode
    cache is gone and the decode tier captures nothing after warmup."""
    _, pm = models
    ref = _engine(pm, slots=1, kv_cache_dtype=dtype).warmup()
    pre = _engine(pm, slots=1, kv_cache_dtype=dtype).warmup(kind="prefill")
    dec = _engine(pm, kv_cache_dtype=dtype).warmup(kind="decode")
    for p in _prompts(3, rng_seed=6):
        want = ref.generate([p], max_new_tokens=CACHE + 6, temperature=0.0,
                            stop_at_eos=False)[0]
        planes, n, tok = pre.prefill_export(p, temperature=0.0)
        planes2, n2, tok2, meta = unpack_kv_slab(pack_kv_slab(planes, n, tok,
                                                              meta={"prompt": p}))
        assert (n2, tok2, meta["prompt"]) == (n, tok, p)
        assert _decode_slot(dec, 1, dec.admit_prefilled(1, planes2, n2, tok2),
                            CACHE + 5) == want
    assert dec.extra_compiles() == 0 and pre.extra_compiles() == 0


def test_handoff_arity_and_geometry_refused(models):
    """A slab of the other cache dtype, a length outside the window, a
    plane of another width, or a plane on another device is refused before
    anything is installed."""
    _, pm = models
    pre8 = _engine(pm, slots=1, kv_cache_dtype="int8").warmup(kind="prefill")
    dec = _engine(pm, slots=1).warmup(kind="decode")
    planes, n, tok = pre8.prefill_export([4, 5, 6])
    before = [a.clone() for a in dec.kv]
    with pytest.raises(InvalidArgumentError):
        dec.admit_prefilled(0, planes, n, tok)  # 4 planes into f32
    fresh = dec._fresh_slot_planes()
    for length in (0, CACHE + 1):
        with pytest.raises(InvalidArgumentError):
            dec.admit_prefilled(0, fresh, length, 0)
    wide = tuple(np.zeros(p.shape[:2] + (CACHE + 1,) + p.shape[3:], p.dtype) for p in fresh)
    with pytest.raises(InvalidArgumentError):
        dec.admit_prefilled(0, wide, 2, 0)
    narrow = tuple(p[:, :1] for p in fresh)  # one head
    with pytest.raises(InvalidArgumentError):
        dec.admit_prefilled(0, narrow, 2, 0)
    meta = tuple(torch.empty(p.shape, device="meta") for p in fresh)
    with pytest.raises(InvalidArgumentError, match="meta"):
        dec.admit_prefilled(0, meta, 2, 0)
    assert all(torch.equal(a, b) for a, b in zip(before, dec.kv))


def test_prefill_tier_holds_no_decode_cache(models):
    """A prefill tier's warmup drops the decode cache (ring and pool) and
    its exports still run; it refuses to decode."""
    _, pm = models
    eng = _engine(pm, slots=8)
    assert eng.cache_nbytes() > 0
    eng.warmup(kind="prefill")
    assert eng.cache_nbytes() == 0 and eng.kv[0].shape[1] == 0
    planes, n, tok = eng.prefill_export([3, 4, 5])
    assert n == 3 and planes[0].shape[2] == CACHE
    with pytest.raises(PreconditionNotMetError, match="prefill tier"):
        eng.step(np.zeros(8, np.int32), np.zeros(8, np.float32))
    paged = _paged(pm, slots=4).warmup(kind="prefill")
    assert paged.kv[0].shape[1] == 1  # the trash page alone
    assert paged.paging_stats()["pages_total"] == 0
    assert paged.known_page_hashes(["ab"]) == set()
    pages, n, tok = paged.prefill_export_pages([3, 4, 5, 6, 7])
    assert [p["hash"] is None for p in pages] == [False, True]


def test_page_handoff_end_to_end_and_prefix_peer(models):
    """``prefill_export_pages`` -> wire -> ``admit_prefilled_pages`` equals
    the single engine's generation; a second handoff of the prompt ships
    its full pages header-only, mapped out of the decode tier's index; a
    header-only page the receiver does not hold refuses the whole slab
    with no page taken."""
    _, pm = models
    prompt = _prompts(1, rng_seed=6, lo=7, hi=9)[0]
    want = _engine(pm, slots=1).warmup().generate([prompt], max_new_tokens=6,
                                                   temperature=0.0, stop_at_eos=False)[0]
    pre = _paged(pm, slots=1).warmup(kind="prefill")
    dec = _paged(pm).warmup(kind="decode")

    def drive(slab, slot):
        first = dec.admit_prefilled_pages(slot, slab.pages, slab.length, slab.first_token,
                                          page_size=slab.page_size, tenant="fleet")
        return _decode_slot(dec, slot, first, 5)

    pages, n, tok = pre.prefill_export_pages(prompt, temperature=0.0)
    slab = unpack_kv_pages(pack_kv_pages(pages, n, tok, PS))
    assert all(p["planes"] is not None for p in slab.pages)
    assert drive(slab, 0) == want
    hashes = chain_hashes(prompt, PS)
    known = dec.known_page_hashes(hashes)
    assert known == set(hashes)
    pages2, n2, tok2 = pre.prefill_export_pages(prompt, temperature=0.0, known_hashes=known)
    assert sum(p["planes"] is not None for p in pages2) == len(pages2) - len(hashes)
    slab2 = unpack_kv_pages(pack_kv_pages(pages2, n2, tok2, PS))
    assert drive(slab2, 1) == want
    stats = dec.paging_stats()
    assert stats["prefix_index"]["hits"] >= 1
    assert stats["per_tenant"]["fleet"]["shared_tokens"] == len(hashes) * PS
    assert dec.extra_compiles() == 0
    fresh = _paged(pm, slots=1).warmup(kind="decode")
    before = fresh.paging_stats()
    with pytest.raises(HandoffError, match="header-only"):
        fresh.admit_prefilled_pages(0, slab2.pages, slab2.length, slab2.first_token,
                                    page_size=slab2.page_size)
    after = fresh.paging_stats()
    assert (after["pages_free"], after["pages_used"]) == (before["pages_free"],
                                                          before["pages_used"])


def test_page_handoff_equals_the_jax_engines(models):
    """The JAX paged prefill tier's pages land on the port's paged decode
    tier (and the port's on the JAX one's) and decode alike."""
    jm, pm = models
    prompt = _prompts(1, rng_seed=8, lo=6, hi=9)[0]
    jpre = JEngine(jm, slots=1, cache_len=CACHE, prefill_buckets=BUCKETS, seed=7,
                   kv_cache_layout="paged", kv_page_size=PS).warmup(kind="prefill")
    jdec = JEngine(jm, slots=2, cache_len=CACHE, prefill_buckets=BUCKETS, seed=7,
                   kv_cache_layout="paged", kv_page_size=PS).warmup(kind="decode")
    dec = _paged(pm).warmup(kind="decode")
    pre = _paged(pm, slots=1).warmup(kind="prefill")
    want = _jengine(jm, slots=1).warmup().generate([prompt], max_new_tokens=6,
                                                  temperature=0.0, stop_at_eos=False)[0]
    slab = unpack_kv_pages(jhandoff.pack_kv_pages(*jpre.prefill_export_pages(prompt, 0.0), PS))
    first = dec.admit_prefilled_pages(0, slab.pages, slab.length, slab.first_token,
                                      page_size=PS)
    assert _decode_slot(dec, 0, first, 5) == want
    jslab = jhandoff.unpack_kv_pages(pack_kv_pages(*pre.prefill_export_pages(prompt, 0.0), PS))
    jgot = [jdec.admit_prefilled_pages(1, jslab.pages, jslab.length, jslab.first_token,
                                       page_size=PS)]
    last, temps = np.zeros(2, np.int32), np.zeros(2, np.float32)
    last[1] = jgot[0]
    for _ in range(5):
        nxt = jdec.step(last, temps)
        jgot.append(int(nxt[1]))
        last[1] = nxt[1]
    assert jgot == want


def test_v1_slab_lands_on_paged_tier(models):
    """A ring prefill tier's contiguous slab lands on a paged decode tier
    (cut into anonymous pages)."""
    _, pm = models
    prompt = [5, 6, 7, 8, 9]
    want = _engine(pm, slots=1).warmup().generate([prompt], max_new_tokens=6,
                                                  temperature=0.0, stop_at_eos=False)[0]
    pre = _engine(pm, slots=1).warmup(kind="prefill")
    dec = _paged(pm).warmup(kind="decode")
    planes, n, tok = pre.prefill_export(prompt, temperature=0.0)
    assert _decode_slot(dec, 1, dec.admit_prefilled(1, planes, n, tok), 5) == want
    assert dec.extra_compiles() == 0


def test_page_size_and_page_shape_mismatch_refused(models):
    _, pm = models
    dec = _paged(pm, slots=1)
    k = np.zeros((2, 2, 8, 16), np.float32)
    with pytest.raises(HandoffError, match="page_size"):
        dec.admit_prefilled_pages(0, [{"id": 0, "hash": None, "planes": (k, k)}], 8, 1,
                                  page_size=8)
    k = np.zeros((2, 2, PS, 8), np.float32)  # half the head width
    with pytest.raises(HandoffError, match="does not match"):
        dec.admit_prefilled_pages(0, [{"id": 0, "hash": None, "planes": (k, k)}], PS, 1)
    with pytest.raises(HandoffError, match="needs 2"):
        dec.admit_prefilled_pages(0, [{"id": 0, "hash": None, "planes": (k, k)}], PS + 1, 1)
    with pytest.raises(InvalidArgumentError, match="paged"):
        _engine(pm, slots=1).admit_prefilled_pages(0, [], 1, 1)
    assert dec.paging_stats()["pages_used"] == 0


# -- the batcher ------------------------------------------------------------------------------


def test_batcher_handoff_admissions(models):
    """``submit_prefilled`` decodes the single engine's tokens; both handoff
    submits refuse what ``submit`` refuses (a length outside the window, a
    budget below one or past the positions), a page slab on a ring tier,
    and a speculative tier's slab without its prompt."""
    _, pm = models
    ref = _engine(pm, slots=1).warmup()
    pre = _engine(pm, slots=1).warmup(kind="prefill")
    sched = ContinuousBatcher(_engine(pm).warmup(kind="decode"), queue_capacity=4).start()
    try:
        prompt = [9, 2, 14, 6]
        want = ref.generate([prompt], max_new_tokens=7, temperature=0.0)[0]
        planes, n, tok = pre.prefill_export(prompt, temperature=0.0)
        req = sched.submit_prefilled(planes, n, tok, max_new_tokens=7, temperature=0.0)
        assert req.wait(60) == want and req.prompt_len == 4
        for length, budget in ((0, 2), (CACHE + 1, 2), (3, 0), (3, 10 ** 6)):
            with pytest.raises(InvalidArgumentError):
                sched.submit_prefilled(planes, length, tok, max_new_tokens=budget)
        with pytest.raises(InvalidArgumentError, match="paged"):
            sched.submit_prefilled_pages(unpack_kv_pages(_pages_blob()))
    finally:
        sched.stop(drain=False)
    draft = pmodels.truncated_draft(pm, 1)
    spec = ContinuousBatcher(_engine(pm, draft_model=draft, draft_k=2), queue_capacity=4)
    with pytest.raises(InvalidArgumentError, match="prompt"):
        spec.submit_prefilled(planes, n, tok)
    paged = ContinuousBatcher(_paged(pm), queue_capacity=4)
    with pytest.raises(InvalidArgumentError, match="PageSlab"):
        paged.submit_prefilled_pages((planes, n, tok))
    for s in (spec, paged):
        s.close(drain=False)


# -- the server kinds ---------------------------------------------------------------------


def test_concurrent_exports_run_one_at_a_time(models):
    """Exports from 12 threads at once: the tier admits
    ``PREFILL_CONCURRENCY`` of them (the others wait, as ``/loadz`` and
    ``/statz`` count), the engine's lock runs their forwards one at a time
    over the one export buffer, each equals its solo export, and the
    waiting and running counts return to 0."""
    from paddle_tpu_torch.serving.server import PREFILL_CONCURRENCY

    _, pm = models
    srv = GenerationServer(_engine(pm, slots=1), kind="prefill").warmup()
    eng = srv.engine
    prompts = _prompts(12, rng_seed=11)
    solo = [eng.prefill_export(p, 0.0) for p in prompts]
    inside, peak = [0], [0]
    dispatch = eng._dispatch

    def watched(*args, **kw):
        inside[0] += 1
        peak[0] = max(peak[0], inside[0])
        try:
            return dispatch(*args, **kw)
        finally:
            inside[0] -= 1

    eng._dispatch = watched
    results = [None] * len(prompts)

    def client(i):
        results[i] = srv.run_prefill(prompts[i], 0.0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with eng._lock:  # hold the forwards until every client has arrived
            threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 30
            while srv.loadz()["queue_depth"] < len(prompts) - PREFILL_CONCURRENCY \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            lz = srv.loadz()
            held = dict(srv.statz()["prefill"])
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert held == {"waiting": len(prompts) - PREFILL_CONCURRENCY,
                    "active": PREFILL_CONCURRENCY, "concurrency": PREFILL_CONCURRENCY}
    assert lz["queue_depth"] == len(prompts) - PREFILL_CONCURRENCY
    assert lz["slot_occupancy"] == 1.0
    assert peak[0] == 1
    for (planes, n, tok), (want, wn, wtok) in zip(results, solo):
        assert (n, tok) == (wn, wtok)
        assert all(np.array_equal(a, b) for a, b in zip(planes, want))
    assert srv.statz()["prefill"] == {"waiting": 0, "active": 0,
                                      "concurrency": PREFILL_CONCURRENCY}
    srv.stop()


def test_concurrent_prefill_slabs_equal_serial_ones(models):
    """Slabs answered by 8 concurrent ``/prefill`` requests are byte-equal
    to the same requests answered one at a time."""
    _, pm = models
    srv = GenerationServer(_engine(pm, slots=1), kind="prefill", queue_capacity=4).start()
    try:
        bodies = [{"prompt": p, "max_new_tokens": 3, "temperature": 0.0}
                  for p in _prompts(8, rng_seed=5)]
        serial = [_post(srv.url + "/prefill", b)[1] for b in bodies]
        got = [None] * len(bodies)

        def client(i):
            got[i] = _post(srv.url + "/prefill", bodies[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert [g[0] for g in got] == [200] * len(bodies)
        assert [g[1] for g in got] == serial
    finally:
        srv.stop(drain=False)


def _post(url, data, timeout=60):
    data = data if isinstance(data, bytes) else json.dumps(data).encode()
    try:
        r = urlopen(Request(url, data=data), timeout=timeout)
        return r.status, r.read(), r.headers
    except HTTPError as e:
        return e.code, e.read(), e.headers


def test_prefill_kind_server_routes_and_slab(models):
    _, pm = models
    srv = GenerationServer(_engine(pm, slots=1), kind="prefill", queue_capacity=4).start()
    try:
        body = {"prompt": [5, 6, 7], "max_new_tokens": 4, "temperature": 0.0}
        status, blob, headers = _post(srv.url + "/prefill", body)
        assert status == 200
        assert headers["Content-Type"].startswith("application/x-ptpu-kv-slab")
        planes, n, tok, meta = unpack_kv_slab(blob)
        assert n == 3 and meta["params"]["prompt"] == [5, 6, 7]
        cfg = pm.config
        assert meta["cache"] == srv.cache_geometry() == {
            "layers": cfg.num_hidden_layers, "heads": cfg.num_attention_heads,
            "head_dim": cfg.hidden_size // cfg.num_attention_heads, "cache_len": CACHE,
            "kv_dtype": "float32"}
        status, raw, _ = _post(srv.url + "/generate", body)
        assert status == 404 and "'prefill'" in json.loads(raw)["error"]
        for bad in ({"prompt": []}, {"prompt": [1] * 9}, {"prompt": [500]},
                    {"prompt": [1], "page_format": True}):
            assert _post(srv.url + "/prefill", bad)[0] == 400, bad
        routes = json.loads(urlopen(srv.url + "/").read())["routes"]
        assert routes[0] == "/prefill (POST)"
        sz = json.loads(urlopen(srv.url + "/statz").read())
        assert sz["compiles"]["expected"] == len(BUCKETS) and sz["compiles"]["unexpected"] == 0
        assert sz["prefill"] == {"waiting": 0, "active": 0, "concurrency": 4}
        assert sz["generation"]["kv_cache_bytes"] == 0 and srv.scheduler.alive == 0
    finally:
        srv.stop(drain=False)


def test_decode_kind_server_generate_kv_parity(models):
    _, pm = models
    ref = _engine(pm, slots=1).warmup()
    pre = GenerationServer(_engine(pm, slots=1), kind="prefill", queue_capacity=4).start()
    dec = GenerationServer(_engine(pm), kind="decode", queue_capacity=4).start()
    try:
        prompt = [9, 2, 14, 6]
        want = ref.generate([prompt], max_new_tokens=7, temperature=0.0,
                            stop_at_eos=False)[0]
        body = {"prompt": prompt, "max_new_tokens": 7, "temperature": 0.0}
        slab = _post(pre.url + "/prefill", body)[1]
        status, raw, _ = _post(dec.url + "/generate_kv", slab)
        out = json.loads(raw)
        assert status == 200 and out["tokens"] == want and out["prompt_tokens"] == len(prompt)
        # streamed: the request's own flag rides in the slab
        slab = _post(pre.url + "/prefill", dict(body, stream=True))[1]
        lines = [json.loads(x) for x in _post(dec.url + "/generate_kv", slab)[1].splitlines()]
        assert [x["token"] for x in lines if "token" in x] == want and lines[-1]["done"]
        planes, n, tok, meta = unpack_kv_slab(slab)
        meta["cache"]["cache_len"] = CACHE + 8
        assert _post(dec.url + "/generate_kv", pack_kv_slab(planes, n, tok, meta=meta))[0] == 400
        assert _post(dec.url + "/generate_kv", b"junk")[0] == 400
        assert _post(dec.url + "/generate", body)[0] == 404
        sz = json.loads(urlopen(dec.url + "/statz").read())
        assert sz["compiles"]["unexpected"] == 0 and sz["compiles"]["expected"] == 1
        assert sz["requests"]["completed"] == 2
    finally:
        pre.stop(drain=False)
        dec.stop(drain=False)


def test_prefix_known_and_the_page_wire_over_http(models):
    """``/prefix_known`` answers the hashes a paged decode tier holds (none
    on the ring), the prefill tier ships those pages header-only, and the
    decode tier's ``/statz`` ``paging`` counts the hit."""
    _, pm = models
    ref = _engine(pm, slots=1, kv_cache_dtype="int8").warmup()
    pre = GenerationServer(_paged(pm, slots=1, kv_cache_dtype="int8"), kind="prefill").start()
    dec = GenerationServer(_paged(pm, kv_cache_dtype="int8"), kind="decode").start()
    ring = GenerationServer(_engine(pm, slots=1), kind="generate").start()
    try:
        prompt = list(range(3, 10))
        want = ref.generate([prompt], max_new_tokens=6, temperature=0.0, stop_at_eos=False)[0]
        hashes = chain_hashes(prompt, PS)
        absent = []
        for _ in range(2):
            status, raw, _ = _post(dec.url + "/prefix_known", {"hashes": hashes})
            ans = json.loads(raw)
            assert status == 200 and ans["layout"] == "paged"
            status, blob, headers = _post(pre.url + "/prefill", {
                "prompt": prompt, "max_new_tokens": 6, "temperature": 0.0,
                "page_format": True, "known_hashes": ans["known"]})
            assert status == 200 and headers["Content-Type"].startswith(
                "application/x-ptpu-kv-pages")
            absent.append([p["planes"] is None for p in unpack_kv_pages(blob).pages])
            status, raw, _ = _post(dec.url + "/generate_kv", blob)
            assert status == 200 and json.loads(raw)["tokens"] == want
        assert absent == [[False, False], [True, False]]
        paging = json.loads(urlopen(dec.url + "/statz").read())["paging"]
        assert paging["prefix_index"]["hits"] == 1
        assert json.loads(_post(ring.url + "/prefix_known", {"hashes": hashes})[1]) == {
            "known": [], "layout": "ring"}
        assert _post(ring.url + "/prefix_known", b"[1, 2]")[0] == 400
        assert _post(ring.url + "/generate_kv", blob)[0] == 404
    finally:
        for s in (pre, dec, ring):
            s.stop(drain=False)


def test_speculative_decode_tier_needs_the_prompt_and_a_bucket(models):
    """A speculative decode tier refuses (400) a slab whose prompt did not
    ride along, and one whose prompt no bucket of its own ladder covers;
    with the prompt it decodes the plain engine's tokens."""
    _, pm = models
    draft = pmodels.truncated_draft(pm, 1)
    ref = _engine(pm, slots=1).warmup()
    pre = GenerationServer(_engine(pm, slots=1), kind="prefill", queue_capacity=4).start()
    dec = GenerationServer(_engine(pm, draft_model=draft, draft_k=2), kind="decode",
                           queue_capacity=4).start()
    short = GenerationServer(
        GenerationEngine(pm, slots=1, cache_len=CACHE, prefill_buckets=(4,), seed=7,
                         draft_model=draft, draft_k=2, device="cpu"),
        kind="decode", queue_capacity=4).start()
    try:
        prompt = [1 + i for i in range(6)]
        body = {"prompt": prompt, "max_new_tokens": 5, "temperature": 0.0}
        slab = _post(pre.url + "/prefill", body)[1]
        status, raw, _ = _post(dec.url + "/generate_kv", slab)
        assert status == 200 and json.loads(raw)["tokens"] == ref.generate(
            [prompt], max_new_tokens=5, temperature=0.0)[0]
        assert _post(short.url + "/generate_kv", slab)[0] == 400
        planes, n, tok, meta = unpack_kv_slab(slab)
        del meta["params"]["prompt"]
        status, raw, _ = _post(dec.url + "/generate_kv", pack_kv_slab(planes, n, tok, meta=meta))
        assert status == 400 and "prompt" in json.loads(raw)["error"]
        with pytest.raises(InvalidArgumentError):
            dec.engine.admit_prefilled(0, dec.engine._fresh_slot_planes(), 2, 0)
        dec.engine.admit_prefilled(0, dec.engine._fresh_slot_planes(), 2, 0, prompt=[3, 4])
        assert dec.engine.extra_compiles() == 0
    finally:
        for s in (pre, dec, short):
            s.stop(drain=False)


@pytest.mark.parametrize("tier", ["ring", "paged", "speculative"])
def test_decode_tier_refuses_out_of_range_slab_scalars(models, tier):
    """A well-formed slab (its own CRC) whose first token lies outside the
    vocabulary, or whose riding prompt is not ``length`` ids inside it, is
    refused with 400 before it reaches a slot (the first token feeds the
    next round's embedding gather); the tier goes on serving. The engine's
    admissions refuse the same scalars when called directly."""
    _, pm = models
    vocab = pm.config.vocab_size
    paged = tier == "paged"
    ref = _engine(pm, slots=1).warmup()
    pre = GenerationServer(_paged(pm, slots=1) if paged else _engine(pm, slots=1),
                           kind="prefill", queue_capacity=4).start()
    eng = (_paged(pm) if paged else _engine(pm, draft_model=pmodels.truncated_draft(pm, 1),
                                            draft_k=2) if tier == "speculative" else _engine(pm))
    dec = GenerationServer(eng, kind="decode", queue_capacity=4).start()
    prompt = [9, 2, 14, 6, 3]
    body = {"prompt": prompt, "max_new_tokens": 5, "temperature": 0.0, "page_format": paged}
    want = ref.generate([prompt], max_new_tokens=5, temperature=0.0, stop_at_eos=False)[0]

    def repack(blob, tok, params):
        if paged:
            slab = unpack_kv_pages(blob)
            meta = dict(slab.meta, params=dict(slab.meta["params"], **params))
            return pack_kv_pages(slab.pages, slab.length, tok, slab.page_size, meta=meta)
        planes, n, _, meta = unpack_kv_slab(blob)
        meta = dict(meta, params=dict(meta["params"], **params))
        return pack_kv_slab(planes, n, tok, meta=meta)

    try:
        blob = _post(pre.url + "/prefill", body)[1]
        good = unpack_kv_pages(blob).first_token if paged else unpack_kv_slab(blob)[2]
        bad = [repack(blob, t, {}) for t in (-1, vocab, 2 ** 40)]
        bad += [repack(blob, good, {"prompt": p})
                for p in (prompt[:-1], prompt + [1], prompt[:-1] + [vocab], prompt[:-1] + [-2])]
        for i, slab in enumerate(bad):
            status, raw, _ = _post(dec.url + "/generate_kv", slab)
            assert status == 400, (i, raw)
            assert "first token" in json.loads(raw)["error"] or "prompt" in json.loads(raw)["error"]
        status, raw, _ = _post(dec.url + "/generate_kv", blob)
        assert status == 200 and json.loads(raw)["tokens"] == want
        sz = json.loads(urlopen(dec.url + "/statz").read())
        assert sz["requests"]["completed"] == 1 and dec.scheduler.alive == 1
        fresh = eng._fresh_slot_planes()
        for tok in (-1, vocab, 2 ** 40, 1.0):
            with pytest.raises(InvalidArgumentError):
                eng.admit_prefilled(0, fresh, 2, tok, prompt=[3, 4])
        with pytest.raises(InvalidArgumentError, match="prompt"):
            eng.admit_prefilled(0, fresh, 2, 1, prompt=[3, 4, 5])
        if paged:
            used = eng.paging_stats()["pages_used"]
            with pytest.raises(InvalidArgumentError, match="first token"):
                eng.admit_prefilled_pages(0, [{"id": 0, "hash": None, "planes": None}], 2, vocab)
            assert eng.paging_stats()["pages_used"] == used
    finally:
        pre.stop(drain=False)
        dec.stop(drain=False)


def test_slabs_cross_between_the_jax_and_the_port_servers(models):
    """``/prefill`` of the JAX server posted to the port's ``/generate_kv``,
    and the port's to the JAX one's: both answer the unified greedy
    tokens."""
    jm, pm = models
    want = _engine(pm, slots=1).warmup().generate([[7, 3, 11, 5, 2]], max_new_tokens=6,
                                                  temperature=0.0, stop_at_eos=False)[0]
    jpre = JServer(_jengine(jm, slots=1), kind="prefill", queue_capacity=4).start()
    jdec = JServer(_jengine(jm), kind="decode", queue_capacity=4).start()
    pre = GenerationServer(_engine(pm, slots=1), kind="prefill", queue_capacity=4).start()
    dec = GenerationServer(_engine(pm), kind="decode", queue_capacity=4).start()
    try:
        body = {"prompt": [7, 3, 11, 5, 2], "max_new_tokens": 6, "temperature": 0.0}
        for src, dst in ((jpre, dec), (pre, jdec)):
            slab = _post(src.url + "/prefill", body)[1]
            status, raw, _ = _post(dst.url + "/generate_kv", slab)
            assert status == 200 and json.loads(raw)["tokens"] == want
    finally:
        for s in (jpre, jdec, pre, dec):
            s.stop(drain=False)
