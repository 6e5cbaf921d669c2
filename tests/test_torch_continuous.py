"""Port parity: continuous batching and ``/generate`` (``paddle_tpu_torch.serving``).

The cases of ``tests/test_continuous_batching.py:56-270`` run against the
port's ``ContinuousBatcher`` and ``GenerationServer`` over a tiny GPT whose
weights the JAX package made from a seed (moved as numpy through
``convert.gpt_state_from_numpy``), on the CPU: co-batched outputs equal
solo runs, slots turn over mid-batch, tokens stream a step at a time, the
queue answers 429 when full and refuses after close, malformed requests are
refused at submit, drain finishes queued work, stop without drain fails
it. Then ``/generate``'s answer is held key for key and token for token
against the JAX ``GenerationServer``'s on the same request, plain and
streamed, and ``/statz`` against the JAX one's keys.
"""
import json
import threading
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu.generation import GenerationEngine as JEngine  # noqa: E402
from paddle_tpu.serving import GenerationServer as JServer  # noqa: E402

from paddle_tpu_torch import convert  # noqa: E402
from paddle_tpu_torch import models as pmodels  # noqa: E402
from paddle_tpu_torch.errors import InvalidArgumentError, UnimplementedError  # noqa: E402
from paddle_tpu_torch.generation import GenerationEngine  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    ContinuousBatcher,
    GenerationServer,
    QueueFullError,
    ServingClosedError,
)

torch.set_num_threads(1)

CACHE = 32
BUCKETS = (4, 8)


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


@pytest.fixture
def model(models):
    return models[1]


def _engine(model, slots=2, seed=7, **kw):
    return GenerationEngine(model, slots=slots, cache_len=CACHE, prefill_buckets=BUCKETS,
                            seed=seed, device="cpu", **kw)


def _prompts(n, rng_seed=0):
    rng = np.random.RandomState(rng_seed)
    return [list(rng.randint(3, 200, size=int(rng.randint(1, 9)))) for _ in range(n)]


# -- the scheduler --------------------------------------------------------------------


def test_cobatched_outputs_match_solo_runs(model):
    prompts = _prompts(6)
    budgets = [3, 7, 2, 5, 8, 4]
    solo_eng = _engine(model, slots=1).warmup()
    solo = [solo_eng.generate([p], max_new_tokens=b, temperature=0.0)[0]
            for p, b in zip(prompts, budgets)]
    sched = ContinuousBatcher(_engine(model, slots=3).warmup(), queue_capacity=16).start()
    try:
        reqs = [sched.submit(p, max_new_tokens=b, temperature=0.0)
                for p, b in zip(prompts, budgets)]
        assert [r.wait(timeout=60) for r in reqs] == solo
        assert sched.extra_compiles() == 0
    finally:
        sched.stop(drain=False)


def test_vacated_slot_readmission_midbatch(model):
    sched = ContinuousBatcher(_engine(model, slots=2).warmup(), queue_capacity=32).start()
    try:
        reqs = [sched.submit(p, max_new_tokens=b, temperature=0.0)
                for p, b in zip(_prompts(5, rng_seed=1), [24, 2, 2, 2, 2])]
        outs = [r.wait(timeout=120) for r in reqs]
        assert [len(o) for o in outs] == [24, 2, 2, 2, 2]
        assert sched.stats["midbatch_admissions"] >= 1
        assert sched.live_slots == 0
        assert [r.finish_reason for r in reqs] == ["length"] * 5
    finally:
        sched.stop(drain=False)


def test_streaming_tokens_arrive_per_step(model):
    sched = ContinuousBatcher(_engine(model, slots=1).warmup(), queue_capacity=4).start()
    try:
        seen = []
        out = sched.submit([5, 6, 7], max_new_tokens=5, temperature=0.0,
                           on_token=seen.append).wait(timeout=60)
        assert seen == out and len(out) == 5
    finally:
        sched.stop(drain=False)


def test_queue_full_and_closed_reject(model):
    sched = ContinuousBatcher(_engine(model, slots=1), queue_capacity=2)  # nothing drains it
    sched.submit([1, 2], max_new_tokens=2)
    sched.submit([1, 2], max_new_tokens=2)
    with pytest.raises(QueueFullError):
        sched.submit([1, 2], max_new_tokens=2)
    assert sched.stats["rejected"] == 1
    sched.close(drain=False)
    with pytest.raises(ServingClosedError):
        sched.submit([1, 2], max_new_tokens=2)


def test_invalid_requests_rejected_at_submit(model):
    sched = ContinuousBatcher(_engine(model, slots=1), queue_capacity=4)
    for prompt, budget in (([], 2), ([1] * 9, 2), ([1, 2], 0), ([1, 999], 2)):
        with pytest.raises(InvalidArgumentError):
            sched.submit(prompt, max_new_tokens=budget)
    with pytest.raises(UnimplementedError, match="entry 4"):
        sched.submit_prefilled((), 2, 1)
    with pytest.raises(UnimplementedError, match="entry 4"):
        sched.submit_prefilled_pages(None)
    sched.close(drain=False)


def test_deadline_expires_in_the_queue(model):
    from paddle_tpu_torch.serving import DeadlineExceededError

    sched = ContinuousBatcher(_engine(model, slots=1).warmup(), queue_capacity=4)
    req = sched.submit([1, 2, 3], max_new_tokens=2, deadline_ms=1)
    time.sleep(0.01)
    sched.start()
    with pytest.raises(DeadlineExceededError):
        req.wait(timeout=10)
    assert sched.stats["expired"] == 1
    sched.stop(drain=False)


def test_drain_completes_queued_work(model):
    sched = ContinuousBatcher(_engine(model, slots=2).warmup(), queue_capacity=16).start()
    reqs = [sched.submit(p, max_new_tokens=4, temperature=0.0) for p in _prompts(5, rng_seed=2)]
    sched.stop(drain=True)
    for r in reqs:
        assert len(r.wait(timeout=1)) == 4
    assert sched.live_slots == 0 and sched.alive == 0


def test_stop_without_drain_fails_pending(model):
    sched = ContinuousBatcher(_engine(model, slots=1).warmup(), queue_capacity=16)
    req = sched.submit([1, 2, 3], max_new_tokens=4)
    sched.stop(drain=False)
    with pytest.raises(ServingClosedError):
        req.wait(timeout=1)


def test_drain_stop_with_no_loop_fails_queued_instead_of_stranding(model):
    sched = ContinuousBatcher(_engine(model, slots=1).warmup(), queue_capacity=4)
    req = sched.submit([1, 2, 3], max_new_tokens=4)
    sched.stop(drain=True)
    with pytest.raises(ServingClosedError):
        req.wait(timeout=1)


def test_server_stop_before_start_does_not_hang(model):
    srv = GenerationServer(_engine(model, slots=1), port=0)
    done = []
    t = threading.Thread(target=lambda: done.append(srv.stop(drain=True)))
    t.start()
    t.join(timeout=10)
    assert done, "stop() hung on a never-started server"


# -- HTTP ------------------------------------------------------------------------------


def _post(url, payload, timeout=120):
    body = json.dumps(payload).encode()
    try:
        r = urlopen(Request(url + "/generate", data=body), timeout=timeout)
        return r.status, r.read()
    except HTTPError as e:
        return e.code, e.read()


def _post_json(url, payload):
    status, raw = _post(url, payload)
    return status, json.loads(raw or b"{}")


def test_generate_http_end_to_end(model):
    ref = _engine(model, slots=1).warmup()
    srv = GenerationServer(_engine(model, slots=2), port=0, queue_capacity=16)
    try:
        srv.start(warmup=False)
        with pytest.raises(HTTPError) as ei:
            urlopen(srv.url + "/healthz")
        assert ei.value.code == 503
        assert _post_json(srv.url, {"prompt": [5, 6, 7]})[0] == 503
        srv.warmup()
        hz = json.loads(urlopen(srv.url + "/healthz").read())
        assert hz["ready"] and hz["prefill_buckets"] == list(BUCKETS)
        assert json.loads(urlopen(srv.url + "/").read())["routes"][0] == "/generate (POST)"
        prompt = [5, 6, 7, 8]
        want = ref.generate([prompt], max_new_tokens=6, temperature=0.0)[0]
        status, out = _post_json(srv.url, {"prompt": prompt, "max_new_tokens": 6,
                                           "temperature": 0.0})
        assert status == 200 and out["tokens"] == want
        assert out["finish_reason"] in ("length", "eos") and out["prompt_tokens"] == 4
        for bad in ({}, {"prompt": []}, {"prompt": "abc"}, {"prompt": [1.5]}, [1, 2],
                    {"prompt": [1] * 9}, {"prompt": [1], "max_new_tokens": "x"},
                    {"prompt": [500]}):
            assert _post_json(srv.url, bad)[0] == 400, bad
        sz = json.loads(urlopen(srv.url + "/statz").read())
        assert sz["requests"]["completed"] >= 1
        assert sz["generation"]["tokens_generated"] >= 6
        assert sz["generation"]["tokens_per_sec"] > 0
        assert sz["latency"]["token"]["p99_ms"] >= 0
        assert sz["compiles"]["unexpected"] == 0 and sz["compiles"]["expected"] == 3
        assert sz["compiles"]["prefill_buckets"] == len(BUCKETS)
        with pytest.raises(HTTPError) as ei:
            urlopen(srv.url + "/metrics")
        assert ei.value.code == 404
    finally:
        srv.stop(drain=False)


def test_generate_http_streaming(model):
    srv = GenerationServer(_engine(model, slots=2), port=0, queue_capacity=8)
    try:
        srv.start()
        status, raw = _post(srv.url, {"prompt": [5, 6, 7], "max_new_tokens": 5,
                                      "temperature": 0.0, "stream": True})
        lines = [json.loads(line) for line in raw.decode().splitlines()]
        toks = [line["token"] for line in lines if "token" in line]
        assert status == 200 and lines[-1]["done"] and lines[-1]["tokens"] == toks
        assert len(toks) == 5
        status, out = _post_json(srv.url, {"prompt": [5, 6, 7], "max_new_tokens": 5,
                                           "temperature": 0.0})
        assert status == 200 and out["tokens"] == toks
    finally:
        srv.stop(drain=False)


def test_generate_http_429_and_drain(model):
    srv = GenerationServer(_engine(model, slots=1), port=0, queue_capacity=1)
    try:
        srv.start()
        results = []

        def client(budget):
            results.append(_post_json(srv.url, {"prompt": [3, 4], "max_new_tokens": budget,
                                                 "temperature": 0.0}))

        threads = [threading.Thread(target=client, args=(24,)) for _ in range(3)]
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=120)
        codes = sorted(c for c, _ in results)
        assert codes.count(200) >= 2 and all(c in (200, 429) for c in codes), codes
        srv.stop(drain=True)
        assert srv.scheduler.live_slots == 0 and srv.scheduler.alive == 0
    finally:
        srv.stop(drain=False)


def test_server_kinds_and_engine_kwargs(model):
    for kind in ("prefill", "decode"):
        with pytest.raises(UnimplementedError, match="entry 4"):
            GenerationServer(_engine(model, slots=1), kind=kind)
    with pytest.raises(InvalidArgumentError):
        GenerationServer(_engine(model, slots=1), kind="train")
    with pytest.raises(InvalidArgumentError, match="ready engine"):
        GenerationServer(_engine(model, slots=1), slots=2)
    srv = GenerationServer(model, slots=2, cache_len=CACHE, prefill_buckets=BUCKETS,
                           device="cpu")
    assert srv.engine.slots == 2 and srv.engine.device.type == "cpu"
    srv.stop()


@pytest.mark.parametrize("stream", [False, True])
def test_generate_json_equals_the_jax_server(models, stream):
    """The same request to the JAX server and the port's: the answer key
    for key and token for token (greedy; the top-two gaps of this prompt
    are far above f32 rounding), and ``/statz``'s blocks by name."""
    jm, pm = models
    body = {"prompt": [17, 4, 99, 23, 8], "max_new_tokens": 9, "temperature": 0.0,
            "stream": stream}
    with jax.enable_x64(False):
        jsrv = JServer(JEngine(jm, slots=2, cache_len=CACHE, prefill_buckets=BUCKETS, seed=7),
                       port=0, queue_capacity=8)
        psrv = GenerationServer(_engine(pm, slots=2), port=0, queue_capacity=8)
        try:
            jsrv.start()
            psrv.start()
            (jstatus, jraw), (pstatus, praw) = _post(jsrv.url, body), _post(psrv.url, body)
            assert jstatus == pstatus == 200
            jlines = [json.loads(x) for x in jraw.decode().splitlines()]
            plines = [json.loads(x) for x in praw.decode().splitlines()]
            assert plines == jlines and len(plines) == (10 if stream else 1)
            toks = plines[-1]["tokens"]
            ids = np.asarray([body["prompt"] + toks[:-1]], "int32")
            top2 = np.sort(np.asarray(jm(ids).numpy())[0, len(body["prompt"]) - 1:], -1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
            jz = json.loads(urlopen(jsrv.url + "/statz").read())
            pz = json.loads(urlopen(psrv.url + "/statz").read())
            for block in ("requests", "latency"):
                assert set(pz[block]) == set(jz[block])
            assert set(pz["generation"]) <= set(jz["generation"])
            assert pz["requests"] == jz["requests"]
            assert pz["generation"]["tokens_generated"] == jz["generation"]["tokens_generated"]
            assert (pz["compiles"]["expected"], pz["compiles"]["unexpected"]) == (
                jz["compiles"]["expected"], jz["compiles"]["unexpected"]) == (3, 0)
            jh = json.loads(urlopen(jsrv.url + "/healthz").read())
            ph = json.loads(urlopen(psrv.url + "/healthz").read())
            assert set(ph) == set(jh)
        finally:
            psrv.stop(drain=False)
            jsrv.stop(drain=False)
