"""The port's serving stack on the CPU: ``InferenceServer`` over a
``Predictor(..., device="cpu")`` wrapping a tiny BERT.

Readiness gating, /predict parity with ``Predictor.run``, inert padding
to a bucket, 429 on a full queue, 504 on a deadline missed in the queue,
400/404 on bad requests, and a drain that leaves no live worker.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.flags import flag, set_flags  # noqa: E402
from paddle_tpu_torch.inference import Predictor  # noqa: E402
from paddle_tpu_torch.jit_api import InputSpec  # noqa: E402
from paddle_tpu_torch.models import BertModel, bert_tiny_config  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    DynamicBatcher,
    InferenceServer,
    QueueFullError,
    parse_buckets,
)

torch.set_num_threads(1)

L = 16
FETCHES = ["sequence_output", "pooled_output"]


@pytest.fixture(scope="module")
def predictor():
    cfg = bert_tiny_config()
    cfg.use_flash_attention = True
    model = BertModel(cfg, generator=torch.Generator().manual_seed(0))
    specs = [InputSpec([None, L], "int64", "input_ids"),
             InputSpec([None, L], "int64", "token_type_ids")]
    return Predictor(model, specs, FETCHES, device="cpu")


@pytest.fixture
def server(predictor):
    servers = []

    def make(**kw):
        srv = InferenceServer(predictor, port=0, **kw)
        servers.append(srv)
        return srv

    yield make
    for srv in servers:
        srv.stop(drain=False)


def _feed(rows, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 1024, (rows, L)).astype("int64")
    ids[0, L // 2:] = 0  # trailing pad tokens
    return {"input_ids": ids, "token_type_ids": np.zeros_like(ids)}


def _call(url, body=None, timeout=30):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _body(feed, **extra):
    return {"inputs": {k: v.tolist() for k, v in feed.items()}, **extra}


def test_healthz_gates_on_warmup(server):
    srv = server(buckets=(1, 2)).start(warmup=False)
    assert _call(srv.url + "/healthz")[0] == 503
    assert _call(srv.url + "/predict", _body(_feed(1, 0)))[0] == 503
    srv.warmup()
    status, health = _call(srv.url + "/healthz")
    assert status == 200 and health["ready"] and health["buckets"] == [1, 2]


def test_predict_matches_predictor_run_and_padding_is_inert(server, predictor):
    """3 rows pad to bucket 4: the answer equals an unpadded run, and the
    batch counters show the padding."""
    srv = server(buckets=(1, 4)).start()
    feed = _feed(3, 1)
    status, out = _call(srv.url + "/predict", _body(feed))
    assert status == 200 and out["rows"] == 3
    want = predictor.run([feed["input_ids"], feed["token_type_ids"]])
    for name, w in zip(FETCHES, want):
        np.testing.assert_allclose(np.asarray(out["outputs"][name], np.float32), w,
                                   atol=1e-6, rtol=1e-6)
    stats = _call(srv.url + "/statz")[1]
    assert stats["batches"]["padded_rows"] >= 1
    assert stats["requests"]["completed"] >= 1
    assert set(stats["kernel_launches"]) == {
        "layernorm_residual_fwd", "layernorm_residual_bwd", "flash_attention_fwd",
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "conv_bn_relu_mm_affine_relu",
        "conv_bn_relu_mm_stats", "conv_bn_relu_centered_sumsq", "conv_bn_relu_bn_relu",
        "conv_bn_relu_bn_bwd_partials", "conv_bn_relu_bn_bwd_dco", "momentum_update",
        "int8_matmul", "max_pool2d_backward", "layernorm_residual_fwd_bf16",
        "layernorm_residual_bwd_bf16", "layernorm_residual_fwd_mixed",
        "flash_attention_fwd_bf16", "flash_attention_bwd_dq_bf16",
        "flash_attention_bwd_dkv_bf16", "conv_bn_relu_mm_affine_relu_bf16",
        "conv_bn_relu_mm_stats_bf16", "conv_bn_relu_centered_sumsq_bf16",
        "conv_bn_relu_bn_relu_bf16", "conv_bn_relu_bn_bwd_partials_bf16",
        "conv_bn_relu_bn_bwd_dco_bf16", "max_pool2d_backward_bf16"}


def test_concurrent_requests_share_batches(server, predictor):
    srv = server(buckets=(1, 2, 4, 8), batch_timeout_ms=50.0).start()
    feeds = [_feed(r, 10 + r) for r in (1, 2, 3)]
    answers = [None] * 3

    def post(i):
        answers[i] = _call(srv.url + "/predict", _body(feeds[i]))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    for feed, (status, out) in zip(feeds, answers):
        assert status == 200
        want = predictor.run([feed["input_ids"], feed["token_type_ids"]])
        np.testing.assert_allclose(np.asarray(out["outputs"]["pooled_output"], np.float32),
                                   want[1], atol=1e-6, rtol=1e-6)


def test_full_queue_answers_429_and_deadline_504(server):
    srv = server(buckets=(1,), queue_capacity=1).start()
    srv.pool.pause()
    answers = []
    t = threading.Thread(target=lambda: answers.append(
        _call(srv.url + "/predict", _body(_feed(1, 2), deadline_ms=1))))
    t.start()
    deadline = time.monotonic() + 10
    while srv.batcher.queue_depth() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    status, out = _call(srv.url + "/predict", _body(_feed(1, 3)))
    assert status == 429 and "queue full" in out["error"]
    time.sleep(0.05)  # let the queued request's deadline pass
    srv.pool.resume()
    t.join(30)
    assert answers and answers[0][0] == 504


@pytest.mark.parametrize("body,code", [
    ({"nope": 1}, 400),
    ({"inputs": {"input_ids": [[1, 2]]}}, 400),
    ({"inputs": {"input_ids": [[1] * L], "token_type_ids": [[0] * (L - 1)]}}, 400),
    ({"inputs": {"input_ids": [[1] * L] * 9, "token_type_ids": [[0] * L] * 9}}, 400),
])
def test_bad_requests_answer_400(server, body, code):
    srv = server(buckets=(1, 2, 4, 8)).start()
    assert _call(srv.url + "/predict", body)[0] == code
    assert _call(srv.url + "/nowhere")[0] == 404


def test_drain_flushes_queued_work_and_leaves_no_worker(server):
    srv = server(buckets=(1, 2)).start()
    srv.pool.pause()
    reqs = [srv.batcher.submit(_feed(1, 20 + i)) for i in range(3)]
    srv.stop(drain=True)
    for r in reqs:
        seq, pooled = r.wait(30)
        assert seq.shape == (1, L, 128) and pooled.shape == (1, 128)
    assert srv.pool.alive == 0
    assert srv.batcher.closed


def test_batcher_buckets_and_flags():
    assert parse_buckets("1, 2,8") == (1, 2, 8)
    with pytest.raises(Exception):
        parse_buckets("4,2")
    assert flag("serving_batch_buckets") == "1,2,4,8"
    set_flags({"serving_queue_capacity": 2})
    try:
        b = DynamicBatcher(["x"], buckets=(1,))
        assert b.queue_capacity == 2
        b.submit({"x": np.zeros((1, 3))})
        b.submit({"x": np.zeros((1, 3))})
        with pytest.raises(QueueFullError):
            b.submit({"x": np.zeros((1, 3))})
    finally:
        set_flags({"serving_queue_capacity": 256})
