#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's ``name, power.limit`` (from ``nvidia-smi``); require CUDA;
2. build every kernel of the serving path from ``paddle_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all at once);
3. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes, and time the kernel, the plain version and one
   PyTorch library call that computes the same function (the yardstick;
   the port never calls it);
4. serve BERT-base (L=512, flash attention on, f32, random weights from a
   seed) through ``Predictor`` -> ``InferenceServer`` and wait for
   ``/healthz``;
5. POST requests of 1-4 rows, some padded, some concurrent; check every
   answer against the port's plain forward of the same weights on the CPU
   and that each forward launched 24 LayerNorm and 12 attention kernels;
   then, as a control, run the same requests with TF32 matmuls on and
   require the limits to catch them;
6. print the card line, then one JSON line with every kernel's numbers;
7. print ``{"ok": true, "device": {...}}`` as the last line.

Exits non-zero with no result when CUDA is absent or the package is not
beside this script.
"""
from __future__ import annotations

import copy
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory and
# FP32 outside the tensor cores, which is what the kernels use.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

LN_ROWS, LN_H = 8 * 512, 768
FLASH_B, FLASH_H, FLASH_D = 8, 12, 64
LN_F32_ATOL = 1e-5
FLASH_ATOL = 5e-5
# Serving limits against the CPU forward, each about the geometric mean of
# two readings on an H100: full f32 on the card (4.4e-6 / 1.6e-6: 12 layers
# of f32 sums in another order) and the same requests with TF32 matmuls
# (2.2e-3 / 9.9e-4), which tf32_control requires the limits to catch.
SEQ_ATOL, POOLED_ATOL = 1e-4, 4e-5
BUCKETS = (1, 2, 4, 8)
SEQ_LEN = 512


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, arg_sets, iters):
    """Mean ms a call over ``iters`` calls timed with CUDA events, cycling
    through ``arg_sets`` (more bytes than the 50 MB L2 holds, so the inputs
    come from device memory as they do on the serving path)."""
    import torch

    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(v):
    """Spacing of bfloat16 values at |v| (8 significant bits)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


def exact_bf16_layernorm(x, r, w, b, eps):
    """The exact LayerNorm (f64) of the same bf16-rounded sum ``x + r``, and
    the bf16 ulp of the largest term of ``(a - mean) * rstd * w + b`` at
    each element: an output near 0 by cancellation keeps the f32 error of
    its terms, many ulps of the output itself and under one of the terms."""
    a = (x + r).double()  # the add rounds to bf16 first, as in the kernel
    mean = a.mean(-1, keepdim=True)
    rstd = ((a - mean).square().mean(-1, keepdim=True) + eps).rsqrt()
    t = (a - mean) * rstd * w.double()
    y = t + b.double()
    return y, bf16_ulp(y.abs().maximum(t.abs()).maximum(b.double().abs()))


def check_layernorm(dtype_name):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import layernorm_residual as lnr

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    w = torch.randn(LN_H, generator=g, device=dev)
    b = torch.randn(LN_H, generator=g, device=dev)
    sets = [(torch.randn(LN_ROWS, LN_H, generator=g, device=dev).to(dtype),
             torch.randn(LN_ROWS, LN_H, generator=g, device=dev).to(dtype), w, b, 1e-5)
            for _ in range(6)]
    x, r = sets[0][0], sets[0][1]
    y, mean, rstd = lnr.layernorm_residual_fwd(x, r, w, b, 1e-5)
    yp, mp, rp = lnr._reference(x, r, w, b, 1e-5)
    err = float((y.float() - yp.float()).abs().max())
    stat_err = max(float((mean - mp).abs().max()), float((rstd - rp).abs().max() / rp.abs().max()))
    ulps = {}
    if dtype == torch.float32:
        ok = err <= LN_F32_ATOL and stat_err <= LN_F32_ATOL
        tol = f"atol {LN_F32_ATOL}"
    else:
        # both round x + res to bf16 alike and differ in the f32 order of the
        # affine sum; the kernel may be at most one output ulp further from
        # the exact answer than the plain version is
        y64, ulp = exact_bf16_layernorm(x, r, w, b, 1e-5)
        ulps = {"kernel_vs_exact_ulps": float(((y.double() - y64).abs() / ulp).max()),
                "plain_vs_exact_ulps": float(((yp.double() - y64).abs() / ulp).max()),
                "kernel_vs_plain_ulps": float(((y.double() - yp.double()).abs() / ulp).max())}
        ok = (ulps["kernel_vs_exact_ulps"] <= ulps["plain_vs_exact_ulps"] + 1.0
              and stat_err <= LN_F32_ATOL)
        tol = ("kernel within plain + 1 bf16 ulp of the exact (f64) answer, ulps of the largest "
               "affine term; " + ", ".join(f"{k} {v:.3f}" for k, v in ulps.items()))
    if not ok:
        raise AssertionError(f"layernorm_residual {dtype_name}: max err {err} stats {stat_err} "
                             f"beyond {tol}")
    in_bytes = x.element_size()
    t_b, by = bound(LN_ROWS * LN_H * (3 * in_bytes) + 8 * LN_ROWS + 8 * LN_H,
                    9 * LN_ROWS * LN_H)
    ms = time_ms(lnr.layernorm_residual_fwd, sets, 200)
    plain_ms = time_ms(lnr._reference, sets, 200)
    lib_ms = time_ms(lambda x, r, w, b, eps: F.layer_norm(x + r, (LN_H,), w.to(x.dtype),
                                                         b.to(x.dtype), eps), sets, 200)
    log(f"layernorm_residual {dtype_name} [{LN_ROWS}, {LN_H}]: max err {err:.3g} ({tol}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
        f"bound {t_b:.4f} ms ({by})")
    return {"name": "layernorm_residual_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/layernorm_residual.cu",
            "replaces": "paddle_tpu/ops/pallas/layernorm_residual.py:188",
            "shape": [LN_ROWS, LN_H], "dtype": dtype_name, "max_abs_err": err,
            "tolerance": tol, **ulps, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": t_b, "bound_by": by, "library_ms": lib_ms}


def check_flash(seq, replaces):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"
    shape = (FLASH_B, FLASH_H, seq, FLASH_D)
    scale = FLASH_D ** -0.5

    def pad_bias():
        # BERT's additive mask: -1e4 on trailing pad keys, one length per row
        lens = torch.randint(seq // 2, seq + 1, (FLASH_B,), generator=g, device=dev)
        keep = torch.arange(seq, device=dev)[None, :] < lens[:, None]
        return ((1.0 - keep.float()) * -1e4)[:, None, None, :]

    sets = [(torch.randn(shape, generator=g, device=dev),
             torch.randn(shape, generator=g, device=dev),
             torch.randn(shape, generator=g, device=dev), pad_bias())
            for _ in range(3)]
    q, k, v, bias = sets[0]
    out, lse = fa.flash_attention_fwd(q, k, v, bias, False, scale)
    ref = fa._plain_attention(q, k, v, bias, False, scale)
    lse_ref = torch.logsumexp(torch.matmul(q, k.transpose(-1, -2)) * scale + bias, dim=-1)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    lse_err = float((lse.reshape(lse_ref.shape) - lse_ref).abs().max())
    if not (err <= FLASH_ATOL and lse_err <= FLASH_ATOL):
        raise AssertionError(f"flash_attention L={seq}: max err {err}, lse err {lse_err} "
                             f"beyond atol {FLASH_ATOL}")
    nbytes = 4 * (4 * q.numel() + FLASH_B * seq + FLASH_B * FLASH_H * seq)
    t_b, by = bound(nbytes, 4 * FLASH_B * FLASH_H * seq * seq * FLASH_D)
    iters = 50 if seq <= 128 else 20
    ms = time_ms(lambda q, k, v, bias: fa.flash_attention_fwd(q, k, v, bias, False, scale),
                 sets, iters)
    plain_ms = time_ms(lambda q, k, v, bias: fa._plain_attention(q, k, v, bias, False, scale),
                       sets, iters)
    lib_ms = time_ms(lambda q, k, v, bias: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias), sets, iters)
    log(f"flash_attention {shape}: max err {err:.3g}, lse err {lse_err:.3g} (atol {FLASH_ATOL}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
        f"bound {t_b:.4f} ms ({by})")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "shape": list(shape), "dtype": "float32",
            "max_abs_err": max(err, lse_err), "tolerance": f"atol {FLASH_ATOL}", "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by,
            "library_ms": lib_ms}


def check_kernels():
    """One entry per kernel of the serving path, at the shape and dtype the
    path gives it (f32 LayerNorm, attention at L=512); the other shapes
    checked (bf16, and L=128 where the TPU took its small variant) ride
    along under ``also_checked``, without launch counts: the serving run
    never launches them."""
    ln = check_layernorm("float32")
    ln["also_checked"] = [check_layernorm("bfloat16")]
    fa = check_flash(SEQ_LEN, "paddle_tpu/ops/pallas/flash_attention.py:548")
    fa["also_checked"] = [check_flash(128, "paddle_tpu/ops/pallas/flash_attention.py:370")]
    return [ln, fa]


def _http(url, body=None, timeout=300):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def make_requests(cfg, rng):
    """Rows of token ids at L=512; even requests end in pad tokens."""
    reqs = []
    for i, rows in enumerate((1, 4, 2, 3, 1, 2)):
        ids = rng.randint(1, cfg.vocab_size, (rows, SEQ_LEN)).astype(np.int64)
        if i % 2 == 0:
            for r in range(rows):
                ids[r, rng.randint(SEQ_LEN // 4, SEQ_LEN):] = cfg.pad_token_id
        types = (np.arange(SEQ_LEN)[None, :] >= SEQ_LEN // 2).astype(np.int64).repeat(rows, 0)
        reqs.append({"input_ids": ids, "token_type_ids": types})
    return reqs


def _kernel_kind(name):
    n = name.lower()
    if "flash_attention_fwd_kernel" in n:
        return "flash_attention_fwd"
    if "layernorm_residual_fwd_kernel" in n:
        return "layernorm_residual_fwd"
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    if "gemm" in n or "cutlass" in n or "xmma" in n:
        return "matmul"
    return "other"


def profile_forward(pred, seq_len):
    """Time of one BERT forward per bucket (inputs already on the card,
    CUDA events around 20 forwards), then where the time goes at the
    smallest and the largest bucket through ``Predictor.run`` (host inputs
    and outputs included) from ``torch.profiler``: kernel time by kind and
    the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(5)
    for bucket in BUCKETS:
        ids = torch.from_numpy(rng.randint(1, 1000, (bucket, seq_len))).cuda()
        types = torch.zeros_like(ids)
        with torch.inference_mode():
            ms = time_ms(pred.module, [(ids, types)] * 3, 20)
        log(f"forward bucket {bucket} ({bucket * seq_len} tokens): {ms:.3f} ms, "
            f"{bucket * seq_len / ms * 1e3:.0f} tokens/s")
    for bucket in (BUCKETS[0], BUCKETS[-1]):
        feed = [rng.randint(1, 1000, (bucket, seq_len)).astype(np.int64),
                np.zeros((bucket, seq_len), np.int64)]
        pred.run(feed)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pred.run(feed)  # ends in a copy to the host, so the device is done
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kind = {}
        for e in prof.key_averages():
            if not str(e.device_type).endswith("CUDA"):
                continue  # host ops: their device time is their kernels', counted below
            t = getattr(e, "device_time_total", None)
            t = (e.cuda_time_total if t is None else t) / 1e3
            kind = _kernel_kind(e.key)
            by_kind[kind] = by_kind.get(kind, 0.0) + t
        busy = sum(by_kind.values())
        log(f"Predictor.run bucket {bucket}: {wall_ms:.3f} ms wall, device busy {busy:.3f} ms "
            f"({busy / wall_ms:.1%}); by kind (ms): "
            + ", ".join(f"{k} {v:.3f} ({v / busy:.1%})" for k, v in
                        sorted(by_kind.items(), key=lambda kv: -kv[1])))


def serve_bert():
    """Phases 4-5. Returns kernel launches per name on the serving run."""
    import torch

    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.jit_api import InputSpec
    from paddle_tpu_torch.models import BertModel, bert_base_config
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import InferenceServer

    cfg = bert_base_config()
    cfg.use_flash_attention = True
    specs = [InputSpec([None, SEQ_LEN], "int64", "input_ids"),
             InputSpec([None, SEQ_LEN], "int64", "token_type_ids")]
    fetches = ["sequence_output", "pooled_output"]
    model = BertModel(cfg, generator=torch.Generator().manual_seed(0))
    cpu_pred = Predictor(copy.deepcopy(model), specs, fetches, device="cpu")
    pred = Predictor(model, specs, fetches)
    srv = InferenceServer(pred, port=0, buckets=BUCKETS, batch_timeout_ms=5.0)
    t0 = time.perf_counter()
    srv.start()
    try:
        status, health = _http(srv.url + "/healthz")
        if status != 200:
            raise AssertionError(f"/healthz answered {status}: {health}")
        log(f"server ready at {srv.url} after {time.perf_counter() - t0:.1f} s "
            f"(warmup over buckets {BUCKETS})")
        reqs = make_requests(cfg, np.random.RandomState(3))
        batches0 = srv.batcher.stats["batches"]
        reset_launch_counts()
        answers = [None] * len(reqs)

        def post(i):
            body = {"inputs": {n: a.tolist() for n, a in reqs[i].items()}}
            t = time.perf_counter()
            answers[i] = _http(srv.url + "/predict", body)
            log(f"request {i} ({reqs[i]['input_ids'].shape[0]} rows): HTTP round trip "
                f"{(time.perf_counter() - t) * 1e3:.1f} ms")

        for i in (0, 1):  # two alone, then the rest at once
            post(i)
        threads = [threading.Thread(target=post, args=(i,)) for i in range(2, len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        counts = launch_counts()
        forwards = srv.batcher.stats["batches"] - batches0
    finally:
        srv.stop(drain=True)
    if srv.pool.alive:
        raise AssertionError("replica workers still alive after drain")
    wants = []
    for i, (req, ans) in enumerate(zip(reqs, answers)):
        if ans is None or ans[0] != 200:
            raise AssertionError(f"request {i} failed: {ans and ans[0]} "
                                 f"{ans and str(ans[1])[:300]}")
        got = [np.asarray(ans[1]["outputs"][n], np.float32) for n in fetches]
        want = cpu_pred.run([req["input_ids"], req["token_type_ids"]])
        wants.append(want)
        for n, g_, w_, tol in zip(fetches, got, want, (SEQ_ATOL, POOLED_ATOL)):
            if g_.shape != w_.shape or not np.isfinite(g_).all():
                raise AssertionError(f"request {i} {n}: shape {g_.shape} vs {w_.shape} "
                                     "or not finite")
            e = float(np.abs(g_ - w_).max())
            if e > tol:
                raise AssertionError(f"request {i} {n}: max err {e} vs CPU > atol {tol}")
            log(f"request {i} ({req['input_ids'].shape[0]} rows) {n}: max err vs CPU {e:.3g} "
                f"(atol {tol})")
    # post-norm BERT: two residual LayerNorms and one attention per layer
    layers = cfg.num_hidden_layers
    want = {"layernorm_residual_fwd": 2 * layers * forwards,
            "flash_attention_fwd": layers * forwards}
    if forwards <= 0 or counts != want:
        raise AssertionError(f"launches {counts} over {forwards} forwards; want {want}")
    log(f"{forwards} forwards, launches {counts}: {2 * layers} LayerNorm + {layers} attention "
        "kernels each")
    tf32_control(pred, reqs, wants)
    profile_forward(pred, SEQ_LEN)
    return counts


def tf32_control(pred, reqs, wants):
    """The same requests through ``Predictor.run`` with TF32 matmuls on (the
    precision the predictor switches off), against the same CPU answers:
    the serving limits must catch that blur."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        errs = [0.0, 0.0]
        for req, want in zip(reqs, wants):
            got = pred.run([req["input_ids"], req["token_type_ids"]])
            errs = [max(e, float(np.abs(g_ - w_).max())) for e, g_, w_ in zip(errs, got, want)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    log(f"TF32 control: max err vs CPU sequence_output {errs[0]:.3g} (atol {SEQ_ATOL}), "
        f"pooled_output {errs[1]:.3g} (atol {POOLED_ATOL})")
    if not (errs[0] > SEQ_ATOL and errs[1] > POOLED_ATOL):
        raise AssertionError(f"TF32 control {errs} passes the serving limits "
                             f"{SEQ_ATOL}, {POOLED_ATOL}: they cannot catch it")


def main() -> int:
    try:
        import torch
    except ImportError:
        log("torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("CUDA is not available: this script runs only on the card")
        return 2
    try:
        from paddle_tpu_torch.device import card_identity
        from paddle_tpu_torch.ops.cuda import _build
    except ImportError as e:
        log(f"paddle_tpu_torch is not beside this script: {e}")
        return 2
    card = card_identity()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {', '.join(_build.KERNEL_SOURCES)} in {time.perf_counter() - t0:.1f} s")

    kernels = check_kernels()
    counts = serve_bert()
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
