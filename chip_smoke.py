#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's ``name, power.limit`` (from ``nvidia-smi``); require CUDA;
2. build every kernel of the serving and training paths from
   ``paddle_tpu_torch/csrc`` with ``nvcc`` (one process per source, all at
   once);
3. hold each kernel against its plain PyTorch version on the card at the
   paths' shapes, and time the kernel, the plain version and one PyTorch
   library call that computes the same function (the yardstick; the port
   never calls it); the attention dropout mask of the forward, dQ and
   dK/dV kernels must equal the plain version's bit for bit, and the
   LayerNorm backward must repeat its outputs bit for bit; the attention
   forward is also timed against the port's unfused attention at L = 128
   to 512;
4. serve BERT-base (L=512, flash attention on, f32, random weights from a
   seed) through ``Predictor`` -> ``InferenceServer`` and wait for
   ``/healthz``;
5. POST requests of 1-4 rows, some padded, some concurrent; check every
   answer against the port's plain forward of the same weights on the CPU
   and that each forward launched 24 LayerNorm and 12 attention kernels;
   then, as a control, run the same requests with TF32 matmuls on and
   require the limits to catch them;
6. train BERT-base pretraining (MLM + NSP, AdamW lr 1e-4) through
   ``framework.jit.train_step``: one step at dropout 0, batch 2 x L=512,
   whose loss and every gradient must match the port's plain path on the
   CPU from the same weights (with a TF32 control the limits must catch);
   then steps at the bench's phase-2 shape (batch 32, L=512, 80 masked
   positions, dropout 0.1) on one fixed batch, whose losses must be finite
   and fall, each launching exactly 24 + 24 LayerNorm (forward, backward),
   12 attention forward, 12 dQ and 12 dK/dV kernels; step time, tokens/s
   and, from ``torch.profiler``, where one step's time goes;
7. hold the ResNet path's kernels (fused conv + batch norm + relu, the
   momentum update) against their plain versions at ResNet-50's shapes
   (layer1's 3x3 conv at batch 128; the stem, a ragged shape, the serving
   batch and all 161 parameters besides), timing each with its bound and a
   library call;
8. serve ResNet-50 (224 x 224, eval, f32, random weights from a seed)
   through ``Predictor`` -> ``InferenceServer`` at buckets 1, 8 and 32,
   check every answer against the port's plain forward on the CPU and that
   each forward launched 33 fused eval kernels, with a TF32 control;
9. train ResNet-50 with Momentum through ``framework.jit.train_step``: one
   step at batch 2 against the CPU's plain path (loss, gradients, running
   statistics; TF32 control), then 4 steps at bench.py's shape (batch
   128, lr 0.1, momentum 0.9, one fixed batch) whose losses must be finite
   and fall below the first, each launching exactly 33 of each training
   conv kernel and 2 momentum kernels that update all 161 parameters;
10. hold the int8 matmul kernel against a float64 product of the same int8
    values (bit-equal) at the int8 serving path's shapes and two ragged
    ones, and the max-pool backward kernel against its plain version
    (bit-equal) at ResNet-50's stem, on a relu'd input full of ties and on
    distinct values; time each with its bound and a library call;
11. build the 12-layer 768/3072 feed-forward program (BERT-base's ``mul``s)
    as a static program from a seed, run it in f32, calibrate it, rewrite it
    to int8 and save it; serve the saved directory through
    ``create_predictor(Config(dir))`` -> ``InferenceServer`` at buckets 8, 64
    and 512; check every answer against the port's plain path on the CPU
    from the same directory (with a control, one scale off by 1%, that the
    limit must catch) and against the f32 program within the documented int8
    envelope, and that each forward launched 25 int8 matmul kernels;
12. train ResNet-50 again with ``FLAGS_use_pallas_pool_bwd`` on, the main
    run: the parity step, then 10 steps that also launch the max-pool
    backward kernel once each; step time and images/s beside the flag-off
    run's, peak memory and a profiled step;
13. print the card line, then one JSON line with every kernel's numbers;
14. print ``{"ok": true, "device": {...}}`` as the last line.

Exits non-zero with no result when CUDA is absent or the package is not
beside this script.
"""
from __future__ import annotations

import copy
import itertools
import json
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory, FP32
# outside the tensor cores, TF32 and int8 on them.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # dense TF32 on the tensor cores
INT8_OPS_PER_S = 1979e12  # dense int8 on the tensor cores

LN_ROWS, LN_H = 8 * 512, 768
FLASH_B, FLASH_H, FLASH_D = 8, 12, 64
LN_F32_ATOL = 1e-5
# dw/db sum 16384 rows in another order than the plain version: relative
# to the largest entry
LN_PARAM_RTOL = 1e-5
FLASH_ATOL = 5e-5
# the training path's shapes: bench.py phase 2
TRAIN_B, TRAIN_SEQ, TRAIN_PRED, TRAIN_STEPS = 32, 512, 80, 10
ATTN_DROPOUT = 0.1
TRAIN_ROWS = TRAIN_B * TRAIN_SEQ
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


def device_ms(fn, iters):
    """Mean device ms a call of ``fn()`` over ``iters`` calls with the
    host's launch cost hidden: a sleep kernel holds the card while the host
    enqueues them all, so the CUDA events see only the device's work.
    Returns (device ms, host ms a call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    probe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    probe[0].record()
    torch.cuda._sleep(10 ** 7)
    probe[1].record()
    probe[1].synchronize()
    cycles_per_ms = 10 ** 7 / probe[0].elapsed_time(probe[1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cycles_per_ms * (2.0 * host_ms * iters + 5.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def device_ms_sets(fn, arg_sets, iters):
    """:func:`device_ms` over calls that cycle through ``arg_sets``."""
    it = itertools.cycle(arg_sets)
    return device_ms(lambda: fn(*next(it)), iters)


def bound(bytes_moved, flops, peak=FP32_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
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


def check_layernorm(dtype_name, rows):
    """The forward kernel at [rows, 768] against the plain version: y, and
    the saved f32 mean and rstd the backward reads."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import layernorm_residual as lnr

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    w = torch.randn(LN_H, generator=g, device=dev)
    b = torch.randn(LN_H, generator=g, device=dev)
    sets = [(torch.randn(rows, LN_H, generator=g, device=dev).to(dtype),
             torch.randn(rows, LN_H, generator=g, device=dev).to(dtype), w, b, 1e-5)
            for _ in range(6)]
    x, r = sets[0][0], sets[0][1]
    y, mean, rstd = lnr.layernorm_residual_fwd(x, r, w, b, 1e-5)
    yp, mp, rp = lnr._reference(x, r, w, b, 1e-5)
    err = float((y.float() - yp.float()).abs().max())
    # mean absolute, rstd relative to its largest entry (~1/std of a row)
    stat_err = max(float((mean - mp).abs().max()), float((rstd - rp).abs().max() / rp.abs().max()))
    ulps = {}
    if dtype == torch.float32:
        ok = err <= LN_F32_ATOL and stat_err <= LN_F32_ATOL
        tol = f"y, mean atol {LN_F32_ATOL}, rstd rtol {LN_F32_ATOL}"
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
    t_b, by = bound(rows * LN_H * (3 * in_bytes) + 8 * rows + 8 * LN_H, 9 * rows * LN_H)
    ms = time_ms(lnr.layernorm_residual_fwd, sets, 200)
    plain_ms = time_ms(lnr._reference, sets, 200)
    lib_ms = time_ms(lambda x, r, w, b, eps: F.layer_norm(x + r, (LN_H,), w.to(x.dtype),
                                                         b.to(x.dtype), eps), sets, 200)
    log(f"layernorm_residual {dtype_name} [{rows}, {LN_H}]: max err {err:.3g}, stats "
        f"{stat_err:.3g} ({tol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{lib_ms:.4f} ms, bound {t_b:.4f} ms ({by})")
    return {"name": "layernorm_residual_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/layernorm_residual.cu",
            "replaces": "paddle_tpu/ops/pallas/layernorm_residual.py:188",
            "shape": [rows, LN_H], "dtype": dtype_name, "max_abs_err": err,
            "stats_err": stat_err, "tolerance": tol, **ulps, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by, "library_ms": lib_ms}


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
    flops = 4 * FLASH_B * FLASH_H * seq * seq * FLASH_D
    t_b, by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)  # 3xTF32: three TF32 passes
    t_b32, by32 = bound(nbytes, flops)
    # device time behind a sleep kernel: at L=128 the host's launch cost is
    # longer than the kernel, and CUDA events around back-to-back calls
    # would time the host
    iters = 100 if seq <= 128 else 30
    ms, host_ms = device_ms_sets(lambda q, k, v, bias: fa.flash_attention_fwd(
        q, k, v, bias, False, scale), sets, iters)
    plain_ms, _ = device_ms_sets(lambda q, k, v, bias: fa._plain_attention(
        q, k, v, bias, False, scale), sets, iters)
    lib_ms, _ = device_ms_sets(lambda q, k, v, bias: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias), sets, iters)
    log(f"flash_attention {shape}: max err {err:.3g}, lse err {lse_err:.3g} (atol {FLASH_ATOL}); "
        f"kernel {ms:.4f} ms of device time (host {host_ms:.4f} ms a call), plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound 3xTF32 {t_b:.4f} ms ({by}), FP32 "
        f"{t_b32:.4f} ms ({by32})")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "shape": list(shape), "dtype": "float32",
            "max_abs_err": max(err, lse_err), "tolerance": f"atol {FLASH_ATOL}", "ms": ms,
            "kernel_ms": ms, "timing": "device time behind a sleep kernel",
            "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by,
            "bound_note": "3xTF32: 3 x products / 495 TFLOP/s", "bound_fp32_ms": t_b32,
            "bound_fp32_by": by32, "library_ms": lib_ms}


def check_flash_fwd_shape(batch, seq, lk, d, causal, rate):
    """The forward at [batch, 12, seq, d] with ``lk`` keys, a pad bias,
    causal or not, against the plain version with the same seed: out and
    lse within ``FLASH_ATOL`` (untimed)."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(8)
    shape = (batch, FLASH_H, seq, d)
    q = torch.randn(shape, generator=g, device="cuda")
    k, v = (torch.randn(batch, FLASH_H, lk, d, generator=g, device="cuda") for _ in range(2))
    bias = _pad_bias(g, batch, lk)
    seed = fa._draw_seed(g, "cuda") if rate else None
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, bias, causal, scale, rate, seed)
    pout, plse = fa._plain_fwd(q, k, v, bias, causal, scale, rate, seed)
    torch.cuda.synchronize()
    err = float((out - pout).abs().max())
    lse_err = float((lse - plse).abs().max())
    label = (f"flash_attention_fwd {list(shape)} Lk {lk}{' causal' if causal else ''} rate "
             f"{rate}")
    log(f"{label}: out err {err:.3g}, lse err {lse_err:.3g} (atol {FLASH_ATOL})")
    if not (err <= FLASH_ATOL and lse_err <= FLASH_ATOL):
        raise AssertionError(f"{label}: out err {err}, lse err {lse_err} beyond atol {FLASH_ATOL}")
    return {"shape": list(shape), "keys": lk, "causal": causal, "dropout_rate": rate,
            "max_abs_err": err, "lse_err": lse_err, "tolerance": f"atol {FLASH_ATOL}"}


def check_attention_crossover(seqs=(128, 256, 384, 512)):
    """The flash kernel against the port's unfused attention (the branch
    ``MultiHeadAttention`` takes below ``FLASH_ATTENTION_MIN_SEQ``: two
    matmuls, the mask added, the port's softmax) at [8, 12, L, 64] with a pad
    bias: the forward alone (serving), and forward plus backward at rate 0
    (training). Device time behind a sleep kernel, no limits: the numbers
    for the dispatch threshold."""
    import torch

    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    def unfused(q, k, v, bias, scale):
        scores = torch.matmul(q, k.transpose(-1, -2)) * scale + bias
        return torch.matmul(PF.softmax(scores, axis=-1), v)

    g = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for seq in seqs:
        shape = (FLASH_B, FLASH_H, seq, FLASH_D)
        scale = FLASH_D ** -0.5
        sets = [(*(torch.randn(shape, generator=g, device="cuda") for _ in range(4)),
                 _pad_bias(g, FLASH_B, seq)) for _ in range(3)]
        iters = 50 if seq <= 256 else 20
        fwd = {"flash": device_ms_sets(lambda q, k, v, do, bias: fa.flash_attention_fwd(
                   q, k, v, bias, False, scale), sets, iters)[0],
               "unfused": device_ms_sets(lambda q, k, v, do, bias: unfused(q, k, v, bias, scale),
                                         sets, iters)[0]}

        def train(fn):
            def step(q, k, v, do, bias):
                ins = [t.detach().requires_grad_() for t in (q, k, v)]
                torch.autograd.grad(fn(*ins, bias), ins, do)
            return device_ms_sets(step, sets, iters)[0]

        both = {"flash": train(lambda q, k, v, bias: fa.flash_attention(q, k, v, bias,
                                                                         scale=scale)),
                "unfused": train(lambda q, k, v, bias: unfused(q, k, v, bias, scale))}
        log(f"attention at {list(shape)}, pad bias: forward flash {fwd['flash']:.4f} ms, unfused "
            f"{fwd['unfused']:.4f} ms; forward + backward flash {both['flash']:.4f} ms, unfused "
            f"{both['unfused']:.4f} ms")
        rows.append({"shape": list(shape), "forward_ms": fwd, "forward_backward_ms": both})
    return rows


def check_layernorm_bwd(dtype_name, rows=TRAIN_ROWS, h=LN_H, timed=True):
    """The backward kernel at [rows, h] (the training path's [16384, 768] by
    default) against the plain version on the same inputs and saved
    statistics (the forward's statistics at 768 are checked by
    ``check_layernorm``), and against itself: a second run must give the
    same ``da`` and dw/db partials bit for bit."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import layernorm_residual as lnr

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(3)
    dev, eps = "cuda", 1e-5
    w = torch.randn(h, generator=g, device=dev)
    b = torch.randn(h, generator=g, device=dev)
    sets = []
    for _ in range(3 if timed else 1):
        x, r, dy = (torch.randn(rows, h, generator=g, device=dev).to(dtype) for _ in range(3))
        _, mean, rstd = lnr.layernorm_residual_fwd(x, r, w, b, eps)
        sets.append((x, r, w, mean, rstd, dy))
    x, r, _, mean, rstd, dy = sets[0]
    variant = lnr._bwd_plan(rows, h, dtype, lnr._sm_count(x.device.index))[0]
    da, dwp, dbp = lnr.layernorm_residual_bwd(*sets[0])
    again = lnr.layernorm_residual_bwd(*sets[0])
    repeats = all(torch.equal(a_, b_) for a_, b_ in zip((da, dwp, dbp), again))
    pa, pw, pb = lnr._reference_bwd(*sets[0])
    dw_err = float((dwp.sum(0) - pw.sum(0)).abs().max() / pw.abs().max())
    db_err = float((dbp.sum(0) - pb.sum(0)).abs().max() / pb.abs().max())
    err = float((da.float() - pa.float()).abs().max())
    if dtype == torch.float32:
        ok = err <= LN_F32_ATOL
        tol = f"da atol {LN_F32_ATOL}"
    else:
        # both compute in f32 and round da once; near-zero outputs by
        # cancellation carry the f32 error of their terms, so the ulp is the
        # largest term's (rstd * w * dy)
        term = (rstd[:, None] * w * dy.float()).abs().maximum(pa.float().abs())
        ulps = float(((da.float() - pa.float()).abs() / bf16_ulp(term)).max())
        ok = ulps <= 1.0
        tol = f"da within 1 bf16 ulp of the largest term (read {ulps:.3f})"
    ok = ok and dw_err <= LN_PARAM_RTOL and db_err <= LN_PARAM_RTOL
    tol += f"; dw, db rtol {LN_PARAM_RTOL} of the largest entry"
    label = f"layernorm_residual_bwd {dtype_name} [{rows}, {h}] ({variant} variant)"
    if not ok:
        raise AssertionError(f"{label}: da err {err}, dw {dw_err}, db {db_err} beyond {tol}")
    if not repeats:
        raise AssertionError(f"{label}: a second run differs (da or the dw/db partials)")
    entry = {"name": "layernorm_residual_bwd", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/layernorm_residual_bwd.cu",
             "replaces": "paddle_tpu/ops/pallas/layernorm_residual.py:219",
             "shape": [rows, h], "dtype": dtype_name, "variant": variant, "max_abs_err": err,
             "dw_rel_err": dw_err, "db_rel_err": db_err, "tolerance": tol,
             "repeats_bit_for_bit": repeats}
    if not timed:
        log(f"{label}: da err {err:.3g}, dw {dw_err:.3g}, db {db_err:.3g} ({tol}); a second run "
            "equal bit for bit")
        return entry
    in_bytes = x.element_size()
    # x, res, dy read and da written; mean, rstd, w read; dw, db written (the
    # function's outputs: the kernel's per-block partials are its own choice)
    t_b, by = bound(rows * h * 4 * in_bytes + 8 * rows + 4 * h + 8 * h, 12 * rows * h)
    ms = time_ms(lnr.layernorm_residual_bwd, sets, 100)

    def whole(*args):  # what the autograd Function runs: the kernel, then the two sums
        _, dwp_, dbp_ = lnr.layernorm_residual_bwd(*args)
        return dwp_.sum(0), dbp_.sum(0)

    whole_ms = time_ms(whole, sets, 100)
    plain_ms = time_ms(lnr._reference_bwd, sets, 100)
    graphs = []
    for x_, r_, w_, _, _, dy_ in sets:
        ins = [t.detach().requires_grad_() for t in (x_, r_, w_, b)]
        y = F.layer_norm(ins[0] + ins[1], (h,), ins[2].to(dtype), ins[3].to(dtype), eps)
        graphs.append((y, ins, dy_))
    lib_ms = time_ms(lambda y, ins, dy_: torch.autograd.grad(y, ins, dy_, retain_graph=True),
                     graphs, 100)
    log(f"{label}: da err {err:.3g}, dw {dw_err:.3g}, db {db_err:.3g} ({tol}); a second run "
        f"equal bit for bit; kernel {ms:.4f} ms (with the two partial sums {whole_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {t_b:.4f} ms ({by})")
    entry.update(ms=ms, kernel_ms=ms, whole_backward_ms=whole_ms, plain_ms=plain_ms,
                 bound_ms=t_b, bound_by=by, library_ms=lib_ms)
    return entry


def _pad_bias(g, batch, seq):
    """BERT's additive mask: -1e4 on trailing pad keys, one length per row."""
    import torch

    lens = torch.randint(seq // 2, seq + 1, (batch,), generator=g, device="cuda")
    keep = torch.arange(seq, device="cuda")[None, :] < lens[:, None]
    return ((1.0 - keep.float()) * -1e4)[:, None, None, :]


def check_flash_bwd(batch, seq, rate, causal, replaces, lk=None, d=FLASH_D, timed=True):
    """The dQ and dK/dV kernels at [batch, 12, seq, d] (keys ``lk``, default
    ``seq``) with a pad bias against autograd through the plain version
    with the same dropout seed. Returns the two kernels' entries. Timed:
    each kernel, the whole backward, the plain version and SDPA's backward
    (rate 0, the same mask), beside two bounds: the products on the FP32
    units, and in 3xTF32 on the tensor cores (three TF32 passes), which the
    kernels use and which is the smaller."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    lk = seq if lk is None else lk
    g = torch.Generator(device="cuda").manual_seed(4)
    shape = (batch, FLASH_H, seq, d)
    kshape = (batch, FLASH_H, lk, d)
    scale = d ** -0.5

    def make():
        q, do = (torch.randn(shape, generator=g, device="cuda") for _ in range(2))
        k, v = (torch.randn(kshape, generator=g, device="cuda") for _ in range(2))
        bias = _pad_bias(g, batch, lk)
        seed = fa._draw_seed(g, "cuda") if rate else None
        out, lse = fa.flash_attention_fwd(q, k, v, bias, causal, scale, rate, seed)
        delta = (do * out).sum(-1).reshape(-1, seq)
        return q, k, v, bias, lse, delta, do, causal, scale, rate, seed, out

    sets = [make() for _ in range(3 if timed else 1)]
    args = sets[0][:-1]
    q, k, v, bias, lse, delta, do = args[:7]
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    pq, pk, pv = fa._plain_bwd(q, k, v, bias, sets[0][-1], lse, do, causal, scale, rate,
                               args[-1])
    torch.cuda.synchronize()
    errs = [float((a - b_).abs().max()) for a, b_ in zip((dq, dk, dv), (pq, pk, pv))]
    label = (f"flash backward {list(shape)}{f' Lk {lk}' if lk != seq else ''} rate {rate}"
             f"{' causal' if causal else ''}")
    if max(errs) > FLASH_ATOL:
        raise AssertionError(f"{label}: dq/dk/dv err {errs} beyond atol {FLASH_ATOL}")
    # query-key pairs the function needs: all, or the causal triangle
    # (bottom-right aligned: query i sees keys up to i + lk - seq)
    pairs = sum(max(0, min(lk, i + lk - seq + 1)) for i in range(seq)) if causal else seq * lk
    bhld = batch * FLASH_H * pairs * d
    stats = 8 * batch * FLASH_H * seq + 4 * batch * lk  # lse, delta, the [B,1,1,Lk] bias
    qb, kb = 4 * q.numel(), 4 * k.numel()
    dq_io, dkv_io = 3 * qb + 2 * kb + stats, 2 * qb + 4 * kb + stats  # inputs read, grads written
    all_io = 3 * qb + 4 * kb + stats
    bounds = {}
    for name, nbytes, flops in (("dq", dq_io, 6 * bhld), ("dkv", dkv_io, 8 * bhld),
                                ("all", all_io, 10 * bhld)):
        bounds[name] = {"fp32": bound(nbytes, flops),
                        "3xtf32": bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)}
    common = {"route": "cuda", "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
              "shape": list(shape), "keys": lk, "dtype": "float32", "dropout_rate": rate,
              "causal": causal, "tolerance": f"atol {FLASH_ATOL}"}
    entries = []
    for name, err, rep in (("flash_attention_bwd_dq", errs[0], replaces[0]),
                           ("flash_attention_bwd_dkv", max(errs[1:]), replaces[1])):
        key = "dq" if name.endswith("dq") else "dkv"
        (b3, by3), (b32, by32) = bounds[key]["3xtf32"], bounds[key]["fp32"]
        entries.append({"name": name, "replaces": rep, "max_abs_err": err, "bound_ms": b3,
                        "bound_by": by3, "bound_note": "3xTF32: 3 x products / 495 TFLOP/s",
                        "bound_fp32_ms": b32, "bound_fp32_by": by32, **common})
    if not timed:
        log(f"{label}: err dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} (atol "
            f"{FLASH_ATOL})")
        return tuple(entries)
    unpack = lambda *a: a[:-1]  # noqa: E731
    ms_dq = time_ms(lambda *a: fa.flash_attention_bwd_dq(*unpack(*a)), sets, 10)
    ms_dkv = time_ms(lambda *a: fa.flash_attention_bwd_dkv(*unpack(*a)), sets, 10)
    whole_ms = time_ms(lambda q, k, v, bias, lse, delta, do, c, sc, r, seed, out:
                       fa.flash_attention_bwd(q, k, v, bias, out, lse, do, c, sc, r, seed),
                       sets, 10)
    plain_ms = time_ms(lambda q, k, v, bias, lse, delta, do, c, sc, r, seed, out:
                       fa._plain_bwd(q, k, v, bias, out, lse, do, c, sc, r, seed), sets, 5)
    graphs = []
    for q_, k_, v_, bias_, *_rest in sets:
        ins = [t.detach().requires_grad_() for t in (q_, k_, v_)]
        mask = bias_
        if causal:
            mask = bias_ + torch.full((seq, lk), -1e30, device="cuda").triu(lk - seq + 1)
        o = F.scaled_dot_product_attention(*ins, attn_mask=mask)
        graphs.append((o, ins, _rest[2]))
    lib_ms = time_ms(lambda o, ins, do_: torch.autograd.grad(o, ins, do_, retain_graph=True),
                     graphs, 10)
    (t_all, _), (t_all32, _) = bounds["all"]["3xtf32"], bounds["all"]["fp32"]
    log(f"{label}: err dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} (atol {FLASH_ATOL}); "
        f"dQ {ms_dq:.4f} ms (bound 3xTF32 {entries[0]['bound_ms']:.4f}, FP32 "
        f"{entries[0]['bound_fp32_ms']:.4f}), dK/dV {ms_dkv:.4f} ms (bound 3xTF32 "
        f"{entries[1]['bound_ms']:.4f}, FP32 {entries[1]['bound_fp32_ms']:.4f}), whole backward "
        f"{whole_ms:.4f} ms (bound 3xTF32 {t_all:.4f}, FP32 {t_all32:.4f}), plain "
        f"{plain_ms:.4f} ms, library (SDPA backward, no dropout) {lib_ms:.4f} ms")
    total = {"ms": whole_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
             "library": "scaled_dot_product_attention backward, no dropout",
             "bound_ms": t_all, "bound_fp32_ms": t_all32}
    for e, ms in zip(entries, (ms_dq, ms_dkv)):
        e.update(ms=ms, kernel_ms=ms, plain_ms=plain_ms, library_ms=None, backward_total=total)
    return tuple(entries)


def check_dropout_masks():
    """The mask each kernel applies, read back through its outputs, equals
    the plain version's bit for bit at [32, 12, 512, 512]. With q = k = 0
    every probability is 1/L, so one-hot operands expose the mask 64 keys
    (or query rows) at a time: the forward's out > 0, the dK/dV kernel's
    dV > 0 and the dQ kernel's dQ > 0 exactly where an entry is kept."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    b, h, seq, d, rate = TRAIN_B, FLASH_H, TRAIN_SEQ, FLASH_D, ATTN_DROPOUT
    g = torch.Generator(device="cuda").manual_seed(6)
    seed = fa._draw_seed(g, "cuda")
    want = fa.dropout_keep_mask(seed, b, h, seq, seq, rate)
    scale = d ** -0.5
    zero = torch.zeros(b, h, seq, d, device="cuda")
    e0 = torch.zeros_like(zero)
    e0[..., 0] = 1.0
    wrong = {"forward": 0, "dq": 0, "dkv": 0}
    for c in range(seq // d):
        cols = slice(c * d, (c + 1) * d)
        onehot = torch.zeros_like(zero)
        onehot[:, :, cols, :] = torch.eye(d, device="cuda")
        block = want[..., cols]  # [b, h, seq rows, d keys]
        out, lse = fa.flash_attention_fwd(zero, zero, onehot, None, False, scale, rate, seed)
        wrong["forward"] += int(((out > 0) != block).sum())
        out0, lse0 = fa.flash_attention_fwd(zero, zero, zero, None, False, scale, rate, seed)
        delta0 = torch.zeros(b * h, seq, device="cuda")
        _, dv = fa.flash_attention_bwd_dkv(zero, zero, zero, None, lse0, delta0, onehot, False,
                                           scale, rate, seed)
        wrong["dkv"] += int(((dv > 0) != want[:, :, cols, :].transpose(-1, -2)).sum())
        out1, lse1 = fa.flash_attention_fwd(zero, onehot, e0, None, False, scale, rate, seed)
        delta1 = (e0 * out1).sum(-1).reshape(-1, seq)
        dq = fa.flash_attention_bwd_dq(zero, onehot, e0, None, lse1, delta1, e0, False, scale,
                                       rate, seed)
        wrong["dq"] += int(((dq > 0) != block).sum())
    kept = float(want.float().mean())
    log(f"dropout mask [{b}, {h}, {seq}, {seq}] rate {rate}: entries differing from the plain "
        f"version's {wrong} (kept fraction {kept:.5f})")
    if any(wrong.values()):
        raise AssertionError(f"dropout masks differ from the plain version's: {wrong}")
    return {"shape": [b, h, seq, seq], "rate": rate, "kept_fraction": kept,
            "entries_differing": wrong}


def check_flash_dropout_fwd():
    """The forward with in-kernel dropout at the training path's shape
    against the plain version with the same seed."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (TRAIN_B, FLASH_H, TRAIN_SEQ, FLASH_D)
    scale = FLASH_D ** -0.5
    sets = [(*(torch.randn(shape, generator=g, device="cuda") for _ in range(3)),
             _pad_bias(g, TRAIN_B, TRAIN_SEQ), fa._draw_seed(g, "cuda")) for _ in range(3)]
    q, k, v, bias, seed = sets[0]
    out, lse = fa.flash_attention_fwd(q, k, v, bias, False, scale, ATTN_DROPOUT, seed)
    pout, plse = fa._plain_fwd(q, k, v, bias, False, scale, ATTN_DROPOUT, seed)
    err = max(float((out - pout).abs().max()), float((lse - plse).abs().max()))
    if err > FLASH_ATOL:
        raise AssertionError(f"flash forward with dropout: err {err} beyond atol {FLASH_ATOL}")
    nbytes = 4 * (4 * q.numel() + TRAIN_B * TRAIN_SEQ + TRAIN_B * FLASH_H * TRAIN_SEQ)
    flops = 4 * TRAIN_B * FLASH_H * TRAIN_SEQ * TRAIN_SEQ * FLASH_D
    t_b, by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    t_b32, _ = bound(nbytes, flops)
    run = lambda q, k, v, bias, seed: fa.flash_attention_fwd(  # noqa: E731
        q, k, v, bias, False, scale, ATTN_DROPOUT, seed)
    ms = time_ms(run, sets, 10)
    ms_nodrop = time_ms(lambda q, k, v, bias, seed: fa.flash_attention_fwd(
        q, k, v, bias, False, scale), sets, 10)
    plain_ms = time_ms(lambda q, k, v, bias, seed: fa._plain_fwd(
        q, k, v, bias, False, scale, ATTN_DROPOUT, seed), sets, 5)
    # the yardstick draws its mask from torch's own generator: the same kind
    # of work, not the same mask
    lib_ms = time_ms(lambda q, k, v, bias, seed: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias, dropout_p=ATTN_DROPOUT), sets, 10)
    log(f"flash_attention_fwd {list(shape)} dropout {ATTN_DROPOUT}: err {err:.3g} (atol "
        f"{FLASH_ATOL}); kernel {ms:.4f} ms ({ms_nodrop:.4f} ms without dropout), plain "
        f"{plain_ms:.4f} ms, library (SDPA, dropout_p {ATTN_DROPOUT}, its own mask) "
        f"{lib_ms:.4f} ms, bound 3xTF32 {t_b:.4f} ms ({by}), FP32 {t_b32:.4f} ms")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:548", "shape": list(shape),
            "dtype": "float32", "dropout_rate": ATTN_DROPOUT, "max_abs_err": err,
            "tolerance": f"atol {FLASH_ATOL}", "ms": ms, "kernel_ms": ms,
            "kernel_ms_without_dropout": ms_nodrop, "plain_ms": plain_ms, "bound_ms": t_b,
            "bound_by": by, "bound_fp32_ms": t_b32, "library_ms": lib_ms,
            "library": f"scaled_dot_product_attention, dropout_p {ATTN_DROPOUT}, its own mask"}


def check_kernels():
    """One entry per kernel of the serving and training paths. The
    LayerNorm kernels and the attention backward stand at the shape and
    dtype the training path gives them (f32, batch 32 x L=512), the
    attention forward at the serving shape, as before. The other shapes and
    options checked ride along under ``also_checked``, without launch
    counts: the LayerNorm forward at the serving shape and in bf16; its
    backward in bf16 (timed), at a ragged [12345, 1024] in f32 and bf16 and
    at [37, 4100], a width the row variant does not take (untimed); the
    attention forward at the training shape with dropout and at L=128
    (where the TPU took its small variant), the dropout masks, at D = 32
    and 128 and at ragged causal shapes with Lq != Lk (untimed), and
    against the unfused attention at L = 128-512 (timed); the attention
    backward at rate 0 and causal at L=128 (timed), at D = 32 and 128 and at
    ragged causal shapes with Lq != Lk (untimed)."""
    ln = check_layernorm("float32", TRAIN_ROWS)
    ln["also_checked"] = [check_layernorm("float32", LN_ROWS),
                          check_layernorm("bfloat16", LN_ROWS)]
    ln_bwd = check_layernorm_bwd("float32")
    ln_bwd["also_checked"] = [check_layernorm_bwd("bfloat16"),
                              check_layernorm_bwd("float32", 12345, 1024, timed=False),
                              check_layernorm_bwd("bfloat16", 12345, 1024, timed=False),
                              check_layernorm_bwd("float32", 37, 4100, timed=False)]
    fa = check_flash(SEQ_LEN, "paddle_tpu/ops/pallas/flash_attention.py:548")
    fa["also_checked"] = [check_flash(128, "paddle_tpu/ops/pallas/flash_attention.py:370"),
                          check_flash_dropout_fwd(), {"dropout_masks": check_dropout_masks()},
                          check_flash_fwd_shape(4, 256, 256, 32, True, ATTN_DROPOUT),
                          check_flash_fwd_shape(4, 256, 256, 128, True, ATTN_DROPOUT),
                          check_flash_fwd_shape(2, 300, 257, 64, True, 0.0),
                          check_flash_fwd_shape(2, 257, 300, 32, True, ATTN_DROPOUT),
                          {"crossover_vs_unfused": check_attention_crossover()}]
    tiled = ("paddle_tpu/ops/pallas/flash_attention.py:765",
             "paddle_tpu/ops/pallas/flash_attention.py:815")
    small = ("paddle_tpu/ops/pallas/flash_attention.py:433",) * 2
    dq, dkv = check_flash_bwd(TRAIN_B, TRAIN_SEQ, ATTN_DROPOUT, False, tiled)
    for extra in (check_flash_bwd(TRAIN_B, TRAIN_SEQ, 0.0, False, tiled),
                  check_flash_bwd(FLASH_B, 128, ATTN_DROPOUT, True, small),
                  check_flash_bwd(4, 256, ATTN_DROPOUT, False, tiled, d=32, timed=False),
                  check_flash_bwd(4, 256, ATTN_DROPOUT, True, tiled, d=128, timed=False),
                  check_flash_bwd(2, 300, ATTN_DROPOUT, True, tiled, lk=257, timed=False),
                  check_flash_bwd(2, 257, 0.0, True, tiled, lk=300, d=32, timed=False)):
        dq.setdefault("also_checked", []).append(extra[0])
        dkv.setdefault("also_checked", []).append(extra[1])
    return [ln, ln_bwd, fa, dq, dkv]


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


_KERNEL_KINDS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "layernorm_residual_fwd", "layernorm_residual_bwd", "conv_mm", "bn_reduce",
                 "bn_elementwise", "momentum", "int8_mm", "max_pool_bwd")


def _kernel_kind(name):
    n = name.lower().replace("_row_kernel", "_kernel")  # the LayerNorm backward's row variant
    for kind in _KERNEL_KINDS:
        if f"{kind}_kernel" in n:
            return kind
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    if "im2col" in n or "col2im" in n:
        return "im2col/col2im"
    if "conv" in n or "cudnn" in n or "implicit" in n or "wgrad" in n or "dgrad" in n:
        return "cudnn conv"
    if "gemm" in n or "cutlass" in n or "xmma" in n:
        return "matmul"
    return "other"


def _top_kernels(prof, k=10):
    """The ``k`` device kernels that took the most time: (name, ms, calls)."""
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            t = getattr(e, "device_time_total", None)
            rows.append((e.key[:70], (e.cuda_time_total if t is None else t) / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])[:k]


def _device_time_by_kind(prof):
    """Kernel time (ms) by kind from a ``torch.profiler`` run, and the
    number of device events (kernels, copies, sets) behind it."""
    by_kind, events = {}, 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue  # host ops: their device time is their kernels', counted below
        t = getattr(e, "device_time_total", None)
        t = (e.cuda_time_total if t is None else t) / 1e3
        kind = _kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + t
        events += e.count
    return by_kind, events


def _serve(pred, buckets, reqs, label):
    """Serve ``pred`` behind ``InferenceServer`` on ``buckets``, wait for
    ``/healthz``, POST ``reqs`` (feeds by input name): the first two alone,
    the rest at once. Returns (answers, kernel launches over the requests,
    forwards run for them); the server is drained and stopped."""
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import InferenceServer

    srv = InferenceServer(pred, port=0, buckets=buckets, batch_timeout_ms=5.0)
    t0 = time.perf_counter()
    srv.start()
    answers = [None] * len(reqs)
    try:
        status, health = _http(srv.url + "/healthz")
        if status != 200:
            raise AssertionError(f"/healthz answered {status}: {health}")
        log(f"{label} server ready at {srv.url} after {time.perf_counter() - t0:.1f} s "
            f"(warmup over buckets {buckets})")
        batches0 = srv.batcher.stats["batches"]
        reset_launch_counts()

        def post(i):
            body = {"inputs": {n: a.tolist() for n, a in reqs[i].items()}}
            t = time.perf_counter()
            answers[i] = _http(srv.url + "/predict", body)
            log(f"{label} request {i} ({len(next(iter(reqs[i].values())))} rows): HTTP round "
                f"trip {(time.perf_counter() - t) * 1e3:.1f} ms")

        for i in (0, 1):
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
        raise AssertionError(f"{label}: replica workers still alive after drain")
    for i, ans in enumerate(answers):
        if ans is None or ans[0] != 200:
            raise AssertionError(f"{label} request {i} failed: {ans and ans[0]} "
                                 f"{ans and str(ans[1])[:300]}")
    return answers, counts, forwards


def _profile_run(pred, feed, label):
    """One ``Predictor.run`` under ``torch.profiler`` (host inputs and
    outputs included): wall time, the device's busy share, kernel time by
    kind and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pred.run(feed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.run(feed)  # ends in a copy to the host, so the device is done
        wall_ms = (time.perf_counter() - t0) * 1e3
    _log_profile(prof, wall_ms, label)


def _log_profile(prof, wall_ms, label, top=6):
    by_kind, events = _device_time_by_kind(prof)
    busy = sum(by_kind.values())
    log(f"{label}: {wall_ms:.3f} ms wall, device busy {busy:.3f} ms ({busy / wall_ms:.1%}) in "
        f"{events} device events; by kind (ms): "
        + ", ".join(f"{k} {v:.3f} ({v / busy:.1%})" for k, v in
                    sorted(by_kind.items(), key=lambda kv: -kv[1])))
    log(f"{label}, top kernels (name, ms, calls): "
        + "; ".join(f"{n} {t:.3f} {c}" for n, t, c in _top_kernels(prof, top)))


def profile_forward(pred, seq_len):
    """Time of one BERT forward per bucket (inputs already on the card,
    CUDA events around 20 forwards), then where the time goes at the
    smallest and the largest bucket through ``Predictor.run``."""
    import torch

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
        _profile_run(pred, feed, f"Predictor.run bucket {bucket}")


def serve_bert():
    """Phases 4-5. Returns kernel launches per name on the serving run."""
    import torch

    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.jit_api import InputSpec
    from paddle_tpu_torch.models import BertModel, bert_base_config

    cfg = bert_base_config()
    cfg.use_flash_attention = True
    specs = [InputSpec([None, SEQ_LEN], "int64", "input_ids"),
             InputSpec([None, SEQ_LEN], "int64", "token_type_ids")]
    fetches = ["sequence_output", "pooled_output"]
    model = BertModel(cfg, generator=torch.Generator().manual_seed(0))
    cpu_pred = Predictor(copy.deepcopy(model), specs, fetches, device="cpu")
    pred = Predictor(model, specs, fetches)
    reqs = make_requests(cfg, np.random.RandomState(3))
    answers, counts, forwards = _serve(pred, BUCKETS, reqs, "BERT-base")
    wants = []
    for i, (req, ans) in enumerate(zip(reqs, answers)):
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
    want = {name: want.get(name, 0) for name in counts}
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


# Training limits against the port's plain path on the CPU (dropout 0,
# batch 2 x L=512): the loss, and for every parameter the largest gradient
# error relative to the largest gradient entry of its layer. Each sits
# about at the geometric mean of two readings on an H100: full f32 (loss
# equal to the last bit, < 1e-6; gradients 4.0e-6) and the same step with
# TF32 matmuls (1.24e-4; 2.96e-3), which train_parity requires them to catch.
TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4


def pretraining_batch(cfg, batch, seq, n_pred, rng):
    """bench.py's synthetic phase-2 batch: token ids, segment ids, flat
    masked positions (n_pred a row), MLM labels and NSP labels."""
    ids = rng.randint(1, cfg.vocab_size, (batch, seq)).astype(np.int64)
    types = rng.randint(0, 2, (batch, seq)).astype(np.int64)
    pos = np.stack([rng.choice(seq, n_pred, replace=False) + i * seq
                    for i in range(batch)]).ravel().astype(np.int64)
    mlm = rng.randint(0, cfg.vocab_size, (batch * n_pred,)).astype(np.int64)
    nsp = rng.randint(0, 2, (batch, 1)).astype(np.int64)
    return [ids, types, pos, mlm, nsp]


def _pretraining(cfg, seed):
    import torch

    from paddle_tpu_torch.models import BertForPretraining, BertPretrainingCriterion

    model = BertForPretraining(cfg, generator=torch.Generator().manual_seed(seed))
    crit = BertPretrainingCriterion(cfg.vocab_size)

    def loss_fn(m, ids, types, pos, mlm, nsp):
        pred, rel = m(ids, types, masked_positions=pos)
        return crit(pred, rel, mlm, nsp)

    return model, loss_fn


def _step_of(model, loss_fn, device=None):
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.optimizer import AdamW

    return train_step(model, AdamW(learning_rate=1e-4, parameters=model.parameters()), loss_fn,
                      device=device)


def _grad_errors(model, ref_model):
    """(worst gradient error, its parameter name): each parameter's largest
    error relative to the largest gradient entry of its layer (the module
    that owns it), since some gradients are zero up to rounding (the key
    projection's bias: softmax ignores a shift along a row). A parameter
    without a gradient on either side fails."""
    pairs = list(zip(model.named_parameters(), ref_model.named_parameters()))
    for (n, p), (_, pr) in pairs:
        if p.grad is None or pr.grad is None:
            raise AssertionError(f"{n}: no gradient ({'card' if p.grad is None else 'CPU'})")
    scale = {}
    for (n, _), (_, pr) in pairs:
        layer = n.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(pr.grad.abs().max()))
    worst, name = 0.0, None
    for (n, p), (_, pr) in pairs:
        e = float((p.grad.cpu() - pr.grad).abs().max()) / max(scale[n.rpartition(".")[0]],
                                                                1e-30)
        if e > worst:
            worst, name = e, n
    return worst, name


def train_parity():
    """One step at dropout 0, batch 2 x L=512, on the card and on the CPU
    (the plain path) from the same weights; then the same step with TF32
    matmuls on, which the limits must catch. Returns the readings."""
    import torch

    from paddle_tpu_torch.models import bert_base_config
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = bert_base_config()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    model, loss_fn = _pretraining(cfg, seed=0)
    cpu_model, tf32_model = copy.deepcopy(model), copy.deepcopy(model)
    batch = pretraining_batch(cfg, 2, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(8))
    t0 = time.perf_counter()
    cpu_loss = float(_step_of(cpu_model, loss_fn, device="cpu")(*batch)["loss"])
    log(f"parity step on the CPU (plain path): loss {cpu_loss:.6f}, "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launch_counts()
    loss = float(_step_of(model, loss_fn)(*batch)["loss"])
    counts = launch_counts()
    layers = cfg.num_hidden_layers
    want = {"layernorm_residual_fwd": 2 * layers, "layernorm_residual_bwd": 2 * layers,
            "flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers}
    want = {name: want.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"parity step launched {counts}; want {want}")
    grad_err, worst = _grad_errors(model, cpu_model)
    loss_err = abs(loss - cpu_loss)
    step = _step_of(tf32_model, loss_fn)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_loss = float(step(*batch)["loss"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_grad, tf32_worst = _grad_errors(tf32_model, cpu_model)
    tf32_loss_err = abs(tf32_loss - cpu_loss)
    log(f"parity step on the card: loss {loss:.6f}, err vs CPU {loss_err:.3g} (atol "
        f"{TRAIN_LOSS_ATOL}); worst gradient err {grad_err:.3g} of its layer's largest entry, "
        f"at {worst} (rtol {TRAIN_GRAD_RTOL}); TF32 control: loss err {tf32_loss_err:.3g}, "
        f"worst gradient err {tf32_grad:.3g} at {tf32_worst}")
    if not (np.isfinite(loss) and loss_err <= TRAIN_LOSS_ATOL and grad_err <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"parity step: loss err {loss_err}, gradient err {grad_err} at "
                             f"{worst} beyond {TRAIN_LOSS_ATOL} / {TRAIN_GRAD_RTOL}")
    if not (tf32_loss_err > TRAIN_LOSS_ATOL and tf32_grad > TRAIN_GRAD_RTOL):
        raise AssertionError(f"TF32 control (loss {tf32_loss_err}, gradient {tf32_grad}) passes "
                             f"the training limits {TRAIN_LOSS_ATOL} / {TRAIN_GRAD_RTOL}")
    return {"loss_err": loss_err, "grad_rel_err": grad_err, "worst_param": worst,
            "tf32_loss_err": tf32_loss_err, "tf32_grad_rel_err": tf32_grad}


def _timed_steps(step, batch, steps):
    """One warm-up step (cuBLAS and cuDNN plans, the allocator's pool), then
    ``steps`` steps timed with CUDA events, the launch counts set to 0 just
    before them. Returns (losses, warm-up first; ms of each timed step;
    host-clock ms a step; launches over the timed steps; peak device memory
    in GiB over all of them)."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    losses = [step(*batch)["loss"]]
    torch.cuda.synchronize()
    reset_launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        losses.append(step(*batch)["loss"])
        events[i + 1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = launch_counts()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    return ([float(x) for x in losses], step_ms, wall_ms, counts,
            torch.cuda.max_memory_allocated() / 2**30)


def _profile_step(step, batch, label):
    """One training step under ``torch.profiler``: wall time, the device's
    busy share, kernel time by kind and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _log_profile(prof, wall, label, top=10)


def train_bert():
    """Phase 6. Returns kernel launches per name over the timed steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import bert_base_config

    train_parity()
    cfg = bert_base_config()  # hidden and attention dropout 0.1
    cfg.use_flash_attention = True
    model, loss_fn = _pretraining(cfg, seed=1)
    step = _step_of(model, loss_fn)
    batch = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(9))]
    losses, step_ms, wall_ms, counts, peak = _timed_steps(step, batch, TRAIN_STEPS)
    layers = cfg.num_hidden_layers
    want = {"layernorm_residual_fwd": 2 * layers, "layernorm_residual_bwd": 2 * layers,
            "flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers}
    want = {k: want.get(k, 0) * TRAIN_STEPS for k in counts}
    if counts != want:
        raise AssertionError(f"{TRAIN_STEPS} steps launched {counts}; want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    tokens = TRAIN_B * TRAIN_SEQ
    mean_ms = float(np.mean(step_ms))
    log(f"{TRAIN_STEPS} steps at batch {TRAIN_B} x L={TRAIN_SEQ}, {TRAIN_PRED} masked a row, "
        f"dropout {cfg.hidden_dropout_prob}: losses {', '.join(f'{x:.6f}' for x in losses)}")
    log(f"step {mean_ms:.2f} ms (median {float(np.median(step_ms)):.2f}, min {min(step_ms):.2f}, "
        f"max {max(step_ms):.2f}; host clock {wall_ms:.2f}), {tokens / mean_ms * 1e3:.0f} "
        f"tokens/s; peak device memory "
        f"{peak:.1f} GiB; launches {counts}: "
        f"{2 * layers} + {2 * layers} LayerNorm, {layers} attention forward, {layers} dQ, "
        f"{layers} dK/dV a step")
    _profile_step(step, batch, "train step profiled")
    # the optimizer update alone: how much of the step's idle time is its
    model.train()
    step.optimizer.clear_grad()
    loss_fn(model, *batch).backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.optimizer.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kind, events = _device_time_by_kind(prof)
    log(f"AdamW update alone: {wall:.3f} ms wall, device busy {sum(by_kind.values()):.3f} ms "
        f"in {events} device events")
    return counts


# -- the ResNet path -----------------------------------------------------------

# ResNet-50 at bench.py's training shape (bench_resnet50: batch 128 of
# 224 x 224 images, 1000 classes, Momentum lr 0.1, momentum 0.9)
RN_B, RN_HW, RN_CLASSES, RN_STEPS = 128, 224, 1000, 10
RN_LR, RN_MOMENTUM = 0.1, 0.9
RN_BUCKETS = (1, 8, 32)
RN_TRIPLES = 33  # fused conv + bn + relu: the stem, conv1/bn1 and conv2/bn2 of 16 blocks
RN_PARAMS = 161
# layer1's 3x3 conv at batch 128: the counted entry of the six conv kernels
CONV_M, CONV_K, CONV_N = RN_B * 56 * 56, 64 * 9, 64
# products of K float32 terms, relative to the largest output: room for
# another summation order than cuBLAS's (the kernel's sequential FMA chain
# over K read bit-equal to cuBLAS's on the H100)
CONV_MM_RTOL = 2e-5
# channel sums of M float32 terms in another order: relative to the
# channel's sum of |terms|
CONV_SUM_RTOL = 1e-5
_CONV_SRC = "paddle_tpu_torch/csrc/conv_bn_relu_mm.cu"
_BN_SRC = "paddle_tpu_torch/csrc/conv_bn_relu_bn.cu"
_CBR = "paddle_tpu/ops/pallas/conv_bn_relu.py"


def _rel(got, want):
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _sum_rel(got, want, terms):
    """max over channels of |got - want| over the channel's sum of |terms|."""
    return float(((got - want).abs() / terms.abs().sum(0).clamp_min(1e-30)).max())


def _conv_sets(g, m, k, n, count):
    """``count`` sets of (p2, w2, scale, shift) for a conv lowered to
    [m, k] @ [k, n]; weights at Kaiming scale, BN vectors as training
    makes them."""
    import torch

    out = []
    for _ in range(count):
        p2 = torch.randn(m, k, generator=g, device="cuda")
        w2 = torch.randn(k, n, generator=g, device="cuda") * (2.0 / k) ** 0.5
        scale = torch.rand(n, generator=g, device="cuda") + 0.5
        shift = torch.randn(n, generator=g, device="cuda") * 0.5
        out.append((p2, w2, scale, shift))
    return out


def check_conv_mm(m, k, n, label, timed=True):
    """Rows 8 and 9 (``conv_bn_relu_mm.cu``) at [m, k] @ [k, n] against the
    plain versions on the same inputs: the eval affine + relu output, and
    the training ``co`` with its channel sums."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(21)
    sets = _conv_sets(g, m, k, n, 2 if timed else 1)
    p2, w2, scale, shift = sets[0]
    y = cbr.mm_affine_relu(p2, w2, scale, shift)
    y_ref = cbr._mm_affine_relu_plain(p2, w2, scale, shift)
    co, part = cbr.mm_stats(p2, w2)
    co_ref, part_ref = cbr._mm_stats_plain(p2, w2)
    torch.cuda.synchronize()
    err8 = _rel(y, y_ref)
    err9 = _rel(co, co_ref)
    sum_err = _sum_rel(part.sum(0), part_ref.sum(0), co_ref)
    tol8 = f"rtol {CONV_MM_RTOL} of the largest output"
    tol9 = f"co {tol8}; channel sums {CONV_SUM_RTOL} of the channel's sum of |co|"
    if err8 > CONV_MM_RTOL or err9 > CONV_MM_RTOL or sum_err > CONV_SUM_RTOL:
        raise AssertionError(f"conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu err "
                             f"{err8}, co err {err9}, sums err {sum_err} beyond {tol9}")
    flops = 2 * m * k * n
    b8, by8 = bound(4 * (m * k + k * n + m * n + 2 * n), flops + 3 * m * n)
    b9, by9 = bound(4 * (m * k + k * n + m * n + n), flops + m * n)
    e8 = {"name": "conv_bn_relu_mm_affine_relu", "route": "cuda", "source": _CONV_SRC,
          "replaces": f"{_CBR}:306", "shape": [m, k, n], "label": label, "dtype": "float32",
          "max_abs_err": float((y - y_ref).abs().max()), "rel_err": err8, "tolerance": tol8,
          "bound_ms": b8, "bound_by": by8}
    e9 = {"name": "conv_bn_relu_mm_stats", "route": "cuda", "source": _CONV_SRC,
          "replaces": f"{_CBR}:337", "shape": [m, k, n], "label": label, "dtype": "float32",
          "max_abs_err": float((co - co_ref).abs().max()), "rel_err": err9,
          "sums_rel_err": sum_err, "tolerance": tol9, "bound_ms": b9, "bound_by": by9}
    if timed:
        iters = max(5, min(50, int(3e11 / flops)))
        e8["ms"] = e8["kernel_ms"] = time_ms(cbr.mm_affine_relu, sets, iters)
        e8["plain_ms"] = time_ms(cbr._mm_affine_relu_plain, sets, iters)
        e9["ms"] = e9["kernel_ms"] = time_ms(lambda p, w, s_, b_: cbr.mm_stats(p, w), sets, iters)
        e9["plain_ms"] = time_ms(lambda p, w, s_, b_: cbr._mm_stats_plain(p, w), sets, iters)
        lib = time_ms(lambda p, w, s_, b_: torch.matmul(p, w), sets, iters)
        e8["library_ms"] = e9["library_ms"] = lib
        e8["library"] = e9["library"] = "torch.matmul(p2, w2), f32, TF32 off (the product alone)"
        log(f"conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu err {err8:.3g}, co err "
            f"{err9:.3g}, sums {sum_err:.3g} ({tol9}); affine+relu {e8['ms']:.4f} ms (bound "
            f"{b8:.4f}, {by8}), stats {e9['ms']:.4f} ms (bound {b9:.4f}), plain "
            f"{e8['plain_ms']:.4f} / {e9['plain_ms']:.4f} ms, torch.matmul {lib:.4f} ms")
    else:
        log(f"conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu err {err8:.3g}, co err "
            f"{err9:.3g}, sums {sum_err:.3g} ({tol9})")
    return e8, e9


def check_bn_passes(m, n, label, timed=True, mean_offset=1.0, std=1.0):
    """Rows 10-13 (``conv_bn_relu_bn.cu``) over a [m, n] conv output against
    the plain versions: the centred sum of squares, normalize + relu and
    the two backward passes (the relu gate recomputed from co: the
    elementwise passes round as the plain version does, so they must equal
    it bit for bit)."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(22)

    def make():
        co = (torch.randn(m, n, generator=g, device="cuda") * std
              + torch.randn(n, generator=g, device="cuda") * mean_offset)
        dy = torch.randn(m, n, generator=g, device="cuda")
        mean = co.mean(0)
        rstd = torch.rsqrt(co.var(0, unbiased=False) + 1e-5)
        gamma = torch.rand(n, generator=g, device="cuda") + 0.5
        beta = torch.randn(n, generator=g, device="cuda") * 0.1
        scale = gamma * rstd
        shift = beta - mean * scale
        k3 = torch.randn(n, generator=g, device="cuda") * 1e-3
        b0 = torch.randn(n, generator=g, device="cuda") * 1e-3
        return co, dy, mean, scale, shift, k3, b0

    sets = [make() for _ in range(2 if timed else 1)]
    co, dy, mean, scale, shift, k3, b0 = sets[0]
    ss = cbr.centered_sumsq(co, mean).sum(0)
    ss_ref = cbr._centered_sumsq_plain(co, mean).sum(0)
    ss64 = (co.double() - co.double().mean(0)).square().sum(0)
    y = cbr.bn_relu(co, scale, shift)
    y_ref = cbr._bn_relu_plain(co, scale, shift)
    pdy, pdyc = cbr.bn_bwd_partials(co, dy, scale, shift)
    rdy, rdyc = cbr._bn_bwd_partials_plain(co, dy, scale, shift)
    dco = cbr.bn_bwd_dco(co, dy, scale, shift, k3, b0)
    dco_ref = cbr._bn_bwd_dco_plain(co, dy, scale, shift, k3, b0)
    torch.cuda.synchronize()
    err10 = float(((ss - ss_ref).abs() / ss_ref.abs()).max())
    err10_64 = float(((ss.double() - ss64).abs() / ss64).max())
    gated = cbr._gated(co, dy, scale, shift)
    err12 = max(_sum_rel(pdy.sum(0), rdy.sum(0), gated),
                _sum_rel(pdyc.sum(0), rdyc.sum(0), gated * co))
    err11 = float((y - y_ref).abs().max())
    err13 = float((dco - dco_ref).abs().max())
    tol10 = (f"rtol {CONV_SUM_RTOL} of the plain version's sum (and of a float64 centred sum: "
             f"read {err10_64:.3g})")
    tol12 = f"rtol {CONV_SUM_RTOL} of the channel's sum of |terms|"
    if not (err10 <= CONV_SUM_RTOL and err10_64 <= CONV_SUM_RTOL and err11 == 0.0
            and err12 <= CONV_SUM_RTOL and err13 == 0.0):
        raise AssertionError(f"batch-norm passes {label} [{m}, {n}]: sumsq {err10} (f64 "
                             f"{err10_64}), bn_relu {err11}, partials {err12}, dco {err13} "
                             f"beyond {tol10} / bit-exact / {tol12} / bit-exact")
    vec = 8 * n
    entries = [
        {"name": "conv_bn_relu_centered_sumsq", "source": _BN_SRC, "replaces": f"{_CBR}:370",
         "max_abs_err": float((ss - ss_ref).abs().max()), "rel_err": err10,
         "rel_err_vs_float64": err10_64, "tolerance": tol10,
         "bound": bound(4 * (m * n + 2 * n), 3 * m * n)},
        {"name": "conv_bn_relu_bn_relu", "source": _BN_SRC, "replaces": f"{_CBR}:399",
         "max_abs_err": err11, "tolerance": "bit-exact (the same rounding of co * scale + shift)",
         "bound": bound(4 * (2 * m * n) + vec, 3 * m * n)},
        {"name": "conv_bn_relu_bn_bwd_partials", "source": _BN_SRC, "replaces": f"{_CBR}:463",
         "max_abs_err": max(float((pdy.sum(0) - rdy.sum(0)).abs().max()),
                            float((pdyc.sum(0) - rdyc.sum(0)).abs().max())),
         "rel_err": err12, "tolerance": tol12,
         "bound": bound(4 * (2 * m * n + 2 * n) + vec, 5 * m * n)},
        {"name": "conv_bn_relu_bn_bwd_dco", "source": _BN_SRC, "replaces": f"{_CBR}:496",
         "max_abs_err": err13, "tolerance": "bit-exact (the same rounding, gate included)",
         "bound": bound(4 * (3 * m * n) + 2 * vec, 7 * m * n)},
    ]
    for e in entries:
        e.update({"route": "cuda", "shape": [m, n], "label": label, "dtype": "float32"})
        e["bound_ms"], e["bound_by"] = e.pop("bound")
    if not timed:
        log(f"batch-norm passes {label} [{m}, {n}]: sumsq err {err10:.3g} (f64 {err10_64:.3g}), "
            f"bn_relu {err11}, partials {err12:.3g}, dco {err13} (bit-exact where stated)")
        return entries
    runs = [
        (lambda co, dy, mean, s_, b_, k3, b0: cbr.centered_sumsq(co, mean),
         lambda co, dy, mean, s_, b_, k3, b0: cbr._centered_sumsq_plain(co, mean),
         lambda co, dy, mean, s_, b_, k3, b0: torch.var(co, 0, unbiased=False), "torch.var"),
        (lambda co, dy, mean, s_, b_, k3, b0: cbr.bn_relu(co, s_, b_),
         lambda co, dy, mean, s_, b_, k3, b0: cbr._bn_relu_plain(co, s_, b_), None,
         "none: no single PyTorch call computes relu(co * scale + shift)"),
        (lambda co, dy, mean, s_, b_, k3, b0: cbr.bn_bwd_partials(co, dy, s_, b_),
         lambda co, dy, mean, s_, b_, k3, b0: cbr._bn_bwd_partials_plain(co, dy, s_, b_), None,
         "none: no single PyTorch call computes the gated sums"),
        (lambda co, dy, mean, s_, b_, k3, b0: cbr.bn_bwd_dco(co, dy, s_, b_, k3, b0),
         lambda co, dy, mean, s_, b_, k3, b0: cbr._bn_bwd_dco_plain(co, dy, s_, b_, k3, b0),
         None, "none: no single PyTorch call computes the folded batch-norm backward"),
    ]
    for e, (kern, plain, lib, lib_name) in zip(entries, runs):
        e["ms"] = e["kernel_ms"] = time_ms(kern, sets, 100)
        e["plain_ms"] = time_ms(plain, sets, 20)
        e["library_ms"] = time_ms(lib, sets, 100) if lib else None
        e["library"] = lib_name
    log(f"batch-norm passes {label} [{m}, {n}]: sumsq err {err10:.3g} (f64 {err10_64:.3g}), "
        f"bn_relu {err11}, partials {err12:.3g}, dco {err13}; kernel ms "
        + ", ".join(f"{e['name'][13:]} {e['ms']:.4f} (bound {e['bound_ms']:.4f}, plain "
                    f"{e['plain_ms']:.4f})" for e in entries)
        + f"; torch.var {entries[0]['library_ms']:.4f}")
    return entries


def _resnet50_param_shapes():
    from paddle_tpu_torch.models import resnet50

    return [tuple(p.shape) for p in resnet50(num_classes=RN_CLASSES).parameters()]


def check_momentum(shapes, label, variants, timed=True):
    """Rows 14 / 14a (``optimizer_update.cu``) over parameters of
    ``shapes``: one multi-tensor update of all of them (a launch per
    ``MAX_TENSORS``) against the plain version's expression, bit for bit,
    for each (nesterov, weight decay) of ``variants``; timed beside the plain
    version and ``torch.optim.SGD`` with the same momentum over the same
    parameters in one call."""
    import torch

    from paddle_tpu_torch.ops.cuda import optimizer_update as ou

    g = torch.Generator(device="cuda").manual_seed(23)
    mk = lambda: [torch.randn(s, generator=g, device="cuda") for s in shapes]  # noqa: E731
    params, grads, vels = mk(), mk(), mk()
    launches = len(ou.launch_groups([int(np.prod(s)) for s in shapes]))
    diff = 0
    for nesterov, wd in variants:
        p, v = [t.clone() for t in params], [t.clone() for t in vels]
        want = [ou._plain_update(a, b, c, RN_LR, RN_MOMENTUM, wd, nesterov)
                for a, b, c in zip(p, grads, v)]
        before = ou.LAUNCHES
        ou.fused_momentum_update_multi(p, grads, v, RN_LR, RN_MOMENTUM, wd, nesterov)
        torch.cuda.synchronize()
        if ou.LAUNCHES - before != launches:
            raise AssertionError(f"momentum update {label}: {ou.LAUNCHES - before} launches, "
                                 f"not {launches}")
        diff += sum(int((a != wp).sum()) + int((c != wv).sum())
                    for a, c, (wp, wv) in zip(p, v, want))
    n = sum(int(t.numel()) for t in params)
    if diff:
        raise AssertionError(f"momentum update {label}: {diff} elements differ from the plain "
                             "version (must be bit-exact)")
    b_ms, by = bound(4 * 5 * n, 5 * n)
    entry = {"name": "momentum_update", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/optimizer_update.cu",
             "replaces": "paddle_tpu/ops/pallas/optimizer_update.py:167", "label": label,
             "parameters": len(shapes), "elements": n, "launches_per_update": launches,
             "dtype": "float32",
             "variants": [{"nesterov": a, "weight_decay": b} for a, b in variants],
             "max_abs_err": 0.0, "elements_differing": 0, "tolerance": "bit-exact",
             "bound_ms": b_ms, "bound_by": by}
    if not timed:
        log(f"momentum update {label} ({len(shapes)} parameters, {n} elements, {launches} "
            f"launches): bit-exact for {variants}")
        return entry

    # copies whose bytes together exceed the 50 MB L2, cycled, so every call
    # reads from device memory as a training step's update does
    copies = max(1, min(8, -(-200 * 2**20 // (12 * n))))
    sets = [(params, grads, vels)] + [tuple([t.clone() for t in ts] for ts in (params, grads, vels))
                                      for _ in range(copies - 1)]
    turn = [0]

    def next_set():
        turn[0] += 1
        return sets[turn[0] % copies]

    def kernel_all():
        ou.fused_momentum_update_multi(*next_set(), RN_LR, RN_MOMENTUM)

    def plain_all():
        for a, b, c in zip(*next_set()):
            ou._plain_update(a, b, c, RN_LR, RN_MOMENTUM, 0.0, False)

    def sgd_of(ps, gs, fused):
        lib = [torch.nn.Parameter(t.clone()) for t in ps]
        for t, gr in zip(lib, gs):
            t.grad = gr
        kw = {"fused": True} if fused else {"foreach": True}
        return torch.optim.SGD(lib, lr=RN_LR, momentum=RN_MOMENTUM, **kw)

    try:
        sgds = [sgd_of(p_, g_, True) for p_, g_, _ in sets]
        lib_name = "torch.optim.SGD(momentum=0.9, fused=True).step()"
        sgds[0].step()
    except (TypeError, RuntimeError):
        sgds = [sgd_of(p_, g_, False) for p_, g_, _ in sets]
        lib_name = "torch.optim.SGD(momentum=0.9, foreach=True).step()"

    def lib_all():
        turn[0] += 1
        sgds[turn[0] % copies].step()

    iters = 50 if len(shapes) > 1 else 200
    # device time (host hidden) and host time a call of each; the events
    # over back-to-back calls as well, which the slower of the two sets
    entry["ms"], entry["host_ms"] = device_ms(kernel_all, iters)
    entry["kernel_ms"] = entry["ms"]
    # (the plain version's ~800 launches a call fill the launch queue, so
    # its device time includes some host pacing)
    entry["plain_ms"], entry["plain_host_ms"] = device_ms(plain_all, 5)
    entry["library_ms"], entry["library_host_ms"] = device_ms(lib_all, iters)
    entry["library"] = lib_name
    entry["back_to_back_ms"] = time_ms(kernel_all, [()], iters)
    entry["library_back_to_back_ms"] = time_ms(lib_all, [()], iters)
    entry["copies_cycled"] = copies
    log(f"momentum update {label} ({len(shapes)} parameters, {n} elements, {launches} "
        f"launches): bit-exact for {variants}; device ms a call: kernel {entry['ms']:.4f}, "
        f"plain {entry['plain_ms']:.4f}, {lib_name} {entry['library_ms']:.4f}, bound "
        f"{b_ms:.4f} ({by}); host ms a call: kernel {entry['host_ms']:.4f}, plain "
        f"{entry['plain_host_ms']:.4f}, library {entry['library_host_ms']:.4f}; back to back: "
        f"kernel {entry['back_to_back_ms']:.4f}, library {entry['library_back_to_back_ms']:.4f}")
    return entry


def check_resnet_kernels():
    """One entry per kernel of the ResNet path (rows 8-14) at layer1's 3x3
    conv at batch 128 (the momentum update at ResNet-50's largest
    parameter); the stem (K = 147), a ragged shape (M, N off every tile,
    N % 4 != 0), row 8 at the serving batch, the large-mean variance and
    all 161 parameters ride along under ``also_checked``."""
    import torch

    e8, e9 = check_conv_mm(CONV_M, CONV_K, CONV_N, "layer1 3x3, batch 128")
    s8, s9 = check_conv_mm(RN_B * 112 * 112, 3 * 7 * 7, 64, "stem 7x7, batch 128")
    r8, r9 = check_conv_mm(12345, 147, 70, "ragged", timed=False)
    v8, _ = check_conv_mm(RN_BUCKETS[-1] * 56 * 56, CONV_K, CONV_N,
                          f"layer1 3x3, serving batch {RN_BUCKETS[-1]}")
    e8["also_checked"] = [s8, r8, v8]
    e9["also_checked"] = [s9, r9]
    bn = check_bn_passes(CONV_M, CONV_N, "layer1 3x3, batch 128")
    ragged = check_bn_passes(12345, 70, "ragged", timed=False)
    large = check_bn_passes(CONV_M, CONV_N, "mean ~100, std ~0.1", timed=False,
                            mean_offset=100.0, std=0.1)
    for e, r in zip(bn, ragged):
        e["also_checked"] = [r]
    bn[0]["also_checked"].append(large[0])
    shapes = _resnet50_param_shapes()
    if len(shapes) != RN_PARAMS:
        raise AssertionError(f"ResNet-50 has {len(shapes)} parameters, not {RN_PARAMS}")
    largest = max(shapes, key=lambda s: int(np.prod(s)))
    variants = [(False, 0.0), (False, 1e-4), (True, 0.0), (True, 1e-4)]
    mom = check_momentum([largest], f"largest parameter {list(largest)}", variants)
    mom["also_checked"] = [check_momentum(shapes, "all ResNet-50 parameters", variants)]
    torch.cuda.empty_cache()
    return [e8, e9, *bn, mom]


def _images(rng, rows):
    """Images as float64 rounded to 3 decimals: short JSON, and exactly the
    float32 values the server parses."""
    return np.round(rng.randn(rows, 3, RN_HW, RN_HW), 3)


# Serving limit against the CPU forward of the same weights: max |logit
# error| over the largest |logit| of the answer, about the geometric mean of
# two readings on an H100: f32 (2.0e-6: 53 layers of f32 sums in other
# orders) and the same requests with TF32 matmuls and convolutions (5.3e-4),
# which serve_resnet requires the limit to catch.
RN_SERVE_RTOL = 3e-5


def _resnet50(seed):
    import torch

    from paddle_tpu_torch.models import resnet50

    return resnet50(num_classes=RN_CLASSES, generator=torch.Generator().manual_seed(seed))


def serve_resnet():
    """ResNet-50 behind ``Predictor`` -> ``InferenceServer`` at buckets 1,
    8 and 32. Returns kernel launches per name on the serving run."""
    import torch

    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.jit_api import InputSpec

    specs = [InputSpec([None, 3, RN_HW, RN_HW], "float32", "image")]
    model = _resnet50(seed=0)
    cpu_pred = Predictor(copy.deepcopy(model), specs, ["logits"], device="cpu")
    pred = Predictor(model, specs, ["logits"])
    rng = np.random.RandomState(13)
    reqs = [{"image": _images(rng, rows)} for rows in (1, 6, 3, 20)]
    answers, counts, forwards = _serve(pred, RN_BUCKETS, reqs, "ResNet-50")
    wants, worst = [], 0.0
    for i, (req, ans) in enumerate(zip(reqs, answers)):
        req = req["image"]
        got = np.asarray(ans[1]["outputs"]["logits"], np.float32)
        want = cpu_pred.run([req.astype(np.float32)])[0]
        wants.append(want)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"ResNet request {i}: shape {got.shape} vs {want.shape} or "
                                 "not finite")
        e = float(np.abs(got - want).max() / np.abs(want).max())
        worst = max(worst, e)
        log(f"ResNet request {i} ({len(req)} images): logits max err vs CPU {e:.3g} of the "
            f"largest |logit| {np.abs(want).max():.4g} (limit {RN_SERVE_RTOL})")
        if e > RN_SERVE_RTOL:
            raise AssertionError(f"ResNet request {i}: err {e} beyond {RN_SERVE_RTOL}")
    want = {"conv_bn_relu_mm_affine_relu": RN_TRIPLES * forwards}
    want = {name: want.get(name, 0) for name in counts}
    if forwards <= 0 or counts != want:
        raise AssertionError(f"ResNet launches {counts} over {forwards} forwards; want {want}")
    log(f"ResNet-50: {forwards} forwards, launches {counts}: {RN_TRIPLES} fused eval kernels "
        "each")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = max(float(np.abs(pred.run([r["image"].astype(np.float32)])[0] - w).max()
                         / np.abs(w).max()) for r, w in zip(reqs, wants))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log(f"ResNet TF32 control (matmul and cuDNN convs in TF32): max err vs CPU {tf32:.3g} "
        f"(limit {RN_SERVE_RTOL}; f32 read {worst:.3g})")
    if not tf32 > RN_SERVE_RTOL:
        raise AssertionError(f"ResNet TF32 control {tf32} passes the serving limit "
                             f"{RN_SERVE_RTOL}: it cannot catch it")
    profile_resnet_forward(pred)
    return counts


def profile_resnet_forward(pred):
    """Forward time per bucket (inputs on the card, CUDA events around 10
    forwards), then ``Predictor.run`` at the smallest and largest bucket
    under ``torch.profiler``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(5)
    for bucket in RN_BUCKETS:
        x = torch.randn(bucket, 3, RN_HW, RN_HW, generator=g, device="cuda")
        with torch.inference_mode():
            ms = time_ms(pred.module, [(x,)] * 2, 10)
        log(f"ResNet-50 forward bucket {bucket}: {ms:.3f} ms, {bucket / ms * 1e3:.1f} images/s")
    rng = np.random.RandomState(6)
    for bucket in (RN_BUCKETS[0], RN_BUCKETS[-1]):
        _profile_run(pred, [rng.randn(bucket, 3, RN_HW, RN_HW).astype(np.float32)],
                     f"ResNet Predictor.run bucket {bucket}")


# Training parity limits against the CPU's plain path (batch 2 x 224 x 224),
# each about the geometric mean of two readings on an H100, f32 and the same
# step with TF32 matmuls and convolutions (which rn_train_parity requires
# them to catch): the loss (1.9e-5 / 3.7e-3), each BN running buffer over its
# batch norm's largest buffer entry (1.0e-5 / 5.3e-3), the classifier's
# gradients over their layer's largest entry (3.1e-5 / 1.9e-2).
RN_LOSS_ATOL = 2.5e-4
RN_BUF_RTOL = 2e-4
RN_FC_GRAD_RTOL = 7e-4
# Every other gradient sits behind relu gates: a pre-activation within f32
# rounding of 0 lands on opposite sides of the gate on the card and on the
# CPU, and the whole gradient of every layer before it moves (f32 read
# 0.143 of the layer's largest entry at layer3.2.conv1.weight, where batch
# 2 leaves 392 rows a channel). Elementwise, that cannot be told from TF32
# (0.739), so every gradient is held only to 0.5 of its layer's largest
# entry (a wrong sign or a missing term), and the gradient as a whole by
# its relative L2 error over the model: f32 0.0153, TF32 0.488.
RN_GRAD_RTOL = 0.5
RN_GRAD_L2_RTOL = 0.08


def _rn_loss(m, x, y):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(m(x), y)


def _rn_step_of(model, device=None):
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.optimizer import Momentum

    opt = Momentum(learning_rate=RN_LR, momentum=RN_MOMENTUM, parameters=model.parameters())
    return train_step(model, opt, _rn_loss, device=device)


def _buffer_errors(model, ref_model):
    """(worst, its name): each running buffer's largest error over the
    largest entry of its batch norm's two buffers."""
    pairs = list(zip(model.named_buffers(), ref_model.named_buffers()))
    scale = {}
    for (n, _), (_, r) in pairs:
        layer = n.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(r.abs().max()))
    worst, name = 0.0, None
    for (n, b), (_, r) in pairs:
        e = float((b.cpu() - r).abs().max()) / max(scale[n.rpartition(".")[0]], 1e-30)
        if e > worst:
            worst, name = e, n
    return worst, name


def _grad_l2_errors(model, ref_model):
    """(relative L2 error of the whole gradient, worst relative L2 error
    of one parameter's gradient, its name)."""
    num = den = 0.0
    worst, name = 0.0, None
    for (n, p), (_, r) in zip(model.named_parameters(), ref_model.named_parameters()):
        d = float((p.grad.cpu().double() - r.grad.double()).square().sum())
        s = float(r.grad.double().square().sum())
        num, den = num + d, den + s
        if d / max(s, 1e-300) > worst:
            worst, name = d / max(s, 1e-300), n
    return (num / den) ** 0.5, worst ** 0.5, name


def _fc_grad_error(model, ref_model):
    g = [p.grad.cpu() for n, p in model.named_parameters() if n.startswith("fc.")]
    r = [p.grad for n, p in ref_model.named_parameters() if n.startswith("fc.")]
    s = max(float(t.abs().max()) for t in r)
    return max(float((a - b).abs().max()) for a, b in zip(g, r)) / s


def rn_train_parity(pool_kernel=False):
    """One Momentum step at batch 2 x 224 x 224 on the card and on the CPU
    (the plain path) from the same weights, then the same step with TF32
    matmuls and convolutions, which the limits must catch. ``pool_kernel``
    says whether ``FLAGS_use_pallas_pool_bwd`` is on (the caller sets it):
    then the step also launches the max-pool backward kernel once."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = _resnet50(seed=2)
    cpu_model, tf32_model = copy.deepcopy(model), copy.deepcopy(model)
    rng = np.random.RandomState(14)
    batch = [rng.randn(2, 3, RN_HW, RN_HW).astype(np.float32),
             rng.randint(0, RN_CLASSES, (2,)).astype(np.int64)]
    t0 = time.perf_counter()
    cpu_loss = float(_rn_step_of(cpu_model, device="cpu")(*batch)["loss"])
    log(f"ResNet parity step on the CPU (plain path): loss {cpu_loss:.6f}, "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launch_counts()
    loss = float(_rn_step_of(model)(*batch)["loss"])
    counts = launch_counts()
    want = _rn_step_launches(1, pool_kernel)
    if counts != want:
        raise AssertionError(f"ResNet parity step launched {counts}; want {want}")
    _rn_check_tensors(1, "ResNet parity step")
    readings = {"loss_err": abs(loss - cpu_loss), "grad_rel_err": _grad_errors(model, cpu_model),
                "grad_l2": _grad_l2_errors(model, cpu_model),
                "fc_grad_rel_err": _fc_grad_error(model, cpu_model),
                "buffer_rel_err": _buffer_errors(model, cpu_model)}
    step = _rn_step_of(tf32_model)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_loss = float(step(*batch)["loss"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tf32 = {"loss_err": abs(tf32_loss - cpu_loss),
            "grad_rel_err": _grad_errors(tf32_model, cpu_model),
            "grad_l2": _grad_l2_errors(tf32_model, cpu_model),
            "fc_grad_rel_err": _fc_grad_error(tf32_model, cpu_model),
            "buffer_rel_err": _buffer_errors(tf32_model, cpu_model)}
    log(f"ResNet parity step on the card: loss {loss:.6f}; f32 {readings}; TF32 control {tf32} "
        f"(limits: loss {RN_LOSS_ATOL}, buffers {RN_BUF_RTOL}, fc gradients {RN_FC_GRAD_RTOL}, "
        f"every gradient {RN_GRAD_RTOL}, the gradient's L2 {RN_GRAD_L2_RTOL})")
    ok = (np.isfinite(loss) and readings["loss_err"] <= RN_LOSS_ATOL
          and readings["buffer_rel_err"][0] <= RN_BUF_RTOL
          and readings["fc_grad_rel_err"] <= RN_FC_GRAD_RTOL
          and readings["grad_rel_err"][0] <= RN_GRAD_RTOL
          and readings["grad_l2"][0] <= RN_GRAD_L2_RTOL)
    if not ok:
        raise AssertionError(f"ResNet parity step {readings} beyond its limits")
    if not (tf32["loss_err"] > RN_LOSS_ATOL and tf32["buffer_rel_err"][0] > RN_BUF_RTOL
            and tf32["fc_grad_rel_err"] > RN_FC_GRAD_RTOL
            and tf32["grad_l2"][0] > RN_GRAD_L2_RTOL):
        raise AssertionError(f"ResNet TF32 control {tf32} passes the training limits")
    return readings, tf32


def _rn_momentum_launches():
    """Launches of one Momentum step over ResNet-50's parameters: one per
    ``MAX_TENSORS`` of them."""
    from paddle_tpu_torch.ops.cuda import optimizer_update as ou

    return -(-RN_PARAMS // ou.MAX_TENSORS)


def _rn_check_tensors(steps, label):
    """The momentum launches of ``steps`` steps updated every parameter
    once a step (the count set to 0 with the launch counts)."""
    from paddle_tpu_torch.ops.cuda import optimizer_update as ou

    if ou.TENSORS != RN_PARAMS * steps:
        raise AssertionError(f"{label}: the momentum launches updated {ou.TENSORS} tensors, not "
                             f"{RN_PARAMS} x {steps}")


def _rn_step_launches(steps, pool_kernel=False):
    from paddle_tpu_torch.ops.cuda import KERNEL_COUNTERS

    want = {f"conv_bn_relu_{k}": RN_TRIPLES * steps for k in
            ("mm_stats", "centered_sumsq", "bn_relu", "bn_bwd_partials", "bn_bwd_dco")}
    want["momentum_update"] = _rn_momentum_launches() * steps
    want["max_pool2d_backward"] = steps if pool_kernel else 0  # the stem's pool
    return {name: want.get(name, 0) for name in KERNEL_COUNTERS}


RN_STEPS_FLAG_OFF = 4  # the run without the pool kernel, kept beside the main one


def _rn_timed_run(steps, pool_kernel):
    """``steps`` timed Momentum steps at batch 128 on one fixed batch from
    the same seeds, with the launch counts the flag's setting must give.
    Returns (step, batch, losses, ms of each step, host-clock ms a step,
    launches, peak GiB)."""
    import torch

    model = _resnet50(seed=1)
    step = _rn_step_of(model)
    rng = np.random.RandomState(15)
    batch = [torch.from_numpy(rng.randn(RN_B, 3, RN_HW, RN_HW).astype(np.float32)).cuda(),
             torch.from_numpy(rng.randint(0, RN_CLASSES, (RN_B,)).astype(np.int64)).cuda()]
    losses, step_ms, wall_ms, counts, peak = _timed_steps(step, batch, steps)
    want = _rn_step_launches(steps, pool_kernel)
    if counts != want:
        raise AssertionError(f"ResNet {steps} steps launched {counts}; want {want}")
    _rn_check_tensors(steps, f"ResNet {steps} steps")
    # at lr 0.1 with no warm-up the loss on one fixed batch falls for two
    # steps and then swings (7.54 -> 5.43 -> 8.54 -> 5.63 in one run, -> 8.12
    # in another: atomics in cuDNN's and the loss's backward make runs
    # differ), so the check asks that the steps lowered it below the first
    # loss, not that the last is the lowest
    if not all(np.isfinite(losses)) or not min(losses[1:]) < losses[0]:
        raise AssertionError(f"ResNet losses not finite or not falling: {losses}")
    return step, batch, losses, step_ms, wall_ms, counts, peak


def train_resnet():
    """ResNet-50 with Momentum. With ``FLAGS_use_pallas_pool_bwd`` off (the
    default): the parity step and ``RN_STEPS_FLAG_OFF`` timed steps at batch
    128. Then with the flag on, the main run: the parity step again and
    ``RN_STEPS`` timed steps, each launching the max-pool backward kernel
    once. Returns kernel launches per name over the flag-on timed steps."""
    import torch

    from paddle_tpu_torch.flags import set_flags

    rn_train_parity()
    torch.cuda.empty_cache()
    _, _, off_losses, off_ms, _, _, _ = _rn_timed_run(RN_STEPS_FLAG_OFF, pool_kernel=False)
    log(f"ResNet-50 flag off, {RN_STEPS_FLAG_OFF} steps: losses "
        f"{', '.join(f'{x:.6f}' for x in off_losses)}")
    torch.cuda.empty_cache()
    set_flags({"use_pallas_pool_bwd": True})
    try:
        rn_train_parity(pool_kernel=True)
        torch.cuda.empty_cache()
        step, batch, losses, step_ms, wall_ms, counts, peak = _rn_timed_run(RN_STEPS,
                                                                           pool_kernel=True)
        mean_ms, off_mean = float(np.mean(step_ms)), float(np.mean(off_ms))
        log(f"ResNet-50 {RN_STEPS} steps at batch {RN_B} x {RN_HW}^2, Momentum lr {RN_LR}, "
            f"max-pool backward kernel on: losses {', '.join(f'{x:.6f}' for x in losses)}")
        log(f"ResNet-50 step {mean_ms:.2f} ms with the pool kernel (min {min(step_ms):.2f}, max "
            f"{max(step_ms):.2f}; host clock {wall_ms:.2f}), {RN_B / mean_ms * 1e3:.1f} images/s; "
            f"with the flag off {off_mean:.2f} ms (min {min(off_ms):.2f}, max {max(off_ms):.2f} "
            f"over {RN_STEPS_FLAG_OFF} steps), {RN_B / off_mean * 1e3:.1f} images/s; peak device "
            f"memory {peak:.1f} GiB; launches {counts}: {RN_TRIPLES} of each training conv kernel, "
            f"{_rn_momentum_launches()} momentum launches updating {RN_PARAMS} tensors and 1 "
            "max-pool backward a step")
        _profile_step(step, batch, "ResNet train step profiled (pool kernel on)")
    finally:
        set_flags({"use_pallas_pool_bwd": False})
    return counts


# -- the int8 serving path and the pool backward --------------------------------

# the served program: the part of BERT-base the int8 rewrite computes in int8
# (a ``mul`` by a weight), at bert_base_config()'s widths and depth
Q_HIDDEN, Q_FFN, Q_LAYERS, Q_CLASSES = 768, 3072, 12, 2
Q_MULS = 2 * Q_LAYERS + 1
Q_BUCKETS = (8, 64, 512)
Q_CALIB_BATCHES, Q_CALIB_ROWS = 4, 64
# the stem's pool at the training batch
POOL_SHAPE, POOL_GEOM = (RN_B, 64, 112, 112), ((3, 3), (2, 2), (1, 1))


def check_int8_matmul(m, k, n, label, timed=True):
    """The int8 kernel at [m, k] @ [k, n] over the full -128..127 range, bit
    for bit against the float64 product of the same values cast back (the
    card has no integer matmul in PyTorch; exact below 2**53)."""
    import torch

    from paddle_tpu_torch.ops.cuda import int8_matmul as im

    g = torch.Generator(device="cuda").manual_seed(21)
    # enough operand sets to exceed the 50 MB L2: on the serving path every
    # weight is read once a forward and comes from device memory
    count = max(2, min(64, -(-60 * 2**20 // (m * k + k * n)))) if timed else 1
    sets = [(torch.randint(-128, 128, (m, k), generator=g, device="cuda", dtype=torch.int8),
             torch.randint(-128, 128, (k, n), generator=g, device="cuda", dtype=torch.int8))
            for _ in range(count)]
    x, w = sets[0]
    out = im.int8_matmul(x, w)
    ref = im._plain_int8_matmul(x, w)
    torch.cuda.synchronize()
    err = int((out.long() - ref.long()).abs().max())
    if out.dtype != torch.int32 or err != 0:
        raise AssertionError(f"int8_matmul {label} [{m}, {k}] @ [{k}, {n}]: differs from the "
                             f"float64 product by {err}")
    if min(int(x.min()), int(w.min())) != -128 or max(int(x.max()), int(w.max())) != 127:
        raise AssertionError("the int8 operands do not span -128..127")
    t_b, by = bound(m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_OPS_PER_S)
    entry = {"name": "int8_matmul", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/int8_matmul.cu",
             "replaces": "paddle_tpu/ops/pallas/int8_matmul.py:154", "shape": [m, k, n],
             "label": label, "dtype": "int8", "max_abs_err": float(err),
             "tolerance": "bit-equal to the float64 product", "bound_ms": t_b, "bound_by": by}
    if not timed:
        log(f"int8_matmul {label} [{m}, {k}] @ [{k}, {n}]: bit-equal")
        return entry
    iters = 100
    ms = time_ms(im.int8_matmul, sets, iters)
    plain_ms = time_ms(im._plain_int8_matmul, sets, 20)
    try:  # the library call has shape limits of its own (M > 16, K and N multiples of 8)
        lib_out = torch._int_mm(x, w)
    except RuntimeError as e:
        lib_ms, lib_note = None, f"torch._int_mm refuses the shape: {str(e).splitlines()[0][:90]}"
    else:
        if not torch.equal(lib_out, ref):
            raise AssertionError(f"torch._int_mm {label} differs from the float64 product")
        lib_ms, lib_note = time_ms(torch._int_mm, sets, iters), "torch._int_mm"
    log(f"int8_matmul {label} [{m}, {k}] @ [{k}, {n}]: bit-equal; kernel {ms:.4f} ms "
        f"({2 * m * k * n / ms / 1e9:.1f} TOP/s), plain (float64) {plain_ms:.4f} ms, library "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} ({lib_note}), bound {t_b:.4f} ms "
        f"({by})")
    entry.update(ms=ms, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library=lib_note)
    return entry


def check_pool_backward(kind):
    """The max-pool backward kernel at the stem's [128, 64, 112, 112], 3x3/2/1
    against its plain version, bit for bit: on a relu output (zeros tie all
    over) and on values that are distinct within every plane. torch's own
    backward is the library yardstick; it keeps the first maximum too, and
    adds an element's taps in another order, so it is held to 4 ulps of the
    largest gradient entry."""
    import torch

    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.cuda import pool_backward as pb

    g = torch.Generator(device="cuda").manual_seed(22)
    ks, st, pad = POOL_GEOM
    n, c, h, w = POOL_SHAPE
    if kind == "relu":
        x = torch.relu(torch.randn(POOL_SHAPE, generator=g, device="cuda"))
    else:  # a permutation of 0 .. H*W-1 in every plane
        x = torch.rand(n * c, h * w, generator=g, device="cuda").argsort(-1).float()
        x = x.reshape(POOL_SHAPE)
    xr = x.clone().requires_grad_()
    y = PF.max_pool2d(xr, ks, st, pad)
    dy = torch.randn(y.shape, generator=g, device="cuda")
    yd = y.detach()
    dx = pb.max_pool2d_backward(x, yd, dy, ks, st, pad)
    ref = pb._plain_max_pool2d_backward(x, yd, dy, ks, st, pad)
    (lib,) = torch.autograd.grad(y, xr, dy, retain_graph=True)
    torch.cuda.synchronize()
    err = float((dx - ref).abs().max())
    lib_err = float((dx - lib).abs().max())
    ulp = float(torch.finfo(torch.float32).eps * ref.abs().max())
    zeros = float((x == 0).float().mean())
    if not torch.equal(dx, ref):
        raise AssertionError(f"max_pool2d_backward ({kind}): differs from the plain version by "
                             f"{err}")
    if lib_err > 4 * ulp:
        raise AssertionError(f"max_pool2d_backward ({kind}): {lib_err} from torch's backward, "
                             f"beyond 4 ulps ({4 * ulp}): another tie rule?")
    t_b, by = bound(4 * (2 * x.numel() + 2 * yd.numel()), 9 * x.numel())
    args = [(x, yd, dy, ks, st, pad)]
    ms = time_ms(pb.max_pool2d_backward, args, 20)
    plain_ms = time_ms(pb._plain_max_pool2d_backward, args, 5)
    lib_ms = time_ms(lambda: torch.autograd.grad(y, xr, dy, retain_graph=True), [()], 20)
    log(f"max_pool2d_backward {list(POOL_SHAPE)} 3x3/2/1, {kind} input"
        f"{f' ({zeros:.0%} of x is 0)' if kind == 'relu' else ''}: "
        f"bit-equal to the plain version; {lib_err:.3g} from torch's backward (4 ulps = "
        f"{4 * ulp:.3g}: the same first-maximum rule, another order of adding); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (torch's backward) {lib_ms:.4f} ms, "
        f"bound {t_b:.4f} ms ({by})")
    return {"name": "max_pool2d_backward", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/pool_backward.cu",
            "replaces": "paddle_tpu/ops/pallas/pool_backward.py:244", "shape": list(POOL_SHAPE),
            "geometry": "3x3 stride 2 padding 1", "input": kind, "dtype": "float32",
            "max_abs_err": err, "tolerance": "bit-equal to the plain version",
            "library_max_abs_err": lib_err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": t_b, "bound_by": by, "library_ms": lib_ms}


def check_new_kernels():
    """Rows 15 and 16. The int8 kernel's counted entry stands at the largest
    serving bucket's first product ([512, 768] @ [768, 3072]); every other
    shape the served program gives it (three products at three buckets),
    the 4096-row shapes and two ragged ones ride along under
    ``also_checked``."""
    import torch

    mm = check_int8_matmul(Q_BUCKETS[-1], Q_HIDDEN, Q_FFN, "bucket 512, FFN in")
    mm["also_checked"] = [
        check_int8_matmul(Q_BUCKETS[-1], Q_FFN, Q_HIDDEN, "bucket 512, FFN out"),
        check_int8_matmul(LN_ROWS, Q_HIDDEN, Q_FFN, "4096 rows, FFN in"),
        check_int8_matmul(LN_ROWS, Q_FFN, Q_HIDDEN, "4096 rows, FFN out"),
        check_int8_matmul(Q_BUCKETS[1], Q_HIDDEN, Q_FFN, "bucket 64, FFN in"),
        check_int8_matmul(Q_BUCKETS[1], Q_FFN, Q_HIDDEN, "bucket 64, FFN out"),
        check_int8_matmul(Q_BUCKETS[0], Q_HIDDEN, Q_FFN, "bucket 8, FFN in"),
        check_int8_matmul(Q_BUCKETS[0], Q_FFN, Q_HIDDEN, "bucket 8, FFN out"),
        check_int8_matmul(Q_BUCKETS[0], Q_HIDDEN, Q_CLASSES, "bucket 8, classifier"),
        check_int8_matmul(Q_BUCKETS[1], Q_HIDDEN, Q_CLASSES, "bucket 64, classifier",
                          timed=False),
        check_int8_matmul(Q_BUCKETS[2], Q_HIDDEN, Q_CLASSES, "bucket 512, classifier",
                          timed=False),
        check_int8_matmul(37, 70, 130, "ragged", timed=False),
        check_int8_matmul(300, 129, 257, "ragged", timed=False)]
    pool = check_pool_backward("relu")
    pool["also_checked"] = [check_pool_backward("distinct")]
    torch.cuda.empty_cache()
    return [mm, pool]


def _build_ffn_program(static, ops):
    x = static.data("x", [None, Q_HIDDEN], "float32")
    h = x
    for _ in range(Q_LAYERS):
        a = static.nn.fc(h, Q_FFN, activation="gelu")
        a = static.nn.fc(a, Q_HIDDEN)
        h = static.nn.layer_norm(ops.add(h, a))
    return x, static.nn.fc(h, Q_CLASSES)


def _forward_ms(exe, program, scope, fetch_names, label):
    """Device time of one forward per bucket, the rows already on the card
    (CUDA events around 20 forwards). Returns ``{bucket: ms}``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(23)
    out = {}
    for bucket in Q_BUCKETS:
        x = torch.randn(bucket, Q_HIDDEN, generator=g, device="cuda")
        out[bucket] = time_ms(lambda x: exe.run(program, feed={"x": x}, fetch_list=fetch_names,
                                                scope=scope, return_numpy=False), [(x,)], 20)
    log(f"{label} forward (ms a bucket): "
        + ", ".join(f"{b}: {ms:.3f}" for b, ms in out.items()))
    return out


# int8 serving limits, against the port's plain path on the CPU from the same
# directory. The accumulators are integers, so a row differs only by the
# float ops between the products (f32 rounding: Q_ROW_RTOL of the largest
# |logit|) unless that rounding sends one activation to the other side of a
# quantization boundary on the card; from there on the row's later
# activations round differently too, and the row moves by a share of the int8
# noise itself. Such rows are few, so at least Q_ROW_SHARE of all rows must
# be within Q_ROW_RTOL, and every row within Q_FLIP_RTOL. The limits sit
# between the sound reading and a control that they must catch: the same
# requests with the first product's activation scale off by 1%, which moves
# every row.
Q_ROW_RTOL, Q_ROW_SHARE, Q_FLIP_RTOL = 1e-5, 0.9, 0.05
# against the f32 program: the JAX package's documented int8 envelope
Q_F32_ENVELOPE = (0.05, 0.05)


def _make_int8_model(dirname, reqs):
    """Build the f32 program from a seed on the card, answer ``reqs`` with it,
    time it, calibrate, rewrite to int8 and save into ``dirname``. Returns
    (the f32 answers, the f32 forward's ms a bucket)."""
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import ops, slim, static

    rng = np.random.RandomState(30)
    calib = [{"x": rng.randn(Q_CALIB_ROWS, Q_HIDDEN).astype(np.float32)}
             for _ in range(Q_CALIB_BATCHES)]
    static.enable_static()
    static.reset_default_programs()
    try:
        ptt.seed(0)
        scope = static.Scope()
        _, y = _build_ffn_program(static, ops)
        exe = static.Executor()
        exe.run_startup(scope=scope)
        prog = static.default_main_program()
        muls = [op for op in prog.global_block().ops if op.type == "mul"]
        if len(muls) != Q_MULS:
            raise AssertionError(f"the program has {len(muls)} muls, not {Q_MULS}")
        weights = sum(scope.get(op.inputs["X"][1]).numel() for op in muls)
        refs = [exe.run(prog, feed={"x": r["x"].astype(np.float32)}, fetch_list=[y],
                        scope=scope)[0] for r in reqs]
        f32_ms = _forward_ms(exe, prog, scope, [y.name], "f32 program")
        t0 = time.perf_counter()
        ptq = slim.PostTrainingQuantization(exe, prog, calib, scope=scope)
        ptq.quantize()
        ptq.save_int8_model(dirname, ["x"], [y])
        log(f"int8 program: {Q_MULS} muls, {weights / 1e6:.1f} M weights; calibrated on "
            f"{Q_CALIB_BATCHES} x {Q_CALIB_ROWS} rows, rewritten and saved in "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        static.disable_static()
        static.reset_default_programs()
    del scope, exe, ptq
    torch.cuda.empty_cache()
    return refs, f32_ms


def _row_errors(got, want):
    """Each row's largest error over the answer's largest |entry|."""
    return np.abs(got - want).max(axis=1) / np.abs(want).max()


def _row_stats(errs):
    q = np.quantile(errs, [0.5, 0.9, 0.99])
    return (f"row errors median {q[0]:.3g}, 90% {q[1]:.3g}, 99% {q[2]:.3g}, max {errs.max():.3g}, "
            f"{(errs <= Q_ROW_RTOL).mean():.1%} of rows within {Q_ROW_RTOL}")


def serve_int8():
    """Make the int8 model directory, then serve it as a user would: from the
    directory alone. Returns kernel launches per name on the serving run."""
    import torch

    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.static.program import Program

    rng = np.random.RandomState(31)
    # three decimals: short JSON, and exactly the float32 values the server parses
    reqs = [{"x": np.round(rng.randn(rows, Q_HIDDEN), 3)} for rows in (8, 5, 64, 40, 512, 300)]
    with tempfile.TemporaryDirectory(prefix="ptt_int8_") as dirname:
        refs, f32_ms = _make_int8_model(dirname, reqs)
        pred = create_predictor(Config(dirname))
        cpu_pred = create_predictor(Config(dirname), device="cpu")
        meta = pred.quant_metadata()
    types = [op.type for op in pred._program.global_block().ops]
    if types.count("mul_int8") != Q_MULS or types.count("quantize_static") != Q_MULS \
            or "mul" in types or "quant_dequant_static" in types:
        raise AssertionError(f"the loaded program's ops are not the int8 rewrite's: {types}")
    if len(meta["int8_weights"]) != Q_MULS:
        raise AssertionError(f"{len(meta['int8_weights'])} int8 weights saved, not {Q_MULS}")
    for n in pred._scope.var_names():
        if pred._scope.get(n).device.type != "cuda":
            raise AssertionError(f"{n} lies on {pred._scope.get(n).device}, not on the card")
    for n in meta["int8_weights"]:
        if pred._scope.get(n).dtype != torch.int8 or pred._scope.has(n[:-len("@int8")]):
            raise AssertionError(f"{n}: not int8 in the scope, or a float copy lies beside it")
    int8_bytes = sum(pred._scope.get(n).numel() for n in meta["int8_weights"])
    log(f"loaded int8 program: {len(types)} ops, {Q_MULS} mul_int8, {int8_bytes / 1e6:.1f} MB of "
        f"int8 weights on the card, no float copy")

    answers, counts, forwards = _serve(pred, Q_BUCKETS, reqs, "int8 program")
    fetch = pred.get_output_names()[0]
    wants, row_errs = [], []
    for i, (req, ans, ref) in enumerate(zip(reqs, answers, refs)):
        a = req["x"].astype(np.float32)
        got = np.asarray(ans[1]["outputs"][fetch], np.float32)
        want = cpu_pred.run([a])[0]
        wants.append(want)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"int8 request {i}: shape {got.shape} vs {want.shape} or not "
                                 "finite")
        errs = _row_errors(got, want)
        row_errs.append(errs)
        e32 = float(np.abs(got - ref).max())
        env = Q_F32_ENVELOPE[0] * float(np.abs(ref).max()) + Q_F32_ENVELOPE[1]
        log(f"int8 request {i} ({len(a)} rows): vs the CPU's plain path {_row_stats(errs)} of the "
            f"largest |logit| {np.abs(want).max():.4g}; vs the f32 program {e32:.3g} (envelope "
            f"{env:.3g})")
        if e32 >= env:
            raise AssertionError(f"int8 request {i}: {e32} from the f32 program, outside the "
                                 f"envelope {env}")
    row_errs = np.concatenate(row_errs)
    share = float((row_errs <= Q_ROW_RTOL).mean())
    log(f"int8 answers vs the CPU's plain path over {len(row_errs)} rows: {_row_stats(row_errs)} "
        f"(limits: {Q_ROW_SHARE:.0%} of rows within {Q_ROW_RTOL}, every row within "
        f"{Q_FLIP_RTOL})")
    if share < Q_ROW_SHARE or row_errs.max() > Q_FLIP_RTOL:
        raise AssertionError(f"int8 answers vs the CPU: {share:.1%} of rows within {Q_ROW_RTOL}, "
                             f"worst row {row_errs.max()}")
    want = {name: (Q_MULS * forwards if name == "int8_matmul" else 0) for name in counts}
    if forwards <= 0 or counts != want:
        raise AssertionError(f"int8 launches {counts} over {forwards} forwards; want {want}")
    log(f"int8 program: {forwards} forwards, launches {counts}: {Q_MULS} int8 matmul kernels "
        "each")

    # control: the first product's activation scale off by 1%
    ctrl = Program.from_dict(pred._program.to_dict())
    first = next(op for op in ctrl.global_block().ops if op.type == "mul_int8")
    first.attrs["scale_x"] *= 1.01
    ctrl_errs = np.concatenate([
        _row_errors(pred._exe.run(ctrl, feed={"x": req["x"].astype(np.float32)},
                                  fetch_list=[fetch], scope=pred._scope)[0], want)
        for req, want in zip(reqs, wants)])
    ctrl_share = float((ctrl_errs <= Q_ROW_RTOL).mean())
    log(f"int8 control (the first mul_int8's scale_x off by 1%): {_row_stats(ctrl_errs)}")
    if not ctrl_share < Q_ROW_SHARE:
        raise AssertionError(f"int8 control: {ctrl_share:.1%} of rows within {Q_ROW_RTOL} passes "
                             f"the limit {Q_ROW_SHARE:.0%}: it cannot catch a scale 1% off")

    int8_ms = _forward_ms(pred._exe, pred._program, pred._scope, [fetch], "int8 program")
    log("forward device time, int8 beside f32 (ms): "
        + ", ".join(f"bucket {b}: {int8_ms[b]:.3f} / {f32_ms[b]:.3f}" for b in Q_BUCKETS))
    rng = np.random.RandomState(32)
    for bucket in (Q_BUCKETS[0], Q_BUCKETS[-1]):
        _profile_run(pred, [rng.randn(bucket, Q_HIDDEN).astype(np.float32)],
                     f"int8 Predictor.run bucket {bucket}")
    return counts


# the sources rewritten last, whose registers and spills the run logs
PTXAS_SOURCES = ("flash_attention", "flash_attention_bwd", "layernorm_residual_bwd",
                 "optimizer_update")


def start_ptxas(names=PTXAS_SOURCES):
    """One ``nvcc -Xptxas -v`` per source into a temporary directory,
    started at once (beside the build): returns (directory, processes)."""
    import os
    import subprocess

    from paddle_tpu_torch.ops.cuda import _build

    tmp = tempfile.mkdtemp(prefix="ptt_ptxas_")
    procs = [(n, subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(tmp, f"{n}.so"), os.path.join(_build.CSRC_DIR, f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)) for n in names]
    return tmp, procs


def finish_ptxas(tmp, procs):
    """Wait for :func:`start_ptxas`'s compilers and log each kernel's
    registers, spills and static shared memory. Returns ``{source:
    {kernel: {...}}}``."""
    import re
    import shutil
    import subprocess

    report = {}
    for name, proc in procs:
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -Xptxas -v failed for {name}.cu:\n{text}")
        if shutil.which("c++filt"):
            text = subprocess.run(["c++filt"], input=text, capture_output=True, text=True).stdout
        kernels, cur = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(.*)' for", line)
            if m:
                cur = m.group(1).replace("(anonymous namespace)::", "")
                cur = re.sub(r"\(.*", "", cur).removeprefix("void ")
                kernels[cur] = {}
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                kernels[cur].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                                    spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels[cur]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                kernels[cur]["static_smem"] = int(sm.group(1)) if sm else 0
        report[name] = kernels
        for kname, info in kernels.items():
            log(f"ptxas {name}.cu {kname}: {info}")
    shutil.rmtree(tmp, ignore_errors=True)
    return report


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
    ptxas = start_ptxas()
    _build.build_all()
    log(f"built {', '.join(_build.KERNEL_SOURCES)} in {time.perf_counter() - t0:.1f} s")
    registers = finish_ptxas(*ptxas)

    kernels = check_kernels() + check_resnet_kernels() + check_new_kernels()
    served = serve_bert()
    trained = train_bert()
    torch.cuda.empty_cache()
    rn_served = serve_resnet()
    q_served = serve_int8()
    torch.cuda.empty_cache()
    rn_trained = train_resnet()
    for k in kernels:
        name = k["name"]
        k["launches_serving"] = served[name] + rn_served[name] + q_served[name]
        k["launches_training"] = trained[name] + rn_trained[name]
        k["launches"] = k["launches_serving"] + k["launches_training"]
        src = k["source"].rsplit("/", 1)[-1][:-len(".cu")]
        if src in registers:
            k["ptxas"] = registers[src]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
