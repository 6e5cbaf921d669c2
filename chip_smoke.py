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
   seed) through ``Predictor`` -> ``InferenceServer`` with 2 replicas and
   wait for ``/healthz``: warmup must capture one CUDA graph a bucket
   (``runtime/compiled.py``), shared by the replicas;
5. POST requests of 1-4 rows, some padded, some concurrent; check every
   answer against the port's plain forward of the same weights on the CPU,
   that each forward launched 24 LayerNorm and 12 attention kernels, and
   that the requests captured nothing (``extra_compiles() == 0``, ``/statz``
   ``compiles``); then, as a control, run the same requests with TF32
   matmuls on and require the limits to catch them; then ``Predictor.run``
   captured against eager at every bucket (wall and device busy, the
   kernels a profiled replay ran equal to the booked launches), and 2 x 20
   concurrent replays of one bucket bit-equal to solo ones while a third
   thread captures a new shape (each served model does the same);
6. train BERT-base pretraining (MLM + NSP, AdamW lr 1e-4) through
   ``framework.jit.train_step``: one step at dropout 0, batch 2 x L=512,
   whose loss and every gradient must match the port's plain path on the
   CPU from the same weights (with a TF32 control the limits must catch);
   then steps at the bench's phase-2 shape (batch 32, L=512, 80 masked
   positions, dropout 0.1) on one fixed batch, whose losses must be finite
   and fall, each launching exactly 24 + 24 LayerNorm (forward, backward),
   12 attention forward, 12 dQ and 12 dK/dV kernels; step time, tokens/s
   and, from ``torch.profiler``, where one step's time goes;
6a. AMP: hold the bf16 kernels (the LayerNorm forward in bf16 and in its
   mixed instance, a bf16 x on an f32 residual, at [16384, 768], at H =
   1000 and 4096 and on rows of mean 100; its backward in bf16; the three
   bf16 attention kernels at [32, 12, 512, 64] with dropout 0.1 and a pad
   bias, at rate 0, at L = 128 causal and at other head dims, biases and
   ragged shapes) against their plain versions in bf16 ulps, timed beside
   bf16 SDPA and ``F.layer_norm``, with the forward's stored dropout mask equal to the plain
   mask bit for bit and the backward repeating its gradients bit for bit
   (the wgmma kernels' ``-Xptxas -v`` summaries are printed on stdout);
   then one BERT-base step under ``auto_cast`` (O1, and O2 through
   ``decorate``) at dropout 0, batch 2 x L=512, against the CPU's plain
   path under the same scope (the f32 step as the control the limit on
   differing gradient entries must catch); then bench's phase-2 step under
   ``auto_cast`` for 10 steps (losses finite and falling, the bf16
   attention and LayerNorm kernels launched, median step, tokens/s, peak
   memory) and a profiled step whose matrix products must all be bf16;
7. hold the ResNet path's kernels (fused conv + batch norm + relu, the
   momentum update) against their plain versions at ResNet-50's shapes
   (layer1's 3x3 conv at batch 128, with a one-pass TF32 control the conv
   limit must catch; the stem, a ragged shape, the serving batch 32, the
   33 products of a batch-1 and a batch-8 forward with their split-K calls
   counted, and all 161 parameters besides), timing each with its bound
   and a library call;
8. serve ResNet-50 (224 x 224, eval, f32, random weights from a seed)
   through ``Predictor`` -> ``InferenceServer`` at buckets 1, 8 and 32,
   check every answer against the port's plain forward on the CPU and that
   each forward launched 33 fused eval kernels, with a TF32 control, and
   the compiled-serving checks of step 5;
9. train ResNet-50 with Momentum through ``framework.jit.train_step``: one
   step at batch 2 against the CPU's plain path (loss, gradients, running
   statistics; TF32 control), then 4 steps at bench.py's shape (batch
   128, lr 0.1, momentum 0.9, one fixed batch) whose losses must be finite
   and fall below the first, each launching exactly 33 of each training
   conv kernel and 2 momentum kernels that update all 161 parameters;
10. hold the int8 matmul kernel against a float64 product of the same int8
    values (bit-equal) at the int8 serving path's shapes and two ragged
    ones, its split-K calls counted against the plan (which the C side must
    make alike), and the 25 products of one served forward at buckets 8, 64
    and 512 in a row; and the max-pool backward kernel against its plain
    version (bit-equal) at ResNet-50's stem, on a relu'd input full of ties,
    on distinct values and in the stem's own channels-last layout (with the
    whole autograd backward timed flag on and off); time each in device
    time behind a sleep kernel with its bound and a library call;
11. build the 12-layer 768/3072 feed-forward program (BERT-base's ``mul``s)
    as a static program from a seed, run it in f32, calibrate it, rewrite it
    to int8 and save it; serve the saved directory through
    ``create_predictor(Config(dir))`` -> ``InferenceServer`` at buckets 8, 64
    and 512; check every answer against the port's plain path on the CPU
    from the same directory (with a control, one scale off by 1%, that the
    limit must catch) and against the f32 program within the documented int8
    envelope, and that each forward launched 25 int8 matmul kernels; the
    compiled-serving checks of step 5, through the static executor's graphs,
    and a bias replaced through ``Scope.set`` showing in the next answer;
12. train ResNet-50 again with ``FLAGS_use_pallas_pool_bwd`` on, the main
    run: the parity step, then 10 steps that also launch the max-pool
    backward kernel once each; step time and images/s beside the flag-off
    run's, peak memory and a profiled step;
12a. ResNet-50 under AMP (``auto_cast``, O1), with the bf16 kernels held
    in step 3 against their plain versions (rows 8-13 in bf16 from
    ``conv_bn_relu_mm_bf16.cu`` and the bf16 instances of
    ``conv_bn_relu_bn.cu``, and the bf16 max-pool backward, bit-equal, at
    ResNet-50's shapes, the stem with K padded to 152, ragged shapes and the
    serving products with split-K, each timed beside bf16 ``torch.matmul``,
    ``torch.var`` or torch's pool backward): one O1 step at batch 2 against
    the CPU's plain path (the f32 step the control the limits must catch),
    then bench.py's step under ``auto_cast`` with the pool kernel on, 10
    steps at batch 128 whose losses must be finite and fall below the first,
    each launching every training conv kernel 33 times in bf16 and never in
    float32 and the bf16 pool backward once; the median step, images/s, peak
    memory and a profiled step in which no fused conv product runs outside
    the bf16 kernel; then one eval forward under ``auto_cast`` at batch 32
    (33 bf16 eval kernels) against the CPU's plain path;
12b. the compiled step (``train_step(jit=True)``, ``eval_step``: CUDA graphs
    through ``runtime/compiled.py``): bench's BERT-base AMP step and
    ResNet-50 AMP step, each first held from one state over 3 calls (the
    eager first step and 2 replays) against the same calls run eagerly,
    bit for bit wherever an eager control repeats itself bit for bit, with
    BERT's dropout masks and attention seeds equal to the eager step's and
    different between replays, a replay at lr 0 leaving every weight
    bit-identical and one at the lr moving them; then the eager
    (``jit=False``) and the captured step side by side from the same
    weights, 10 steps each (median, host clock, device busy, peak memory,
    launches a step, which must be equal); ``eval_step`` of ResNet-50 under
    AMP at batch 1 and 8 (captured logits bit-equal to eager, wall against
    busy); the refusals: a capture that cannot be made raises and no
    step runs eagerly in its place, and ``GradScaler`` raises inside a
    compiled step; and AdamW's bias correction on the card bit-equal to the
    CPU's at every t up to 10,000;
12c. Transformer-base seq2seq (37,000-token vocabulary, 512 wide, 6 + 6
    layers; ``models.TransformerSeq2Seq``) under ``auto_cast`` (O1): after
    rows 1, 1b, 2 and 2b are held at its LayerNorm shape [4096, 512] in
    step 3 (f32, bf16 and mixed, forward and backward, timed), one f32
    teacher-forced forward at batch 2 against the CPU's (TF32 control) and
    one AMP step against the CPU's plain path (the f32 step the control);
    then 10 eager and 10 captured steps (``train_step(jit=True)``) at 64
    pairs x 64 + 64 tokens, Adam(0.9, 0.98, 1e-9) under
    ``NoamDecay(512, 4000)`` (taken up at step 1000) with
    ``ClipGradByGlobalNorm(1.0)``, the pad-masked cross entropy, each
    launching the 30 residual LayerNorms forward and backward exactly (the
    first of each stack mixed), each step's lr the schedule's (on the card
    the float32 the step wrote before its replay) with one capture;
    medians, target tokens/s, busy share, device time by kind, peak memory;
12d. greedy decoding (16 sources to 32 tokens) and beam search (beam 4, 4
    sources) of seeded Transformer-base weights in f32 eval: tokens and
    beam steps equal to the CPU's up to the first position whose CPU
    top-two margin is under a limit, 12 + 18 LayerNorms a decode step, ms a
    step and a token;
12e. ERNIE-base (``ernie_base_config()``, flash on) pretrained under
    ``auto_cast`` at bench's phase-2 shape with ``knowledge_masking``'s
    spans: 10 eager and 10 captured steps with the bf16 attention and
    LayerNorm kernels' launches exact;
12f. ``BASELINE.json``'s first config: the MNIST LeNet-5 built as a static
    program (``nets.simple_img_conv_pool`` twice, ``static.nn.fc`` x 3,
    ``softmax_with_cross_entropy``, ``mean``, ``accuracy``) and trained by
    ``static.optimizer.SGD`` through ``append_backward`` on synthetic MNIST
    at batch 64 with ``FLAGS_use_pallas_pool_bwd`` on: after the max-pool
    backward kernel is held at LeNet's two pool shapes in step 10 (rows
    16e/16f), 200 steps through the executor's graph: one capture, two
    pool-backward launches a step, the first 5 losses against the CPU
    interpreter from the same startup weights (a control at lr 0 must
    fail), accuracy on a held-out batch above a bar, a replay at lr 0 (the
    lr written in place into the scope, as ``set_lr`` does) moving no
    parameter and one at the lr moving all, with no new capture; step ms
    captured against eager, images/s, and the forward alone (what each
    grad op's re-run of its forward costs);
12g. BERT-base pretraining under ``Lamb`` (lr 1e-4, decay 0.01, LayerNorm
    weights and biases excluded) at bench's phase 2 under ``auto_cast``
    (O1): its first step at batch 1 at dropout 0, and the loss after it,
    against the CPU's plain path (the f32 step the control the loss limit
    must catch); then the
    captured step, an ``ExponentialMovingAverage(decay=0.999)`` updated
    after each step, a checkpoint saved after step 3 (capture ms on the
    step's thread, write seconds and bytes), 10 timed steps launching rows
    1b, 2b, 3b, 6b and 7b exactly, ``ema.apply()`` keeping every
    parameter's storage; the checked step (``FLAGS_check_nan_inf``, its own
    graph) timed, then a NaN planted in an embedding row the batch reads:
    ``FatalError`` naming the op, every parameter and moment bit-equal
    after; the checkpoint restored into a fresh model and step: every leaf
    bit-equal, no new capture, and the next loss, with the dropout
    generator reseeded alike, bit-equal to the uninterrupted run's;
12h. the dygraph LeNet at batch 64 on synthetic MNIST with the pool kernel
    on: 20 captured steps under each of Adagrad, Adadelta, RMSProp
    (centered, momentum 0.9), Adamax and Lookahead(Momentum) (whose update
    launches the momentum kernel), one graph each, each held against the
    same steps on the CPU (a half-lr control must fail), ``ModelAverage``
    applied after the Lookahead run for the held-out accuracy; the step's
    device time under each;
12i. GPT-2 small at full width (``GPTConfig()``: 12 layers, 768 wide, 12
    heads, 1024 positions, 50,304 tokens; 124,475,904 parameters from a
    seed, eval, f32) through ``generation.GenerationEngine`` (16 slots, a
    ring KV cache of 1024, prefill buckets 64-512: a CUDA graph each and one
    decode graph) and ``serving.GenerationServer``: 4 prompts (17-500
    tokens) decoded 64 greedy tokens, every step's logits against the
    card's uncached forward over the generated sequence (3e-5 of the
    largest; TF32 the control) and the tokens against its argmax where the
    top-two gap is above 1e-3 (a mask blind to each query's own position
    the control), one forward against the CPU's; a ring of 128 decoded
    past its wrap against the forward under a window of 128 (129 the
    control); graphs == buckets + 1 and no capture after; each bucket's
    prefill and 3 decode steps replayed == eager bit for bit, timed both
    ways with a profiled replay and the decode step's bound; 4,096 draws at
    top-k 50 by a chi-square test; then 32 concurrent HTTP requests (4
    streamed) on 16 slots, 8 of them equal to solo runs, ``/statz`` with no
    unexpected capture, tokens/s and inter-token times; none of the port's
    kernels runs on this path (pre-norm, cached: plain PyTorch, as the JAX
    package's);
13. print the card line, then one JSON line with every kernel's numbers;
14. print ``{"ok": true, "device": {...}}`` as the last line.

Exits non-zero with no result when CUDA is absent or the package is not
beside this script.
"""
from __future__ import annotations

import contextlib
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


def check_layernorm(dtype_name, rows, h=LN_H, res_dtype_name=None, mean_offset=0.0, std=1.0,
                    timed=True):
    """The forward kernel at [rows, h] against the plain version: y, and
    the saved f32 mean and rstd the backward reads. ``res_dtype_name``
    float32 under a bf16 x is the mixed instance; ``mean_offset`` and
    ``std`` shape the rows (a large mean tests the two-pass variance);
    which variant runs (a warp a row, a block a row) follows ``h``."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import layernorm_residual as lnr

    dtype = getattr(torch, dtype_name)
    rdtype = getattr(torch, res_dtype_name or dtype_name)
    mixed = rdtype != dtype
    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"
    w = torch.randn(h, generator=g, device=dev)
    b = torch.randn(h, generator=g, device=dev)
    sets = [((torch.randn(rows, h, generator=g, device=dev) * std + mean_offset).to(dtype),
             (torch.randn(rows, h, generator=g, device=dev) * std).to(rdtype), w, b, 1e-5)
            for _ in range(6 if timed else 1)]
    x, r = sets[0][0], sets[0][1]
    counter = ("MIXED_LAUNCHES" if mixed else "LAUNCHES" if dtype == torch.float32
               else "BF16_LAUNCHES")
    before = getattr(lnr, counter)
    y, mean, rstd = lnr.layernorm_residual_fwd(x, r, w, b, 1e-5)
    if getattr(lnr, counter) != before + 1 or y.dtype != dtype:
        raise AssertionError(f"layernorm_residual {dtype_name} on {rdtype}: {y.dtype}, the "
                             f"{counter} kernel not counted")
    yp, mp, rp = lnr._reference(x, r, w, b, 1e-5)
    err = float((y.float() - yp.float()).abs().max())
    # mean absolute, rstd relative to its largest entry (~1/std of a row)
    stat_err = max(float((mean - mp).abs().max()), float((rstd - rp).abs().max() / rp.abs().max()))
    ulps = {}
    # the mean's atol scales with it (f32 sums of values near mean_offset)
    mean_tol = LN_F32_ATOL * max(1.0, mean_offset)
    if dtype == torch.float32 and mean_offset:
        # rows far from 0: y carries the f32 rounding of the sum (an ulp of
        # the mean times rstd) in both; the kernel may be at most LN_F32_ATOL
        # further from the exact (f64) answer than the plain version is
        y64, _ = exact_bf16_layernorm(x, r, w, b, 1e-5)
        ulps = {"kernel_vs_exact": float((y.double() - y64).abs().max()),
                "plain_vs_exact": float((yp.double() - y64).abs().max())}
        ok = (ulps["kernel_vs_exact"] <= ulps["plain_vs_exact"] + LN_F32_ATOL
              and stat_err <= mean_tol)
        tol = (f"kernel within plain + {LN_F32_ATOL} of the exact (f64) answer, mean atol "
               f"{mean_tol}; " + ", ".join(f"{k} {v:.3g}" for k, v in ulps.items()))
    elif dtype == torch.float32:
        ok = err <= LN_F32_ATOL and stat_err <= LN_F32_ATOL
        tol = f"y, mean atol {LN_F32_ATOL}, rstd rtol {LN_F32_ATOL}"
    else:
        # both add x + res alike (bf16: rounded to bf16; mixed: in f32) and
        # differ in the f32 order of the statistics and the affine; the
        # kernel may be at most one output ulp further from the exact answer
        # than the plain version is
        y64, ulp = exact_bf16_layernorm(x, r, w, b, 1e-5)
        ulps = {"kernel_vs_exact_ulps": float(((y.double() - y64).abs() / ulp).max()),
                "plain_vs_exact_ulps": float(((yp.double() - y64).abs() / ulp).max()),
                "kernel_vs_plain_ulps": float(((y.double() - yp.double()).abs() / ulp).max())}
        ok = (ulps["kernel_vs_exact_ulps"] <= ulps["plain_vs_exact_ulps"] + 1.0
              and stat_err <= mean_tol)
        tol = ("kernel within plain + 1 bf16 ulp of the exact (f64) answer, ulps of the largest "
               "affine term; " + ", ".join(f"{k} {v:.3f}" for k, v in ulps.items()))
    if not ok:
        raise AssertionError(f"layernorm_residual {dtype_name} on {rdtype} [{rows}, {h}], mean "
                             f"{mean_offset}: max err {err} stats {stat_err} beyond {tol}")
    variant = lnr._fwd_plan(h, dtype)
    # x and y in x's type, the residual in its own, read and written once
    t_b, by = bound(rows * h * (2 * x.element_size() + r.element_size()) + 8 * rows + 8 * h,
                    9 * rows * h)
    name = "layernorm_residual_fwd" + ("_mixed" if mixed else "" if dtype == torch.float32
                                       else "_bf16")
    entry = {"name": name, "route": "cuda", "source": "paddle_tpu_torch/csrc/layernorm_residual.cu",
             "replaces": "paddle_tpu/ops/pallas/layernorm_residual.py:188",
             "shape": [rows, h], "dtype": dtype_name, "residual_dtype": str(rdtype)[6:],
             "variant": variant, "mean_offset": mean_offset, "std": std, "max_abs_err": err,
             "stats_err": stat_err, "tolerance": tol, **ulps, "bound_ms": t_b, "bound_by": by}
    note = ""
    if timed:
        # device time behind a sleep kernel: at these sizes the wrapper's host
        # work would pace CUDA events around a loop of calls
        ms = device_ms_sets(lnr.layernorm_residual_fwd, sets, 50)[0]
        plain_ms = device_ms_sets(lnr._reference, sets, 20)[0]
        # one PyTorch call chain of the same function: the add (promoted
        # for the mixed case), F.layer_norm, the output in x's type
        lib_ms = device_ms_sets(lambda x, r, w, b, eps: F.layer_norm(
            x + r, (h,), w.to(r.dtype), b.to(r.dtype), eps).to(x.dtype), sets, 50)[0]
        entry.update(ms=ms, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     library="F.layer_norm(x + res) in the sum's type, cast to x's",
                     timing="device time behind a sleep kernel, inputs cycled past L2")
        note = (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                f"{t_b:.4f} ms ({by})")
    log(f"layernorm_residual {dtype_name} on {rdtype} [{rows}, {h}] ({variant} variant, mean "
        f"{mean_offset}, std {std}): max err {err:.3g}, stats {stat_err:.3g} ({tol}){note}")
    return entry


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
    entry = {"name": "layernorm_residual_bwd" + ("" if dtype == torch.float32 else "_bf16"),
             "route": "cuda",
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
    # device time behind a sleep kernel: at [4096, 512] the wrapper's host
    # work would pace CUDA events around a loop of calls
    ms = device_ms_sets(lnr.layernorm_residual_bwd, sets, 100)[0]

    def whole(*args):  # what the autograd Function runs: the kernel, then the two sums
        _, dwp_, dbp_ = lnr.layernorm_residual_bwd(*args)
        return dwp_.sum(0), dbp_.sum(0)

    whole_ms = device_ms_sets(whole, sets, 100)[0]
    plain_ms = device_ms_sets(lnr._reference_bwd, sets, 100)[0]
    graphs = []
    for x_, r_, w_, _, _, dy_ in sets:
        ins = [t.detach().requires_grad_() for t in (x_, r_, w_, b)]
        y = F.layer_norm(ins[0] + ins[1], (h,), ins[2].to(dtype), ins[3].to(dtype), eps)
        graphs.append((y, ins, dy_))
    lib_ms = device_ms_sets(lambda y, ins, dy_: torch.autograd.grad(y, ins, dy_,
                                                                    retain_graph=True),
                            graphs, 100)[0]
    log(f"{label}: da err {err:.3g}, dw {dw_err:.3g}, db {db_err:.3g} ({tol}); a second run "
        f"equal bit for bit; kernel {ms:.4f} ms (with the two partial sums {whole_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {t_b:.4f} ms ({by})")
    entry.update(ms=ms, kernel_ms=ms, whole_backward_ms=whole_ms, plain_ms=plain_ms,
                 bound_ms=t_b, bound_by=by, library_ms=lib_ms,
                 timing="device time behind a sleep kernel, inputs cycled")
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
    """One entry per f32 kernel of the serving and training paths (the bf16
    ones: ``check_amp_kernels``). The
    LayerNorm kernels and the attention backward stand at the shape and
    dtype the training path gives them (f32, batch 32 x L=512), the
    attention forward at the serving shape, as before. The other shapes and
    options checked ride along under ``also_checked``, without launch
    counts: the LayerNorm forward at the serving shape and in bf16; its
    backward at a ragged [12345, 1024] in f32 and bf16 and
    at [37, 4100], a width the row variant does not take (untimed); the
    attention forward at the training shape with dropout and at L=128
    (where the TPU took its small variant), the dropout masks, at D = 32
    and 128 and at ragged causal shapes with Lq != Lk (untimed), and
    against the unfused attention at L = 128-512 (timed); the attention
    backward at rate 0 and causal at L=128 (timed), at D = 32 and 128 and at
    ragged causal shapes with Lq != Lk (untimed)."""
    ln = check_layernorm("float32", TRAIN_ROWS)
    ln["also_checked"] = [check_layernorm("float32", LN_ROWS),
                          check_layernorm("bfloat16", LN_ROWS)] + [
        check_layernorm("float32", LN_ROWS, h, timed=False) for h in (1000, 4096)] + [
        check_layernorm("float32", LN_ROWS, mean_offset=100.0, std=0.1, timed=False)]
    ln_bwd = check_layernorm_bwd("float32")
    ln_bwd["also_checked"] = [check_layernorm_bwd("float32", 12345, 1024, timed=False),
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
                 "flash_attention_fwd_bf16", "flash_attention_bwd_dq_bf16",
                 "flash_attention_bwd_dkv_bf16", "layernorm_residual_fwd",
                 "layernorm_residual_bwd", "conv_mm", "conv_mm_bf16", "bn_reduce",
                 "bn_elementwise", "momentum", "int8_mm", "pool_bwd")
# templates that take both dtypes: their bf16 instances count apart
_TEMPLATE_KINDS = ("layernorm_residual_fwd", "layernorm_residual_bwd", "bn_reduce",
                   "bn_elementwise", "pool_bwd")


def _kernel_kind(name):
    n = name.lower().replace("_row_kernel", "_kernel")  # the LayerNorm backward's row variant
    n = n.replace("conv_mm_reduce_kernel", "conv_mm_kernel")  # split-K's second pass
    n = n.replace("pool_bwd_nchw_kernel", "pool_bwd_kernel").replace("pool_bwd_nhwc_kernel",
                                                                      "pool_bwd_kernel")
    for kind in _KERNEL_KINDS:
        if f"{kind}_kernel" in n:
            if kind not in _TEMPLATE_KINDS or "bfloat16" not in n:
                return kind
            # the LayerNorm forward's mixed instance: a bf16 x on an f32 residual
            mixed = kind == "layernorm_residual_fwd" and "bfloat16, float" in n
            return kind + ("_mixed" if mixed else "_bf16")
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    if "im2col" in n or "col2im" in n:
        return "im2col/col2im"
    if "conv" in n or "cudnn" in n or "implicit" in n or "wgrad" in n or "dgrad" in n:
        return "cudnn conv"
    if "gemm" in n or "cutlass" in n or "xmma" in n or n.startswith("nvjet"):
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


SERVE_REPLICAS = 2  # worker threads of every served model, sharing one graph per bucket


def _serve(pred, buckets, reqs, label):
    """Serve ``pred`` behind ``InferenceServer`` with ``SERVE_REPLICAS``
    workers on ``buckets``, wait for ``/healthz``, POST ``reqs`` (feeds by
    input name): the first two alone, the rest at once. Warmup must capture
    each bucket once (the store's misses equal the buckets, whatever the
    replica count) and the requests none (``extra_compiles() == 0``,
    ``/statz`` ``compiles``). Returns (answers, kernel launches over the
    requests, forwards run for them, readings); the server is drained and
    stopped."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import InferenceServer

    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    srv = InferenceServer(pred, port=0, replicas=SERVE_REPLICAS, buckets=buckets,
                          batch_timeout_ms=5.0)
    t0 = time.perf_counter()
    srv.start()
    answers = [None] * len(reqs)
    try:
        status, health = _http(srv.url + "/healthz")
        if status != 200:
            raise AssertionError(f"/healthz answered {status}: {health}")
        reserved = torch.cuda.memory_reserved()
        readings = {"replicas": SERVE_REPLICAS, "graphs": len(pred.store),
                    "misses_after_warmup": pred.store.misses,
                    "reserved_before_warmup_mib": reserved0 / 2**20,
                    "reserved_after_warmup_mib": reserved / 2**20}
        log(f"{label} server ready at {srv.url} after {time.perf_counter() - t0:.1f} s "
            f"(warmup over buckets {buckets}, {SERVE_REPLICAS} replicas): {readings}")
        if pred.store.misses != len(buckets) or len(pred.store) != len(buckets):
            raise AssertionError(f"{label}: warmup captured {pred.store.misses} graphs "
                                 f"({len(pred.store)} stored) for {len(buckets)} buckets")
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
        compiles = _http(srv.url + "/statz")[1]["compiles"]
    finally:
        srv.stop(drain=True)
    if srv.pool.alive:
        raise AssertionError(f"{label}: replica workers still alive after drain")
    for i, ans in enumerate(answers):
        if ans is None or ans[0] != 200:
            raise AssertionError(f"{label} request {i} failed: {ans and ans[0]} "
                                 f"{ans and str(ans[1])[:300]}")
    readings.update(misses_after_requests=pred.store.misses, hits=pred.store.hits,
                    extra_compiles=srv.pool.extra_compiles(), statz_compiles=compiles)
    log(f"{label}: after {len(reqs)} requests in {forwards} batches: {readings}")
    if (pred.store.misses != len(buckets) or readings["extra_compiles"]
            or compiles != {"buckets": len(buckets), "unexpected": 0}):
        raise AssertionError(f"{label}: the requests captured graphs after warmup: {readings}")
    return answers, counts, forwards, readings


PROFILE_ATTEMPTS = 3


def _profile_run(fn, feed, label):
    """One call of ``fn(feed)`` (a ``Predictor.run``, host inputs and outputs
    included, or its eager counterpart) under ``torch.profiler``: the port's
    kernels the profile saw run must equal the launches booked over the
    call. The tracer now and then misses a few of the first kernels of a
    profile (1 of ~25 profiled forwards on the H100), so a profile that
    parts from the booking is taken again, up to ``PROFILE_ATTEMPTS`` times;
    a graph that dropped or repeated a launch parts every time. Logs kernel
    time by kind and the top kernels; returns (wall ms, device busy ms,
    device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    fn(feed)
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(feed)  # ends in a copy to the host, so the device is done
            wall_ms = (time.perf_counter() - t0) * 1e3
        try:
            _check_profiled_launches(prof, launch_counts(), label)
            break
        except AssertionError as e:
            if attempt == PROFILE_ATTEMPTS:
                raise
            log(f"{label}: profile {attempt} of {PROFILE_ATTEMPTS} parts from the booking, "
                f"taken again: {e}")
    return _log_profile(prof, wall_ms, label)


def _log_profile(prof, wall_ms, label, top=6):
    by_kind, events = _device_time_by_kind(prof)
    busy = sum(by_kind.values())
    log(f"{label}: {wall_ms:.3f} ms wall, device busy {busy:.3f} ms ({busy / wall_ms:.1%}) in "
        f"{events} device events; by kind (ms): "
        + ", ".join(f"{k} {v:.3f} ({v / busy:.1%})" for k, v in
                    sorted(by_kind.items(), key=lambda kv: -kv[1])))
    log(f"{label}, top kernels (name, ms, calls): "
        + "; ".join(f"{n} {t:.3f} {c}" for n, t, c in _top_kernels(prof, top)))
    return wall_ms, busy, events


SERVE_TIMED_RUNS = 10  # Predictor.run calls a side and a bucket for the mean wall


def _captured_vs_eager(pred, feeds, eager, label):
    """``Predictor.run`` (a replayed graph) against ``eager`` (the same
    forward run op by op from the same host inputs to the same host
    outputs) at each bucket of ``feeds`` ({bucket: host feed}): the mean
    wall of ``SERVE_TIMED_RUNS`` calls (host clock; each call ends in a copy
    to the host) and the device busy time of a profiled call, side by side.
    The two answers are logged against each other. Returns the readings by
    bucket."""
    out = {}
    for bucket, feed in feeds.items():
        r = {}
        for side, fn in (("eager", eager), ("captured", pred.run)):
            ans = fn(feed)
            t0 = time.perf_counter()
            for _ in range(SERVE_TIMED_RUNS):
                fn(feed)
            wall = (time.perf_counter() - t0) * 1e3 / SERVE_TIMED_RUNS
            _, busy, events = _profile_run(fn, feed, f"{label} {side} bucket {bucket}")
            r[side] = {"wall_ms": wall, "busy_ms": busy, "device_events": events}
            r[f"{side}_answer"] = ans
        diff = max(float(np.abs(a - b).max()) for a, b in zip(r.pop("eager_answer"),
                                                               r.pop("captured_answer")))
        r["max_abs_diff"] = diff
        out[bucket] = r
        e, c = r["eager"], r["captured"]
        log(f"{label} bucket {bucket}: Predictor.run wall eager {e['wall_ms']:.3f} ms, captured "
            f"{c['wall_ms']:.3f} ms; device busy eager {e['busy_ms']:.3f} ms, captured "
            f"{c['busy_ms']:.3f} ms; answers apart by {diff:.3g}")
    return out


CONCURRENT_RUNS = 20  # runs of each of two threads replaying one bucket


def _concurrent_replays(pred, make_feed, bucket, off_ladder, label):
    """Two clones of ``pred`` replay one ``bucket`` in two threads,
    ``CONCURRENT_RUNS`` distinct inputs each, while a third thread captures
    a new shape (``off_ladder`` rows) under that traffic: every concurrent
    answer must be bit-equal to its input's answer replayed alone, and the
    capture must neither fail nor spoil a replay. Returns the readings."""
    feeds = [[make_feed(bucket, 1000 * t + i) for i in range(CONCURRENT_RUNS)] for t in range(2)]
    solo = [[pred.run(f) for f in per] for per in feeds]
    got = [[None] * CONCURRENT_RUNS for _ in range(2)]
    errors, started = [], threading.Event()
    captured = {}
    misses0 = pred.store.misses

    def replay(t, clone):
        try:
            for i, f in enumerate(feeds[t]):
                got[t][i] = clone.run(f)
                if i == 1:
                    started.set()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def capture(clone):
        try:
            started.wait(60)
            captured["answer"] = clone.run(make_feed(off_ladder, 99))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=replay, args=(t, pred.clone())) for t in range(2)]
    threads.append(threading.Thread(target=capture, args=(pred.clone(),)))
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"{label}: concurrent replays failed: {errors!r}")
    same = sum(all(np.array_equal(a, b) for a, b in zip(got[t][i], solo[t][i]))
               for t in range(2) for i in range(CONCURRENT_RUNS))
    again = pred.run(make_feed(off_ladder, 99))
    cap_diff = max(float(np.abs(a - b).max()) for a, b in zip(captured["answer"], again))
    r = {"bucket": bucket, "runs": 2 * CONCURRENT_RUNS, "bit_equal_to_solo": same,
         "captured_under_traffic": pred.store.misses - misses0, "off_ladder_rows": off_ladder,
         "capture_vs_its_replay": cap_diff}
    log(f"{label}: concurrent replays {r}")
    if same != 2 * CONCURRENT_RUNS or r["captured_under_traffic"] != 1 or \
            not all(np.isfinite(a).all() for a in captured["answer"]):
        raise AssertionError(f"{label}: concurrent replays part from solo ones: {r}")
    return r


def profile_forward(pred, seq_len):
    """Time of one BERT forward per bucket (inputs already on the card,
    CUDA events around 20 forwards of the module, eagerly), then
    ``Predictor.run`` captured against eager at every bucket
    (:func:`_captured_vs_eager`). Returns the latter's readings."""
    import torch

    rng = np.random.RandomState(5)
    for bucket in BUCKETS:
        ids = torch.from_numpy(rng.randint(1, 1000, (bucket, seq_len))).cuda()
        types = torch.zeros_like(ids)
        with torch.inference_mode():
            ms = time_ms(pred.module, [(ids, types)] * 3, 20)
        log(f"forward bucket {bucket} ({bucket * seq_len} tokens): {ms:.3f} ms, "
            f"{bucket * seq_len / ms * 1e3:.0f} tokens/s")
    feeds = {b: [rng.randint(1, 1000, (b, seq_len)).astype(np.int64),
                 np.zeros((b, seq_len), np.int64)] for b in BUCKETS}
    return _captured_vs_eager(pred, feeds, _eager_module_run(pred), "BERT-base")


def _eager_module_run(pred):
    """``pred.run``'s eager counterpart: the module op by op on the host
    feeds moved to the card, its outputs copied to the host."""
    import torch

    def run(feed):
        with torch.no_grad():
            outs = pred.module(*[torch.from_numpy(a).cuda() for a in feed])
        outs = (outs,) if isinstance(outs, torch.Tensor) else outs
        return [o.cpu().numpy() for o in outs]

    return run


def _bert_feed(bucket, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 1000, (bucket, SEQ_LEN)).astype(np.int64),
            np.zeros((bucket, SEQ_LEN), np.int64)]


def serve_bert():
    """Phases 4-5. Returns (kernel launches per name on the serving run,
    readings)."""
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
    answers, counts, forwards, readings = _serve(pred, BUCKETS, reqs, "BERT-base")
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
    readings["by_bucket"] = profile_forward(pred, SEQ_LEN)
    readings["concurrent"] = _concurrent_replays(pred, _bert_feed, 2, 3, "BERT-base")
    return counts, readings


def tf32_control(pred, reqs, wants):
    """The same requests through ``Predictor.run`` with TF32 matmuls on (the
    precision the predictor switches off), against the same CPU answers:
    the serving limits must catch that blur. The TF32 setting keys new
    graphs, so these runs capture anew and do not replay the f32 ones."""
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


def _step_of(model, loss_fn, device=None, jit=False):
    """bench.py's BERT step: AdamW lr 1e-4. ``jit=False`` (the eager step)
    unless the caller asks for the compiled one."""
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.optimizer import AdamW

    return train_step(model, AdamW(learning_rate=1e-4, parameters=model.parameters()), loss_fn,
                      device=device, jit=jit)


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
    busy share, kernel time by kind and the top kernels. Returns the
    profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    _log_profile(prof, wall, label, top=10)
    return prof


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


# -- AMP: bf16 kernels, the AMP step against the CPU, BERT trained under auto_cast --

BF16_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores (H100 SXM data sheet)
# the bf16 attention kernels against their plain versions, in bf16 ulps of
# the largest output: both round P (or dS) to bf16 at the TPU kernels'
# points and sum in f32 in other orders (read 0.06-1 on the H100)
FLASH_BF16_ULPS = 2.0
# the residual LayerNorm's mixed case through the op (bf16 x, f32 residual;
# the mixed forward, the f32 backward) against the plain version: the output and dx in bf16
# ulps of their largest entry, the residual's f32 gradient relative to its
# largest entry
LN_MIXED_ULPS, LN_MIXED_RTOL = 1.0, 1e-5
_FLASH_SRC_BF16 = "paddle_tpu_torch/csrc/flash_attention_bf16.cu"
_FLASH_BWD_SRC_BF16 = "paddle_tpu_torch/csrc/flash_attention_bwd_bf16.cu"
_FA = "paddle_tpu/ops/pallas/flash_attention.py"


def bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of the largest |want|."""
    return float((got.float() - want.float()).abs().max() / bf16_ulp(want.float().abs().max()))


def check_flash_bf16(batch, seq, rate, causal, replaces, lk=None, d=FLASH_D, timed=True,
                     bias_kind="pad"):
    """The three bf16 attention kernels at [batch, 12, seq, d] (keys ``lk``,
    default ``seq``) with a bf16 pad bias (the mask in q's dtype, as under
    AMP; ``bias_kind`` "full" takes a random f32 [B, H, Lq, Lk] bias read per
    entry, "none" none), through the route autograd takes: the forward
    storing its dropout mask, the dQ kernel computing delta, the dK/dV kernel
    after it, both reading the stored mask. Against the plain versions with
    the same seed: the output and each gradient within ``FLASH_BF16_ULPS``
    bf16 ulps of the largest entry, lse within ``FLASH_ATOL``. Bit for bit:
    the stored mask against ``dropout_keep_mask`` (the entries the rows can
    see) and the backward against a second run of itself. Timed, all in
    device time behind a sleep kernel: each kernel as the route runs it,
    the whole backward, the plain forward and backward, and bf16 SDPA
    forward and backward (the same mask and dropout rate, its own dropout
    mask) as the library, its backward read three times (median and
    range). Returns the forward's, the dQ and the dK/dV entries."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    lk = seq if lk is None else lk
    g = torch.Generator(device="cuda").manual_seed(11)
    shape, kshape = (batch, FLASH_H, seq, d), (batch, FLASH_H, lk, d)
    scale = d ** -0.5

    def make():
        q, do = (torch.randn(shape, generator=g, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(kshape, generator=g, device="cuda").bfloat16() for _ in range(2))
        bias = {"pad": lambda: _pad_bias(g, batch, lk).bfloat16(), "none": lambda: None,
                "full": lambda: torch.randn(batch, FLASH_H, seq, lk, generator=g,
                                            device="cuda")}[bias_kind]()
        seed = fa._draw_seed(g, "cuda") if rate else None
        return q, k, v, bias, do, seed

    def fwd(q, k, v, bias, do, seed):
        """(out, lse, the mask the forward stored or None)"""
        res = fa.flash_attention_fwd(q, k, v, bias, causal, scale, rate, seed)
        return res if rate else (*res, None)

    sets = [make() for _ in range(3 if timed else 1)]
    q, k, v, bias, do, seed = sets[0]
    out, lse, keep = fwd(*sets[0])
    pout, plse = fa._plain_fwd(q, k, v, bias, causal, scale, rate, seed)
    grads = fa.flash_attention_bwd(q, k, v, bias, out, lse, do, causal, scale, rate, keep)
    again = fa.flash_attention_bwd(q, k, v, bias, out, lse, do, causal, scale, rate, keep)
    plain = fa._plain_bwd(q, k, v, bias, out, lse, do, causal, scale, rate, seed)
    torch.cuda.synchronize()
    dq, dk, dv = grads
    if not all(t.dtype == torch.bfloat16 for t in (out, dq, dk, dv)) or lse.dtype != torch.float32:
        raise AssertionError("bf16 attention: outputs not bf16 or lse not f32")
    label = (f"bf16 attention {list(shape)}{f' Lk {lk}' if lk != seq else ''} rate {rate}"
             f"{' causal' if causal else ''}{f' bias {bias_kind}' if bias_kind != 'pad' else ''}")
    bits = {"repeats": all(torch.equal(a, b_) for a, b_ in zip(grads, again))}
    if rate:
        want = fa.dropout_keep_mask(seed, batch, FLASH_H, seq, lk, rate)
        got = fa.unpack_keep(keep, batch, FLASH_H, seq, lk)
        if causal:  # the forward skips the key tiles a block's rows cannot see
            vis = torch.arange(seq, device="cuda")[:, None] + (lk - seq) >= \
                torch.arange(lk, device="cuda")[None, :]
            want, got = want & vis, got & vis
        bits["mask_entries_differing"] = int((want != got).sum())
    if not bits["repeats"] or bits.get("mask_entries_differing", 0):
        raise AssertionError(f"{label}: bit-for-bit checks failed: {bits}")
    pairs_ = {"out": (out, pout), "dq": (dq, plain[0]), "dk": (dk, plain[1]),
              "dv": (dv, plain[2])}
    errs = {n: bf16_ulps(a, b_) for n, (a, b_) in pairs_.items()}
    abs_errs = {n: float((a.float() - b_.float()).abs().max()) for n, (a, b_) in pairs_.items()}
    lse_err = float((lse - plse).abs().max())
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, dq, dk, dv))
    tol = f"{FLASH_BF16_ULPS} bf16 ulps of the largest entry, lse atol {FLASH_ATOL}"
    if not finite or max(errs.values()) > FLASH_BF16_ULPS or lse_err > FLASH_ATOL:
        raise AssertionError(f"{label}: ulps {errs}, lse err {lse_err}, finite {finite}; "
                             f"beyond {tol}")
    pairs = sum(max(0, min(lk, i + lk - seq + 1)) for i in range(seq)) if causal else seq * lk
    bhld = batch * FLASH_H * pairs * d
    qb, kb = 2 * q.numel(), 2 * k.numel()  # bf16 bytes
    bias_b = {"pad": 2 * batch * lk, "none": 0, "full": 4 * batch * FLASH_H * seq * lk}[bias_kind]
    # what the function needs; the stored dropout mask is this design's own
    # traffic (the TPU kernels draw it again), reported beside the bound
    mask_b = 4 * keep.numel() if rate else 0
    stats = 8 * batch * FLASH_H * seq + bias_b  # lse, delta f32; the bias
    io = {"fwd": 2 * qb + 2 * kb + 4 * batch * FLASH_H * seq + bias_b,  # q k v out lse
          "dq": 4 * qb + 2 * kb + stats,  # q, dO, O (delta), dq; k, v
          "dkv": 2 * qb + 4 * kb + stats,
          "all": 4 * qb + 4 * kb + stats}
    ops = {"fwd": 4 * bhld, "dq": 6 * bhld, "dkv": 8 * bhld, "all": 10 * bhld}
    bounds = {n: bound(io[n], ops[n], BF16_FLOPS_PER_S) for n in io}
    common = {"route": "cuda", "shape": list(shape), "keys": lk, "dtype": "bfloat16",
              "dropout_rate": rate, "causal": causal, "bias": bias_kind, "tolerance": tol,
              "bit_for_bit": bits, "stored_mask_bytes": mask_b,
              "bound_note": "bf16 products / 989 TFLOP/s, the bytes the function needs / "
                            "3.35 TB/s (not the stored mask)"}
    entries = [dict(name="flash_attention_fwd_bf16", source=_FLASH_SRC_BF16, replaces=replaces[0],
                    max_abs_err=abs_errs["out"], max_err_ulps=errs["out"], lse_err=lse_err,
                    bound_ms=bounds["fwd"][0], bound_by=bounds["fwd"][1], **common)]
    for name, key, rep in (("flash_attention_bwd_dq_bf16", ("dq",), replaces[1]),
                           ("flash_attention_bwd_dkv_bf16", ("dk", "dv"), replaces[2])):
        b_ = bounds["dq" if name.endswith("dq_bf16") else "dkv"]
        entries.append(dict(name=name, source=_FLASH_BWD_SRC_BF16, replaces=rep,
                            max_abs_err=max(abs_errs[k_] for k_ in key),
                            max_err_ulps=max(errs[k_] for k_ in key), bound_ms=b_[0],
                            bound_by=b_[1], **common))
    msg = (f"{label}: ulps {', '.join(f'{k_} {v_:.3f}' for k_, v_ in errs.items())}, lse err "
           f"{lse_err:.3g} ({tol}); bit for bit {bits}")
    if not timed:
        log(msg)
        return tuple(entries)

    outs = [fwd(*s_) for s_ in sets]
    deltas = [fa.flash_attention_bwd_dq_delta(q_, k_, v_, b_, lse_, o_, do_, causal, scale, rate,
                                              kp)[1]
              for (q_, k_, v_, b_, do_, _), (o_, lse_, kp) in zip(sets, outs)]
    bsets = [(q_, k_, v_, b_, lse_, o_, dl, do_, seed_, kp)
             for (q_, k_, v_, b_, do_, seed_), (o_, lse_, kp), dl in zip(sets, outs, deltas)]
    iters = 100 if seq <= 128 else 20

    def timer(fn, arg_sets, n=iters):  # device ms, the host's launch cost hidden
        return device_ms_sets(fn, arg_sets, n)[0]

    ms = {"fwd": timer(fwd, sets),
          "dq": timer(lambda q_, k_, v_, b_, lse_, o_, dl, do_, sd, kp:
                      fa.flash_attention_bwd_dq_delta(q_, k_, v_, b_, lse_, o_, do_, causal,
                                                      scale, rate, kp), bsets),
          "dkv": timer(lambda q_, k_, v_, b_, lse_, o_, dl, do_, sd, kp:
                       fa.flash_attention_bwd_dkv(q_, k_, v_, b_, lse_, dl, do_, causal, scale,
                                                  rate, kp), bsets),
          "all": timer(lambda q_, k_, v_, b_, lse_, o_, dl, do_, sd, kp:
                       fa.flash_attention_bwd(q_, k_, v_, b_, o_, lse_, do_, causal, scale, rate,
                                              kp), bsets)}
    plain_fwd = timer(lambda q, k, v, bias, do, seed: fa._plain_fwd(
        q, k, v, bias, causal, scale, rate, seed), sets, 5)
    plain_bwd = timer(lambda q_, k_, v_, b_, lse_, o_, dl, do_, sd, kp:
                      fa._plain_bwd(q_, k_, v_, b_, o_, lse_, do_, causal, scale, rate, sd),
                      bsets, 5)
    causal_mask = (torch.full((seq, lk), -1e30, device="cuda").triu(lk - seq + 1).bfloat16()
                   if causal else None)

    def sdpa_mask(b_):
        if b_ is not None:
            b_ = b_.to(torch.bfloat16)
        return b_ if causal_mask is None else (causal_mask if b_ is None else b_ + causal_mask)

    lib_fwd = timer(lambda q, k, v, bias, do, seed: F.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask(bias), dropout_p=rate), sets)
    graphs = []
    for q_, k_, v_, b_, do_, _seed in sets:
        ins = [t.detach().requires_grad_() for t in (q_, k_, v_)]
        graphs.append((F.scaled_dot_product_attention(*ins, attn_mask=sdpa_mask(b_),
                                                      dropout_p=rate), ins, do_))
    lib_bwds = sorted(timer(lambda o, ins, do_: torch.autograd.grad(o, ins, do_,
                                                                    retain_graph=True), graphs)
                      for _ in range(3))
    lib_bwd = lib_bwds[1]
    log(f"{msg}; forward {ms['fwd']:.4f} ms (bound {bounds['fwd'][0]:.4f}, {bounds['fwd'][1]}), "
        f"dQ with delta {ms['dq']:.4f} (bound {bounds['dq'][0]:.4f}), dK/dV {ms['dkv']:.4f} "
        f"(bound {bounds['dkv'][0]:.4f}), whole backward {ms['all']:.4f} (bound "
        f"{bounds['all'][0]:.4f}); plain forward {plain_fwd:.4f}, backward "
        f"{plain_bwd:.4f}; library (bf16 SDPA, dropout_p {rate}, its own mask) forward "
        f"{lib_fwd:.4f}, backward {lib_bwd:.4f} (median of {', '.join(f'{t:.4f}' for t in lib_bwds)})"
        f" ms; device time behind a sleep kernel; stored mask {mask_b} bytes")
    total = {"ms": ms["all"], "plain_ms": plain_bwd, "library_ms": lib_bwd,
             "library_ms_readings": lib_bwds,
             "library": "bf16 scaled_dot_product_attention backward", "bound_ms": bounds["all"][0]}
    entries[0].update(ms=ms["fwd"], kernel_ms=ms["fwd"], plain_ms=plain_fwd, library_ms=lib_fwd,
                      library=f"bf16 scaled_dot_product_attention, dropout_p {rate}")
    for e, key in zip(entries[1:], ("dq", "dkv")):
        e.update(ms=ms[key], kernel_ms=ms[key], plain_ms=plain_bwd, library_ms=None,
                 backward_total=total)
    return tuple(entries)


def check_layernorm_mixed(rows=TRAIN_ROWS, h=LN_H):
    """The residual LayerNorm's mixed case, the first encoder layer's under
    AMP: a bf16 x (the attention output) on an f32 residual (the embedding
    output) through the op, whose forward is the mixed kernel (no cast
    pass: the f32 sum, f32 statistics, y rounded to bf16 once) and whose
    backward takes x and dy to f32 for the f32 backward kernel; the
    gradient of x comes back bf16, the residual's f32. Against the plain
    version of the same computation; the mixed forward and the f32
    backward launch once each and nothing else. Returns the mixed
    forward's kernel entry (timed by check_layernorm) with this reading."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.ops.cuda import layernorm_residual as lnr

    g = torch.Generator(device="cuda").manual_seed(12)
    w, b = (torch.randn(h, generator=g, device="cuda") for _ in range(2))
    x, r, dy = (torch.randn(rows, h, generator=g, device="cuda").to(dt)
                for dt in (torch.bfloat16, torch.float32, torch.bfloat16))
    xs, rs = x.detach().requires_grad_(), r.detach().requires_grad_()
    reset_launch_counts()
    y = lnr.layernorm_residual(xs, rs, w, b)
    y.backward(dy)
    counts = {k: v for k, v in launch_counts().items() if v}
    want_counts = {"layernorm_residual_fwd_mixed": 1, "layernorm_residual_bwd": 1}
    py, mean, rstd = lnr._reference(x.float(), r, w, b, 1e-5)
    pa, _, _ = lnr._reference_bwd(x.float(), r, w, mean, rstd, dy.float())
    torch.cuda.synchronize()
    errs = {"y_ulps": bf16_ulps(y, py.bfloat16()), "dx_ulps": bf16_ulps(xs.grad, pa.bfloat16()),
            "dres_rel": float((rs.grad - pa).abs().max() / pa.abs().max())}
    dtypes = (y.dtype, xs.grad.dtype, rs.grad.dtype)
    tol = (f"y and dx {LN_MIXED_ULPS} bf16 ulp of the largest entry, the residual's gradient "
           f"rtol {LN_MIXED_RTOL}")
    if (dtypes != (torch.bfloat16, torch.bfloat16, torch.float32) or counts != want_counts
            or errs["y_ulps"] > LN_MIXED_ULPS or errs["dx_ulps"] > LN_MIXED_ULPS
            or errs["dres_rel"] > LN_MIXED_RTOL):
        raise AssertionError(f"mixed LayerNorm: {errs}, dtypes {dtypes}, launches {counts} "
                             f"(want {want_counts}); beyond {tol}")

    log(f"mixed LayerNorm [{rows}, {h}] bf16 x + f32 residual through the op, forward and "
        f"backward: {errs} ({tol}); launches {counts}")
    entry = check_layernorm("bfloat16", rows, h, res_dtype_name="float32")
    entry["through_the_op"] = {**errs, "tolerance": tol, "launches": counts}
    return entry


def check_amp_kernels():
    """Entries for the bf16 kernels of the AMP path: the LayerNorm forward
    in bf16 and in its mixed instance and the backward in bf16 at the
    training path's [16384, 768] (the block variant at H = 1000 and 4096 and
    rows of mean 100 under ``also_checked``), and the three
    bf16 attention kernels at [32, 12, 512, 64] with dropout 0.1 and a pad
    bias (also at rate 0 and at the short L = 128, causal, where the TPU
    took its small variants; at D = 32 and 128 and at ragged causal shapes
    untimed)."""
    ln = check_layernorm("bfloat16", TRAIN_ROWS)
    ln_mixed = check_layernorm_mixed()
    # the block variant (H = 1000 off the 16-byte width, H = 4096 past a
    # warp's registers) and rows with a large mean, untimed
    ln["also_checked"] = [check_layernorm("bfloat16", LN_ROWS, h, timed=False)
                          for h in (1000, 4096)] + [
        check_layernorm("bfloat16", LN_ROWS, mean_offset=100.0, std=0.1, timed=False)]
    ln_mixed["also_checked"] = [
        check_layernorm("bfloat16", LN_ROWS, h, res_dtype_name="float32", timed=False)
        for h in (1000, 4096)] + [check_layernorm("bfloat16", LN_ROWS, res_dtype_name="float32",
                                                  mean_offset=100.0, std=0.1, timed=False)]
    ln_bwd = check_layernorm_bwd("bfloat16")
    rows = (f"{_FA}:548", f"{_FA}:765", f"{_FA}:815")
    small = (f"{_FA}:370", f"{_FA}:433", f"{_FA}:433")
    fwd, dq, dkv = check_flash_bf16(TRAIN_B, TRAIN_SEQ, ATTN_DROPOUT, False, rows)
    for extra in (check_flash_bf16(TRAIN_B, TRAIN_SEQ, 0.0, False, rows),
                  check_flash_bf16(FLASH_B, 128, ATTN_DROPOUT, True, small),
                  check_flash_bf16(4, 256, ATTN_DROPOUT, True, rows, d=32, timed=False),
                  check_flash_bf16(4, 256, ATTN_DROPOUT, False, rows, d=128, timed=False),
                  check_flash_bf16(2, 300, ATTN_DROPOUT, True, rows, lk=257, timed=False),
                  check_flash_bf16(2, 257, 0.0, True, rows, lk=300, d=32, timed=False),
                  check_flash_bf16(2, 300, ATTN_DROPOUT, True, rows, lk=257, timed=False,
                                   bias_kind="full"),
                  check_flash_bf16(2, 257, ATTN_DROPOUT, False, rows, lk=300, d=128,
                                   timed=False, bias_kind="none")):
        for entry, e in zip((fwd, dq, dkv), extra):
            entry.setdefault("also_checked", []).append(e)
    return [ln, ln_mixed, ln_bwd, fwd, dq, dkv]


# The AMP step against the port's plain path on the CPU under the same
# auto_cast (BERT-base, dropout 0, batch 2 x L=512, the same weights, the
# attention through its kernels' plain versions). In bf16 the two devices
# part the way any two bf16 runs do: a product's output rounds to the
# other side of a bf16 step where the f32 sums differ in their last bits
# (0.04-0.17% of entries), and 12 layers carry that to the noise of bf16
# itself, as far as the f32 step is from either (read on the H100: loss
# 2.1e-3, gradient rel L2 0.021; the f32 step 1.5e-3, 0.022). So the loss
# and the gradient's relative L2 are held to about 2.5 times the bf16
# reading, which catches a wrong kernel or a dropped gradient, not a
# missing cast. What the f32 step cannot match is bf16 values: the share of
# gradient entries that differ from the CPU's in any bit (read 0.830; the
# f32 step 1.000, never a bf16 value) is held at about the geometric mean
# of the two, and amp_train_parity requires the f32 step to fail it.
AMP_LIMITS = {"O1": {"loss": 5e-3, "grad_rel_l2": 0.05},
              "O2": {"loss": 1e-2, "grad_rel_l2": 0.15}}
AMP_GRAD_DIFFERING = 0.91


def _amp_loss_fn(loss_fn, level):
    from paddle_tpu_torch import amp

    def amp_loss(m, *batch):
        with amp.auto_cast(level=level):
            return loss_fn(m, *batch)
    return amp_loss


def _grad_l2(model, ref_model):
    """Against ``ref_model``'s gradients: the relative L2 error of the whole
    gradient (every parameter), the share of its entries (those not 0 on
    both sides) that differ in any bit, and the worst entry relative to the largest gradient entry of its
    layer with the parameter's name (reported: bf16 rounds a layer's
    largest entries by up to 2**-9)."""
    num = den = 0.0
    differ = total = 0
    scale, worst = {}, (0.0, "")
    pairs = list(zip(model.named_parameters(), ref_model.named_parameters()))
    for (n, p), (_, pr) in pairs:
        if p.grad is None or pr.grad is None:
            raise AssertionError(f"{n}: no gradient ({'card' if p.grad is None else 'CPU'})")
        layer = n.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(pr.grad.float().abs().max()))
    for (n, p), (_, pr) in pairs:
        d = p.grad.cpu().double() - pr.grad.double()
        num += float(d.square().sum())
        den += float(pr.grad.double().square().sum())
        live = (p.grad.cpu() != 0) | (pr.grad != 0)  # both 0 (a row no token used) says nothing
        differ += int((d != 0).sum())
        total += int(live.sum())
        e = float(d.abs().max()) / max(scale[n.rpartition(".")[0]], 1e-30)
        worst = max(worst, (e, n))
    return (num / den) ** 0.5, differ / total, worst


@contextlib.contextmanager
def _cpu_kernel_route():
    """CPU tensors take the attention kernels' route with each kernel
    replaced by its plain version (``_plain_fwd``, ``_plain_bwd``): the
    card's arithmetic on the CPU. The CPU's own route differentiates
    ``_plain_attention``, which rounds the normalized weights as the JAX
    package's plain path does, where the kernels round the probabilities
    before normalizing (``_fwd_core``) and dS before its products; in bf16
    that alone moves a BERT-base step as far as leaving out the cast."""
    import torch

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    names = ("_use_kernel", "flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dq_delta", "flash_attention_bwd_dkv")
    saved = {n: getattr(fa, n) for n in names}

    def fwd(q, k, v, b, causal, scale, rate, seed):
        res = fa._plain_fwd(q, k, v, b, causal, scale, rate, seed)
        # bf16 with dropout hands its backward a mask: here the seed, which
        # the plain backward draws the same mask from
        return (*res, seed) if q.dtype == torch.bfloat16 and rate else res

    def dq(q, k, v, b, lse, delta, do, causal, scale, rate, seed):
        return fa._plain_bwd(q, k, v, b, None, lse, do, causal, scale, rate, seed)[0]

    def dq_delta(q, k, v, b, lse, out, do, causal, scale, rate, seed):
        delta = (do.float() * out.float()).sum(-1).reshape(-1, q.shape[2])
        return fa._plain_bwd(q, k, v, b, out, lse, do, causal, scale, rate, seed)[0], delta

    def dkv(q, k, v, b, lse, delta, do, causal, scale, rate, seed):
        return fa._plain_bwd(q, k, v, b, None, lse, do, causal, scale, rate, seed)[1:]

    for n, fn in zip(names, (lambda q: True, fwd, dq, dq_delta, dkv)):
        setattr(fa, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(fa, n, fn)


def _amp_launches(level, layers, steps=1):
    """Launches of one AMP step of BERT: the bf16 attention kernels; at O1
    layer 0's first residual LayerNorm is the mixed case (the mixed forward
    and the f32 backward), every other the bf16 kernels; at O2 all are
    bf16."""
    f32_ln = 1 if level == "O1" else 0
    want = {"flash_attention_fwd_bf16": layers, "flash_attention_bwd_dq_bf16": layers,
            "flash_attention_bwd_dkv_bf16": layers,
            "layernorm_residual_fwd_mixed": f32_ln, "layernorm_residual_bwd": f32_ln,
            "layernorm_residual_fwd_bf16": 2 * layers - f32_ln,
            "layernorm_residual_bwd_bf16": 2 * layers - f32_ln}
    return {k: v * steps for k, v in want.items() if v}


def amp_train_parity():
    """One BERT-base step at dropout 0, batch 2 x L=512, under
    ``auto_cast`` (O1), on the card and on the CPU's plain path from the
    same weights, the attention through its kernels' plain versions
    (``_cpu_kernel_route``); the f32 step on the card as the control the
    limits must catch; then one O2 step (``decorate``), held the same way
    against its own CPU step. Returns the readings."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import bert_base_config
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg = bert_base_config()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    model, loss_fn = _pretraining(cfg, seed=0)
    batch = pretraining_batch(cfg, 2, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(8))
    control = copy.deepcopy(model)
    control_loss = float(_step_of(control, loss_fn)(*batch)["loss"])
    readings, layers = {}, cfg.num_hidden_layers
    for level in ("O1", "O2"):
        card = copy.deepcopy(model)
        if level == "O2":
            amp.decorate(card, level="O2")
        cpu = copy.deepcopy(card)
        amp_loss = _amp_loss_fn(loss_fn, level)
        t0 = time.perf_counter()
        with _cpu_kernel_route():
            cpu_loss = float(_step_of(cpu, amp_loss, device="cpu")(*batch)["loss"])
        cpu_s = time.perf_counter() - t0
        reset_launch_counts()
        loss = float(_step_of(card, amp_loss)(*batch)["loss"])
        counts = {k: v for k, v in launch_counts().items() if v}
        want = _amp_launches(level, layers)
        if counts != want:
            raise AssertionError(f"AMP {level} parity step launched {counts}; want {want}")
        l2, differ, worst = _grad_l2(card, cpu)
        c_l2, c_differ, c_worst = _grad_l2(control, cpu)
        lim = AMP_LIMITS[level]
        r = {"loss": loss, "cpu_loss": cpu_loss, "loss_err": abs(loss - cpu_loss),
             "grad_rel_l2": l2, "grad_differing": differ, "worst_entry": worst,
             "control_loss_err": abs(control_loss - cpu_loss), "control_grad_rel_l2": c_l2,
             "control_grad_differing": c_differ, "control_worst_entry": c_worst,
             "cpu_step_s": cpu_s, "limits": dict(lim, grad_differing=AMP_GRAD_DIFFERING)}
        readings[level] = r
        log(f"AMP {level} parity step: card loss {loss:.6f}, CPU (plain path, {cpu_s:.1f} s) "
            f"{cpu_loss:.6f}: loss err {r['loss_err']:.3g} (atol {lim['loss']}), gradient rel "
            f"L2 {l2:.3g} (limit {lim['grad_rel_l2']}), entries differing {differ:.4f} (limit "
            f"{AMP_GRAD_DIFFERING}), worst entry {worst[0]:.3g} of its layer's largest at "
            f"{worst[1]}; f32 control on the card: loss err {r['control_loss_err']:.3g}, "
            f"gradient rel L2 {c_l2:.3g}, entries differing {c_differ:.4f}, worst entry "
            f"{c_worst[0]:.3g} at {c_worst[1]}; launches {counts}")
        del card, cpu
    for level, r in readings.items():  # every reading is logged before any limit fails
        lim = AMP_LIMITS[level]
        if not (np.isfinite(r["loss"]) and r["loss_err"] <= lim["loss"]
                and r["grad_rel_l2"] <= lim["grad_rel_l2"]
                and r["grad_differing"] <= AMP_GRAD_DIFFERING):
            raise AssertionError(f"AMP {level} parity step beyond its limits: {r}")
        if not r["control_grad_differing"] > AMP_GRAD_DIFFERING:
            raise AssertionError(f"AMP {level}: the f32 control passes the limit on differing "
                                 f"entries {AMP_GRAD_DIFFERING}: {r}")
    return readings


def _gemm_kernels(prof):
    """Matrix-product kernels of a profile: {name: (ms, calls)}."""
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and _kernel_kind(e.key) == "matmul":
            t = getattr(e, "device_time_total", None)
            out[e.key] = ((e.cuda_time_total if t is None else t) / 1e3, e.count)
    return out


def _gemm_dtype(name):
    """The operand type a cuBLAS/CUTLASS kernel's name carries: "bf16",
    "f32" (full f32 or TF32), or "unknown"."""
    n = name.lower()
    if "bf16" in n or n.startswith("nvjet_tst") or "bfloat16" in n:
        return "bf16"
    if any(s in n for s in ("f32f32_f32f32", "sgemm", "tf32", "nvjet_sss", "_s1688", "<float")):
        return "f32"
    return "unknown"


def train_bert_amp():
    """bench.py's phase-2 BERT step under ``auto_cast`` (O1): batch 32 x
    L=512, 80 masked a row, dropout 0.1, AdamW, one fixed batch; 10 timed
    steps whose losses must be finite and fall, each launching the three
    bf16 attention kernels once a layer and the residual LayerNorms (layer
    0's first the mixed case, the mixed forward and the f32 backward, the
    rest bf16); the
    median step, tokens/s and peak memory; one profiled step by kernel
    kind, whose matrix products must all be bf16 (JAX's dtype trace keeps
    no product in f32 under O1). Returns the launches over the timed steps."""
    import torch

    from paddle_tpu_torch.models import bert_base_config

    readings = amp_train_parity()
    cfg = bert_base_config()  # hidden and attention dropout 0.1
    cfg.use_flash_attention = True
    model, loss_fn = _pretraining(cfg, seed=1)
    step = _step_of(model, _amp_loss_fn(loss_fn, "O1"))
    batch = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(9))]
    losses, step_ms, wall_ms, counts, peak = _timed_steps(step, batch, TRAIN_STEPS)
    layers = cfg.num_hidden_layers
    want = _amp_launches("O1", layers, TRAIN_STEPS)
    want = {k: want.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"AMP: {TRAIN_STEPS} steps launched {counts}; want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"AMP losses not finite or not falling: {losses}")
    tokens = TRAIN_B * TRAIN_SEQ
    median = float(np.median(step_ms))
    log(f"AMP (O1, bf16) {TRAIN_STEPS} steps at batch {TRAIN_B} x L={TRAIN_SEQ}: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)}")
    log(f"AMP step {float(np.mean(step_ms)):.2f} ms (median {median:.2f}, min {min(step_ms):.2f}, "
        f"max {max(step_ms):.2f}; host clock {wall_ms:.2f}), {tokens / median * 1e3:.0f} tokens/s "
        f"at the median; peak device memory {peak:.1f} GiB; launches a step "
        f"{ {k: v // TRAIN_STEPS for k, v in counts.items() if v} }")
    prof = _profile_step(step, batch, "AMP train step profiled")
    gemms = _gemm_kernels(prof)
    by_dtype = {}
    for name, (ms, _calls) in gemms.items():
        by_dtype[_gemm_dtype(name)] = by_dtype.get(_gemm_dtype(name), 0.0) + ms
    log("AMP train step, matrix-product kernels (name, ms, calls, operand type): "
        + "; ".join(f"{n[:90]} {ms:.3f} {c} {_gemm_dtype(n)}" for n, (ms, c) in
                    sorted(gemms.items(), key=lambda kv: -kv[1][0])))
    log(f"AMP train step, matrix-product time by operand type (ms): {by_dtype}")
    if not by_dtype.get("bf16") or set(by_dtype) != {"bf16"}:
        raise AssertionError(f"AMP step's matrix products not all bf16: {by_dtype}")
    by_kind, events = _device_time_by_kind(prof)  # logged by _profile_step
    busy = sum(by_kind.values())
    return counts, {"parity": readings, "step_ms_median": median,
                    "tokens_per_s": tokens / median * 1e3, "peak_gib": peak,
                    "gemm_ms_by_dtype": by_dtype, "losses": losses, "busy_ms": busy,
                    "device_ms_by_kind": by_kind, "device_events": events}


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
# products of K float32 terms, relative to the largest output: room for the
# kernels' 3xTF32 products (about 21 bits of each operand, summed in another
# order than cuBLAS's) against the plain f32 product; one TF32 pass (11 bits)
# lands past it, which check_conv_mm's control requires
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


def _conv_bounds(m, k, n, out_vectors):
    """(3xTF32 bound ms, by what, FP32 bound ms) of one conv product with
    ``out_vectors`` [N] vectors besides p2, w2 and the [M, N] output."""
    flops = 2 * m * k * n
    moved = 4 * (m * k + k * n + m * n + out_vectors * n)
    t, by = bound(moved, flops, peak=TF32_FLOPS_PER_S / 3)
    return t, by, bound(moved, flops)[0]


def check_conv_mm(m, k, n, label, timed=True, tf32_control=False):
    """Rows 8 and 9 (``conv_bn_relu_mm.cu``) at [m, k] @ [k, n] against the
    plain versions on the same inputs: the eval affine + relu output, and
    the training ``co`` with its channel sums, which must repeat bit for
    bit. With ``tf32_control``, ``torch.matmul`` in one TF32 pass on the
    same inputs must land past ``CONV_MM_RTOL``."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(21)
    sets = _conv_sets(g, m, k, n, 2 if timed else 1)
    p2, w2, scale, shift = sets[0]
    y = cbr.mm_affine_relu(p2, w2, scale, shift)
    y_ref = cbr._mm_affine_relu_plain(p2, w2, scale, shift)
    co, part = cbr.mm_stats(p2, w2)
    co2, part2 = cbr.mm_stats(p2, w2)
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
    if not (torch.equal(co, co2) and torch.equal(part, part2)):
        raise AssertionError(f"conv matmul {label}: a second mm_stats run differs")
    b8, by8, f8 = _conv_bounds(m, k, n, 2)
    b9, by9, f9 = _conv_bounds(m, k, n, 0)
    e8 = {"name": "conv_bn_relu_mm_affine_relu", "route": "cuda", "source": _CONV_SRC,
          "replaces": f"{_CBR}:306", "shape": [m, k, n], "label": label, "dtype": "float32",
          "max_abs_err": float((y - y_ref).abs().max()), "rel_err": err8, "tolerance": tol8,
          "bound_ms": b8, "bound_by": by8, "bound_fp32_ms": f8,
          "splits": cbr._split_k(m, k, n)[0]}
    e9 = {"name": "conv_bn_relu_mm_stats", "route": "cuda", "source": _CONV_SRC,
          "replaces": f"{_CBR}:337", "shape": [m, k, n], "label": label, "dtype": "float32",
          "max_abs_err": float((co - co_ref).abs().max()), "rel_err": err9,
          "sums_rel_err": sum_err, "tolerance": tol9, "bound_ms": b9, "bound_by": by9,
          "bound_fp32_ms": f9, "repeats_bit_for_bit": True}
    if tf32_control:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = _rel(torch.matmul(p2, w2), co_ref)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        log(f"conv matmul {label}: TF32 control (torch.matmul, one TF32 pass) err {tf32:.3g} "
            f"(limit {CONV_MM_RTOL}; the kernel read {err9:.3g})")
        if not tf32 > CONV_MM_RTOL:
            raise AssertionError(f"conv matmul TF32 control {tf32} passes {CONV_MM_RTOL}: the "
                                 "limit cannot tell 3xTF32 from TF32")
        e8["tf32_control_rel_err"] = e9["tf32_control_rel_err"] = tf32
    if timed:
        iters = max(5, min(50, int(1.5e11 / (m * k * n))))
        e8["ms"] = e8["kernel_ms"] = time_ms(cbr.mm_affine_relu, sets, iters)
        e8["plain_ms"] = time_ms(cbr._mm_affine_relu_plain, sets, iters)
        e9["ms"] = e9["kernel_ms"] = time_ms(lambda p, w, s_, b_: cbr.mm_stats(p, w), sets, iters)
        e9["plain_ms"] = time_ms(lambda p, w, s_, b_: cbr._mm_stats_plain(p, w), sets, iters)
        lib = time_ms(lambda p, w, s_, b_: torch.matmul(p, w), sets, iters)
        e8["library_ms"] = e9["library_ms"] = lib
        e8["library"] = e9["library"] = "torch.matmul(p2, w2), f32, TF32 off (the product alone)"
        log(f"conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu err {err8:.3g}, co err "
            f"{err9:.3g}, sums {sum_err:.3g} ({tol9}); affine+relu {e8['ms']:.4f} ms (bound "
            f"{b8:.4f} {by8} in 3xTF32, FP32 {f8:.4f}), stats {e9['ms']:.4f} ms (bound "
            f"{b9:.4f}), plain {e8['plain_ms']:.4f} / {e9['plain_ms']:.4f} ms, torch.matmul "
            f"{lib:.4f} ms")
    else:
        log(f"conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu err {err8:.3g}, co err "
            f"{err9:.3g}, sums {sum_err:.3g} ({tol9})")
    return e8, e9


def _rn50_fused_products(batch, hw=RN_HW):
    """(M, K, N) of ResNet-50's 33 fused conv + bn + relu products at
    ``batch`` images of ``hw`` x ``hw``: the stem, then each bottleneck's
    conv1 (1x1) and conv2 (3x3, stride 2 in the first block of layers 2-4)."""
    hw //= 2
    out = [(batch * hw * hw, 3 * 7 * 7, 64)]
    hw //= 2  # the stem's max pool
    cin = 64
    for width, blocks, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)):
        for i in range(blocks):
            out.append((batch * hw * hw, cin, width))
            hw //= stride if i == 0 else 1
            out.append((batch * hw * hw, 9 * width, width))
            cin = 4 * width
    return out


def check_conv_serving(batch, per_product=True):
    """Row 8b: the 33 fused eval products of a ResNet-50 forward at serving
    batch ``batch``, each against its plain version, the split-K calls
    counted against the planner's; then the device time of the 33 kernel
    calls in a row against 33 ``torch.matmul`` calls (the L2 cannot hold
    the weights of all 33), and with ``per_product`` each product's."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(23)
    shapes = _rn50_fused_products(batch)
    if len(shapes) != RN_TRIPLES:
        raise AssertionError(f"{len(shapes)} fused products, not {RN_TRIPLES}")
    sets = [_conv_sets(g, m, k, n, 1)[0] for m, k, n in shapes]
    splits0 = cbr.MM_AFFINE_RELU_SPLITS
    worst, worst_abs = 0.0, 0.0
    for (m, k, n), args in zip(shapes, sets):
        y, y_ref = cbr.mm_affine_relu(*args), cbr._mm_affine_relu_plain(*args)
        err = _rel(y, y_ref)
        if err > CONV_MM_RTOL:
            raise AssertionError(f"conv product [{m}, {k}] @ [{k}, {n}] at batch {batch}: err "
                                 f"{err} beyond {CONV_MM_RTOL}")
        worst, worst_abs = max(worst, err), max(worst_abs, float((y - y_ref).abs().max()))
    splits = cbr.MM_AFFINE_RELU_SPLITS - splits0
    want = sum(cbr._split_k(*s)[0] > 1 for s in shapes)
    if splits != want:
        raise AssertionError(f"{splits} of the {len(shapes)} products took split-K; the planner "
                             f"splits {want}")
    per = []
    if per_product:
        for (m, k, n), (p2, w2, sc, sh) in zip(shapes, sets):
            kms = device_ms(lambda: cbr.mm_affine_relu(p2, w2, sc, sh), 20)[0]
            lms = device_ms(lambda: torch.matmul(p2, w2), 20)[0]
            per.append((m, k, n, cbr._split_k(m, k, n)[0], kms, lms))
    ms = device_ms(lambda: [cbr.mm_affine_relu(*a) for a in sets], 10)[0]
    plain = device_ms(lambda: [cbr._mm_affine_relu_plain(*a) for a in sets], 10)[0]
    lib = device_ms(lambda: [torch.matmul(a[0], a[1]) for a in sets], 10)[0]
    bounds = [_conv_bounds(m, k, n, 2) for m, k, n in shapes]
    b, f = sum(x[0] for x in bounds), sum(x[2] for x in bounds)
    by = max(("bytes", "operations"), key=lambda w: sum(x[0] for x in bounds if x[1] == w))
    for m, k, n, s, kms, lms in per:
        log(f"  bucket {batch} product [{m}, {k}] @ [{k}, {n}], {s} slice(s): kernel {kms:.4f} "
            f"ms, torch.matmul {lms:.4f} ms")
    log(f"ResNet-50 bucket {batch}, {len(shapes)} fused products: err {worst:.3g} (limit "
        f"{CONV_MM_RTOL}), {splits} took split-K; device time in a row {ms:.4f} ms, plain "
        f"{plain:.4f} ms, torch.matmul {lib:.4f} ms, bound {b:.4f} ms (3xTF32; FP32 {f:.4f})")
    entry = {"name": "conv_bn_relu_mm_affine_relu", "route": "cuda", "source": _CONV_SRC,
             "replaces": f"{_CBR}:306", "label": f"ResNet-50 serving batch {batch}: the "
             f"{len(shapes)} fused products in a row, device time", "shape": shapes,
             "dtype": "float32", "max_abs_err": worst_abs, "rel_err": worst,
             "tolerance": f"rtol {CONV_MM_RTOL} of each product's largest output",
             "splits": splits, "ms": ms, "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
             "library": "torch.matmul(p2, w2) for each product, f32, TF32 off",
             "bound_ms": b, "bound_by": by, "bound_fp32_ms": f}
    if per:
        entry["per_product"] = [dict(zip(("m", "k", "n", "slices", "ms", "library_ms"), r))
                                for r in per]
    return entry


def check_bn_passes(m, n, label, timed=True, mean_offset=1.0, std=1.0, dtype="float32"):
    """Rows 10-13 (``conv_bn_relu_bn.cu``) over a [m, n] conv output against
    the plain versions: the centred sum of squares, normalize + relu and
    the two backward passes (the relu gate recomputed from co: the
    elementwise passes round as the plain version does, so they must equal
    it bit for bit). ``dtype`` is co's and dy's (and y's); the vectors, the
    sums and d_co are float32 in both."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(22)
    dt = getattr(torch, dtype)
    es = dt.itemsize  # bytes of an element of co, dy and y
    sfx, tag = ("_bf16", "bf16 ") if dt == torch.bfloat16 else ("", "")

    def make():
        co = (torch.randn(m, n, generator=g, device="cuda") * std
              + torch.randn(n, generator=g, device="cuda") * mean_offset).to(dt)
        dy = torch.randn(m, n, generator=g, device="cuda").to(dt)
        mean = co.float().mean(0)
        rstd = torch.rsqrt(co.float().var(0, unbiased=False) + 1e-5)
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
    if y.dtype != dt or dco.dtype != torch.float32 or ss.dtype != torch.float32:
        raise AssertionError(f"{tag}batch-norm passes {label}: dtypes y {y.dtype}, dco "
                             f"{dco.dtype}, sums {ss.dtype}")
    # a channel whose values all round to one bf16 value sums to 0 in all
    # three: the relative error is then 0, not 0 / 0
    err10 = float(((ss - ss_ref).abs() / ss_ref.abs().clamp_min(1e-30)).max())
    err10_64 = float(((ss.double() - ss64).abs() / ss64.clamp_min(1e-30)).max())
    gated = cbr._gated(co, dy, scale, shift).float()
    err12 = max(_sum_rel(pdy.sum(0), rdy.sum(0), gated),
                _sum_rel(pdyc.sum(0), rdyc.sum(0), gated * co.float()))
    err11 = float((y.float() - y_ref.float()).abs().max())
    err13 = float((dco - dco_ref).abs().max())
    tol10 = (f"rtol {CONV_SUM_RTOL} of the plain version's sum (and of a float64 centred sum: "
             f"read {err10_64:.3g})")
    tol12 = f"rtol {CONV_SUM_RTOL} of the channel's sum of |terms|"
    if not (err10 <= CONV_SUM_RTOL and err10_64 <= CONV_SUM_RTOL and err11 == 0.0
            and err12 <= CONV_SUM_RTOL and err13 == 0.0):
        raise AssertionError(f"{tag}batch-norm passes {label} [{m}, {n}]: sumsq {err10} (f64 "
                             f"{err10_64}), bn_relu {err11}, partials {err12}, dco {err13} "
                             f"beyond {tol10} / bit-exact / {tol12} / bit-exact")
    vec = 8 * n  # two float32 vectors
    entries = [
        {"name": f"conv_bn_relu_centered_sumsq{sfx}", "source": _BN_SRC,
         "replaces": f"{_CBR}:370", "max_abs_err": float((ss - ss_ref).abs().max()),
         "rel_err": err10, "rel_err_vs_float64": err10_64, "tolerance": tol10,
         "bound": bound(es * m * n + 8 * n, 3 * m * n)},
        {"name": f"conv_bn_relu_bn_relu{sfx}", "source": _BN_SRC, "replaces": f"{_CBR}:399",
         "max_abs_err": err11, "tolerance": "bit-exact (the same rounding of co * scale + shift)",
         "bound": bound(es * 2 * m * n + vec, 3 * m * n)},
        {"name": f"conv_bn_relu_bn_bwd_partials{sfx}", "source": _BN_SRC,
         "replaces": f"{_CBR}:463",
         "max_abs_err": max(float((pdy.sum(0) - rdy.sum(0)).abs().max()),
                            float((pdyc.sum(0) - rdyc.sum(0)).abs().max())),
         "rel_err": err12, "tolerance": tol12, "bound": bound(es * 2 * m * n + 8 * n + vec,
                                                              5 * m * n)},
        {"name": f"conv_bn_relu_bn_bwd_dco{sfx}", "source": _BN_SRC, "replaces": f"{_CBR}:496",
         "max_abs_err": err13, "tolerance": "bit-exact (the same rounding, gate included)",
         "bound": bound((2 * es + 4) * m * n + 2 * vec, 7 * m * n)},  # d_co float32
    ]
    for e in entries:
        e.update({"route": "cuda", "shape": [m, n], "label": label, "dtype": dtype})
        e["bound_ms"], e["bound_by"] = e.pop("bound")
    if not timed:
        log(f"{tag}batch-norm passes {label} [{m}, {n}]: sumsq err {err10:.3g} (f64 "
            f"{err10_64:.3g}), bn_relu {err11}, partials {err12:.3g}, dco {err13} (bit-exact "
            "where stated)")
        return entries
    runs = [
        (lambda co, dy, mean, s_, b_, k3, b0: cbr.centered_sumsq(co, mean),
         lambda co, dy, mean, s_, b_, k3, b0: cbr._centered_sumsq_plain(co, mean),
         lambda co, dy, mean, s_, b_, k3, b0: torch.var(co, 0, unbiased=False),
         f"torch.var in {dtype}"),
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
    # device time behind a sleep kernel: a bf16 pass takes about as long as
    # the host takes to enqueue it, so CUDA events around a loop of launches
    # read the host's pace (0.021-0.044 ms in three runs of one kernel)
    for e, (kern, plain, lib, lib_name) in zip(entries, runs):
        e["ms"] = e["kernel_ms"] = device_ms_sets(kern, sets, 100)[0]
        e["plain_ms"] = device_ms_sets(plain, sets, 20)[0]
        e["library_ms"] = device_ms_sets(lib, sets, 100)[0] if lib else None
        e["library"] = lib_name
        e["timing"] = "device time behind a sleep kernel"
    log(f"{tag}batch-norm passes {label} [{m}, {n}]: sumsq err {err10:.3g} (f64 "
        f"{err10_64:.3g}), bn_relu {err11}, partials {err12:.3g}, dco {err13}; kernel ms "
        + ", ".join(f"{e['name'][13:]} {e['ms']:.4f} (bound {e['bound_ms']:.4f}, plain "
                    f"{e['plain_ms']:.4f})" for e in entries)
        + f"; {tag}torch.var {entries[0]['library_ms']:.4f}")
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
    lr = torch.full((), RN_LR, dtype=torch.float32, device="cuda")  # read by pointer, as a step's
    launches = len(ou.launch_groups([int(np.prod(s)) for s in shapes]))
    diff = 0
    for nesterov, wd in variants:
        p, v = [t.clone() for t in params], [t.clone() for t in vels]
        want = [ou._plain_update(a, b, c, RN_LR, RN_MOMENTUM, wd, nesterov)
                for a, b, c in zip(p, grads, v)]
        before = ou.LAUNCHES
        ou.fused_momentum_update_multi(p, grads, v, lr, RN_MOMENTUM, wd, nesterov)
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
             "dtype": "float32", "lr": "float32 read from device memory",
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
        ou.fused_momentum_update_multi(*next_set(), lr, RN_MOMENTUM)

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
    N % 4 != 0), layer4's K = 4608, row 8 at the serving batch 32 and the
    33 products of batches 1 and 8, the large-mean variance and all 161
    parameters ride along under ``also_checked``."""
    import torch

    e8, e9 = check_conv_mm(CONV_M, CONV_K, CONV_N, "layer1 3x3, batch 128", tf32_control=True)
    s8, s9 = check_conv_mm(RN_B * 112 * 112, 3 * 7 * 7, 64, "stem 7x7, batch 128")
    r8, r9 = check_conv_mm(12345, 147, 70, "ragged", timed=False)
    d8, d9 = check_conv_mm(RN_B * 7 * 7, 9 * 512, 512, "layer4 3x3, batch 128 (K = 4608)",
                           timed=False)
    v8, _ = check_conv_mm(RN_BUCKETS[-1] * 56 * 56, CONV_K, CONV_N,
                          f"layer1 3x3, serving batch {RN_BUCKETS[-1]}")
    e8["also_checked"] = [s8, r8, d8, v8, check_conv_serving(RN_BUCKETS[0]),
                          check_conv_serving(RN_BUCKETS[1], per_product=False)]
    e9["also_checked"] = [s9, r9, d9]
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
    8 and 32. Returns (kernel launches per name on the serving run,
    readings)."""
    import torch

    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.jit_api import InputSpec
    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    specs = [InputSpec([None, 3, RN_HW, RN_HW], "float32", "image")]
    model = _resnet50(seed=0)
    cpu_pred = Predictor(copy.deepcopy(model), specs, ["logits"], device="cpu")
    pred = Predictor(model, specs, ["logits"])
    rng = np.random.RandomState(13)
    reqs = [{"image": _images(rng, rows)} for rows in (1, 6, 3, 20)]
    answers, counts, forwards, readings = _serve(pred, RN_BUCKETS, reqs, "ResNet-50")
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
    splits = cbr.MM_AFFINE_RELU_SPLITS
    at_one = sum(cbr._split_k(*s)[0] > 1 for s in _rn50_fused_products(RN_BUCKETS[0]))
    if not at_one <= splits <= RN_TRIPLES * forwards:
        raise AssertionError(f"ResNet serving: {splits} split-K products over {forwards} "
                             f"forwards; the bucket-1 forward alone splits {at_one}")
    log(f"ResNet-50: {forwards} forwards, launches {counts}: {RN_TRIPLES} fused eval kernels "
        f"each; {splits} of them took split-K")
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
    readings["by_bucket"] = profile_resnet_forward(pred)
    readings["concurrent"] = _concurrent_replays(pred, _rn_feed, 8, 5, "ResNet-50")
    return counts, readings


def _rn_feed(bucket, seed):
    return [np.random.RandomState(seed).randn(bucket, 3, RN_HW, RN_HW).astype(np.float32)]


def profile_resnet_forward(pred):
    """Forward time per bucket (inputs on the card, CUDA events around 10
    forwards of the module, eagerly), then ``Predictor.run`` captured
    against eager at every bucket (:func:`_captured_vs_eager`). Returns the
    latter's readings."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(5)
    for bucket in RN_BUCKETS:
        x = torch.randn(bucket, 3, RN_HW, RN_HW, generator=g, device="cuda")
        with torch.inference_mode():
            ms = time_ms(pred.module, [(x,)] * 2, 10)
        log(f"ResNet-50 forward bucket {bucket}: {ms:.3f} ms, {bucket / ms * 1e3:.1f} images/s")
    feeds = {b: _rn_feed(b, 6 + b) for b in RN_BUCKETS}
    return _captured_vs_eager(pred, feeds, _eager_module_run(pred), "ResNet-50")


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


def _rn_step_of(model, device=None, loss_fn=_rn_loss, jit=False):
    """bench.py's ResNet step: Momentum lr 0.1, momentum 0.9. ``jit=False``
    (the eager step) unless the caller asks for the compiled one."""
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.optimizer import Momentum

    opt = Momentum(learning_rate=RN_LR, momentum=RN_MOMENTUM, parameters=model.parameters())
    return train_step(model, opt, loss_fn, device=device, jit=jit)


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
        log(f"ResNet-50 step {mean_ms:.2f} ms with the pool kernel (median "
            f"{float(np.median(step_ms)):.2f}, min {min(step_ms):.2f}, max {max(step_ms):.2f}; "
            f"host clock {wall_ms:.2f}), {RN_B / mean_ms * 1e3:.1f} images/s; with the flag off "
            f"{off_mean:.2f} ms (median {float(np.median(off_ms)):.2f}, min {min(off_ms):.2f}, max "
            f"{max(off_ms):.2f} over {RN_STEPS_FLAG_OFF} steps), {RN_B / off_mean * 1e3:.1f} "
            f"images/s; peak device "
            f"memory {peak:.1f} GiB; launches {counts}: {RN_TRIPLES} of each training conv kernel, "
            f"{_rn_momentum_launches()} momentum launches updating {RN_PARAMS} tensors and 1 "
            "max-pool backward a step")
        _profile_step(step, batch, "ResNet train step profiled (pool kernel on)")
    finally:
        set_flags({"use_pallas_pool_bwd": False})
    return counts


# -- the ResNet path under AMP ---------------------------------------------------

_CONV_BF16_SRC = "paddle_tpu_torch/csrc/conv_bn_relu_mm_bf16.cu"
_POOL_SRC = "paddle_tpu_torch/csrc/pool_backward.cu"
_POOL_TPU = "paddle_tpu/ops/pallas/pool_backward.py:244"
# bf16 kernels against their plain versions, in bf16 ulps of the largest
# output (bf16_ulp): co rounds a float32 sum taken in another order than
# cuBLAS's, so an entry at a rounding boundary lands one ulp over (1); the
# eval output applies the affine to that co and rounds again, which can add
# an ulp of its own (2)
CONV_BF16_CO_ULPS = 1.0
CONV_BF16_Y_ULPS = 2.0
RN_AMP_STEPS = 10


def _ulps(got, want):
    """max |got - want| in bf16 ulps of the largest |want|."""
    want = want.float()
    return float((got.float() - want).abs().max() / bf16_ulp(want.abs().max()))


def _bf16_conv_bounds(m, k, n, out_bytes):
    """(bound ms, by what) of one bf16 conv product: p2, w2 and the bf16
    [M, N] output, plus ``out_bytes`` of float32 vectors."""
    return bound(2 * (m * k + k * n + m * n) + out_bytes, 2 * m * k * n, peak=BF16_FLOPS_PER_S)


def _conv_sets_bf16(g, m, k, n, count):
    return [(p2.bfloat16(), w2.bfloat16(), s_, b_) for p2, w2, s_, b_ in
            _conv_sets(g, m, k, n, count)]


def check_conv_mm_bf16(m, k, n, label, timed=True):
    """Rows 8 and 9 in bf16 (``conv_bn_relu_mm_bf16.cu``) at [m, k] @ [k, n]
    against the plain versions on the same inputs, in bf16 ulps of the
    largest output; the channel sums against a float64 sum of the kernel's
    own rounded co (the sums are of the stored values), and a second run
    must repeat co and the sums bit for bit. Timed beside bf16
    ``torch.matmul``."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(31)
    sets = _conv_sets_bf16(g, m, k, n, 2 if timed else 1)
    p2, w2, scale, shift = sets[0]
    y = cbr.mm_affine_relu(p2, w2, scale, shift)
    y_ref = cbr._mm_affine_relu_plain(p2, w2, scale, shift)
    co, part = cbr.mm_stats(p2, w2)
    co2, part2 = cbr.mm_stats(p2, w2)
    co_ref, _ = cbr._mm_stats_plain(p2, w2)
    torch.cuda.synchronize()
    u8, u9 = _ulps(y, y_ref), _ulps(co, co_ref)
    differ9 = float((co != co_ref).float().mean())
    sum_err = _sum_rel(part.sum(0).double(), co.double().sum(0), co.float())
    tol8 = f"{CONV_BF16_Y_ULPS} bf16 ulps of the largest output"
    tol9 = (f"co {CONV_BF16_CO_ULPS} bf16 ulp of the largest output; channel sums "
            f"{CONV_SUM_RTOL} of the channel's sum of |co| against float64 sums of the stored co")
    if y.dtype != torch.bfloat16 or co.dtype != torch.bfloat16 or part.dtype != torch.float32:
        raise AssertionError(f"bf16 conv matmul {label}: dtypes {y.dtype}, {co.dtype}, "
                             f"{part.dtype}")
    if u8 > CONV_BF16_Y_ULPS or u9 > CONV_BF16_CO_ULPS or sum_err > CONV_SUM_RTOL:
        raise AssertionError(f"bf16 conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu "
                             f"{u8} ulps, co {u9} ulps, sums {sum_err} beyond {tol8} / {tol9}")
    if not (torch.equal(co, co2) and torch.equal(part, part2)):
        raise AssertionError(f"bf16 conv matmul {label}: a second mm_stats run differs")
    b8, by8 = _bf16_conv_bounds(m, k, n, 8 * n)
    b9, by9 = _bf16_conv_bounds(m, k, n, 4 * n)
    e8 = {"name": "conv_bn_relu_mm_affine_relu_bf16", "route": "cuda", "source": _CONV_BF16_SRC,
          "replaces": f"{_CBR}:306", "shape": [m, k, n], "label": label, "dtype": "bfloat16",
          "max_abs_err": float((y.float() - y_ref.float()).abs().max()), "ulps": u8,
          "tolerance": tol8, "bound_ms": b8, "bound_by": by8,
          "splits": cbr._split_k_bf16(m, k, n, cbr._sm_count(0))[0]}
    e9 = {"name": "conv_bn_relu_mm_stats_bf16", "route": "cuda", "source": _CONV_BF16_SRC,
          "replaces": f"{_CBR}:337", "shape": [m, k, n], "label": label, "dtype": "bfloat16",
          "max_abs_err": float((co.float() - co_ref.float()).abs().max()), "ulps": u9,
          "co_entries_differing": differ9, "sums_rel_err": sum_err, "tolerance": tol9,
          "bound_ms": b9, "bound_by": by9, "repeats_bit_for_bit": True}
    note = ""
    if timed:
        iters = max(5, min(50, int(1.5e11 / (m * k * n))))
        e8["ms"] = e8["kernel_ms"] = time_ms(cbr.mm_affine_relu, sets, iters)
        e8["plain_ms"] = time_ms(cbr._mm_affine_relu_plain, sets, iters)
        e9["ms"] = e9["kernel_ms"] = time_ms(lambda p, w, s_, b_: cbr.mm_stats(p, w), sets, iters)
        e9["plain_ms"] = time_ms(lambda p, w, s_, b_: cbr._mm_stats_plain(p, w), sets, iters)
        lib = time_ms(lambda p, w, s_, b_: torch.matmul(p, w), sets, iters)
        e8["library_ms"] = e9["library_ms"] = lib
        e8["library"] = e9["library"] = "torch.matmul(p2, w2) in bf16 (the product alone)"
        note = (f"; affine+relu {e8['ms']:.4f} ms (bound {b8:.4f} {by8}), stats {e9['ms']:.4f} "
                f"ms (bound {b9:.4f}), plain {e8['plain_ms']:.4f} / {e9['plain_ms']:.4f} ms, "
                f"bf16 torch.matmul {lib:.4f} ms")
    log(f"bf16 conv matmul {label} [{m}, {k}] @ [{k}, {n}]: affine+relu {u8:.3g} ulps, co "
        f"{u9:.3g} ulps ({differ9:.2e} of co differing), sums {sum_err:.3g} ({tol9}){note}")
    return e8, e9


def _rn50_fused_products_bf16(batch):
    """:func:`_rn50_fused_products` as the bf16 lowering gives them: K
    padded to a multiple of 8 (the stem's 147 to 152)."""
    return [(m, -(-k // 8) * 8, n) for m, k, n in _rn50_fused_products(batch)]


def check_conv_serving_bf16(batch):
    """Row 8b in bf16: the 33 fused eval products of a ResNet-50 forward
    at serving batch ``batch``, each against its plain version and run a
    second time bit-equal (the split-K reduce adds the slices in slice
    order whichever block arrives last), the split-K calls counted against
    the planner's, then the device time of the 33 kernel calls in a row
    against 33 bf16 ``torch.matmul`` calls."""
    import torch

    from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr

    g = torch.Generator(device="cuda").manual_seed(33)
    shapes = _rn50_fused_products_bf16(batch)
    sets = [_conv_sets_bf16(g, m, k, n, 1)[0] for m, k, n in shapes]
    splits0 = cbr.MM_AFFINE_RELU_SPLITS
    worst, worst_abs = 0.0, 0.0
    for (m, k, n), args in zip(shapes, sets):
        y, y_ref = cbr.mm_affine_relu(*args), cbr._mm_affine_relu_plain(*args)
        u = _ulps(y, y_ref)
        if u > CONV_BF16_Y_ULPS:
            raise AssertionError(f"bf16 conv product [{m}, {k}] @ [{k}, {n}] at batch {batch}: "
                                 f"{u} ulps beyond {CONV_BF16_Y_ULPS}")
        if not torch.equal(y, cbr.mm_affine_relu(*args)):
            raise AssertionError(f"bf16 conv product [{m}, {k}] @ [{k}, {n}] at batch {batch}: "
                                 "a second run differs")
        worst = max(worst, u)
        worst_abs = max(worst_abs, float((y.float() - y_ref.float()).abs().max()))
    splits = (cbr.MM_AFFINE_RELU_SPLITS - splits0) // 2  # each product ran twice
    want = sum(cbr._split_k_bf16(*sh, cbr._sm_count(0))[0] > 1 for sh in shapes)
    if splits != want:
        raise AssertionError(f"bf16: {splits} of the {len(shapes)} products took split-K; the "
                             f"bf16 planner splits {want}")
    ms = device_ms(lambda: [cbr.mm_affine_relu(*a) for a in sets], 10)[0]
    plain = device_ms(lambda: [cbr._mm_affine_relu_plain(*a) for a in sets], 10)[0]
    lib = device_ms(lambda: [torch.matmul(a[0], a[1]) for a in sets], 10)[0]
    bounds = [_bf16_conv_bounds(m, k, n, 8 * n) for m, k, n in shapes]
    b = sum(x[0] for x in bounds)
    by = max(("bytes", "operations"), key=lambda w: sum(x[0] for x in bounds if x[1] == w))
    log(f"ResNet-50 bucket {batch}, {len(shapes)} bf16 fused products: {worst:.3g} ulps (limit "
        f"{CONV_BF16_Y_ULPS}), {splits} took split-K; device time in a row {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bf16 torch.matmul {lib:.4f} ms, bound {b:.4f} ms ({by})")
    return {"name": "conv_bn_relu_mm_affine_relu_bf16", "route": "cuda", "source": _CONV_BF16_SRC,
            "replaces": f"{_CBR}:306", "label": f"ResNet-50 serving batch {batch} under AMP: the "
            f"{len(shapes)} fused products in a row, device time", "shape": shapes,
            "dtype": "bfloat16", "max_abs_err": worst_abs, "ulps": worst,
            "tolerance": f"{CONV_BF16_Y_ULPS} bf16 ulps of each product's largest output",
            "splits": splits, "repeats_bit_for_bit": True, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain, "library_ms": lib,
            "library": "torch.matmul(p2, w2) in bf16 for each product", "bound_ms": b,
            "bound_by": by}


def check_pool_backward_bf16(layout, shape=None, timed=True):
    """Row 16 in bf16 at the stem's [128, 64, 112, 112], 3x3/2/1, on a relu'd
    input (zeros tie all over), in NCHW or the stem's channels-last layout
    (``layout``): bit-equal to the plain version (float32 sums rounded once),
    dx in x's layout; against ``aten.max_pool2d_with_indices_backward`` in
    bf16, the library yardstick, to 4 bf16 ulps of the largest entry (the
    same first-maximum rule)."""
    import torch

    from paddle_tpu_torch.ops.cuda import pool_backward as pb

    g = torch.Generator(device="cuda").manual_seed(34)
    ks, st, pad = POOL_GEOM
    n, c, h, w = shape or POOL_SHAPE
    x = torch.relu(torch.randn(n, h, w, c, generator=g, device="cuda")).bfloat16()
    x = x.permute(0, 3, 1, 2)
    if layout == "nchw":
        x = x.contiguous()
    y, idx = torch.nn.functional.max_pool2d(x, ks, st, pad, return_indices=True)
    dy = torch.randn(y.shape, generator=g, device="cuda").bfloat16()
    fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
    y, dy = y.contiguous(memory_format=fmt), dy.contiguous(memory_format=fmt)
    layouts = [pb.memory_layout(t) for t in (x, y, dy)]
    if layouts != [layout] * 3:
        raise AssertionError(f"bf16 max_pool2d_backward ({layout}): x, y, dy lie as {layouts}")
    launches0 = pb.BF16_LAUNCHES
    dx = pb.max_pool2d_backward(x, y, dy, ks, st, pad)
    if pb.BF16_LAUNCHES != launches0 + 1:
        raise AssertionError("bf16 max_pool2d_backward: the bf16 kernel was not counted")
    ref = pb._plain_max_pool2d_backward(x, y, dy, ks, st, pad)
    lib_fn = lambda: torch.ops.aten.max_pool2d_with_indices_backward(  # noqa: E731
        dy, x, list(ks), list(st), list(pad), [1, 1], False, idx)
    lib = lib_fn()
    torch.cuda.synchronize()
    lib_u = _ulps(dx, lib)
    if dx.dtype != torch.bfloat16 or not torch.equal(dx, ref):
        raise AssertionError(f"bf16 max_pool2d_backward ({layout}): {dx.dtype}, differs from "
                             f"the plain version by {float((dx.float() - ref.float()).abs().max())}")
    if pb.memory_layout(dx) != layout:
        raise AssertionError(f"bf16 max_pool2d_backward: dx lies as {pb.memory_layout(dx)}")
    if lib_u > 4:
        raise AssertionError(f"bf16 max_pool2d_backward ({layout}): {lib_u} ulps from torch's "
                             "backward: another tie rule?")
    t_b, by = bound(2 * (2 * x.numel() + 2 * y.numel()), 9 * x.numel())
    entry = {"name": "max_pool2d_backward_bf16", "route": "cuda", "source": _POOL_SRC,
             "replaces": _POOL_TPU, "shape": [n, c, h, w], "geometry": "3x3 stride 2 padding 1",
             "input": "relu", "layout": layout, "dtype": "bfloat16", "max_abs_err": 0.0,
             "tolerance": "bit-equal to the plain version", "library_ulps": lib_u,
             "bound_ms": t_b, "bound_by": by}
    if timed:
        args = [(x, y, dy, ks, st, pad)]
        entry["ms"], entry["host_ms"] = device_ms_sets(pb.max_pool2d_backward, args, 20)
        entry["kernel_ms"] = entry["ms"]
        entry["plain_ms"] = device_ms_sets(pb._plain_max_pool2d_backward, args, 5)[0]
        entry["library_ms"] = device_ms(lib_fn, 20)[0]
        entry["library"] = "aten.max_pool2d_with_indices_backward in bf16, the same layout"
        entry["timing"] = "device time behind a sleep kernel"
    log(f"bf16 max_pool2d_backward {[n, c, h, w]} 3x3/2/1 ({layout}): bit-equal to the plain "
        f"version; {lib_u:.3g} ulps from torch's backward"
        + (f"; kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, library "
           f"{entry['library_ms']:.4f} ms, bound {t_b:.4f} ms ({by})" if timed else ""))
    return entry


def check_resnet_kernels_bf16(timed=True):
    """One entry per bf16 kernel of the ResNet path under AMP (rows 8-13 at
    layer1's 3x3 conv at batch 128, row 16 at the stem's pool in its
    channels-last layout); the stem (K padded to 152), layer2's and
    layer3's 3x3 convs (N = 128 and 256: tiles of the other widths), ragged
    shapes (M and N off every tile, N % 8 != 0, an odd N), layer4's K =
    4608 (N = 512: two column tiles), row 8 at the serving batch 32 and the
    33 products of batches 1 and 8 (split-K), the large-mean variance and
    the NCHW pool ride along under ``also_checked``."""
    import torch

    e8, e9 = check_conv_mm_bf16(CONV_M, CONV_K, CONV_N, "layer1 3x3, batch 128", timed)
    others = [check_conv_mm_bf16(RN_B * 112 * 112, 152, 64, "stem 7x7, batch 128, K 147 -> 152",
                                 timed),
              check_conv_mm_bf16(RN_B * 28 * 28, 9 * 128, 128, "layer2 3x3, batch 128 (N = 128)",
                                 timed),
              check_conv_mm_bf16(RN_B * 14 * 14, 9 * 256, 256, "layer3 3x3, batch 128 (N = 256)",
                                 timed),
              check_conv_mm_bf16(12345, 152, 70, "ragged", timed=False),
              check_conv_mm_bf16(1000, 24, 37, "ragged, odd N", timed=False),
              check_conv_mm_bf16(RN_B * 7 * 7, 9 * 512, 512, "layer4 3x3, batch 128 (K = 4608)",
                                 timed=False),
              check_conv_mm_bf16(RN_BUCKETS[-1] * 56 * 56, CONV_K, CONV_N,
                                 f"layer1 3x3, serving batch {RN_BUCKETS[-1]}", timed)]
    e8["also_checked"] = [o[0] for o in others] + [check_conv_serving_bf16(b)
                                                   for b in RN_BUCKETS[:2]]
    e9["also_checked"] = [o[1] for o in others]
    bf16 = dict(dtype="bfloat16")
    bn = check_bn_passes(CONV_M, CONV_N, "layer1 3x3, batch 128", timed, **bf16)
    ragged = [check_bn_passes(12345, 70, "ragged", timed=False, **bf16),
              check_bn_passes(12345, 37, "ragged, odd N", timed=False, **bf16)]
    large = check_bn_passes(CONV_M, CONV_N, "mean ~100, std ~0.1", timed=False,
                            mean_offset=100.0, std=0.1, **bf16)
    for i, e in enumerate(bn):
        e["also_checked"] = [r[i] for r in ragged]
    bn[0]["also_checked"].append(large[0])
    pool = check_pool_backward_bf16("nhwc", timed=timed)
    pool["also_checked"] = [check_pool_backward_bf16("nchw", timed=timed),
                            check_pool_backward_bf16("nchw", (2, 3, 15, 15), timed=False),
                            check_pool_backward_bf16("nhwc", (2, 6, 15, 15), timed=False)]
    torch.cuda.empty_cache()
    return [e8, e9, *bn, pool]


def _rn_amp_loss(m, x, y):
    from paddle_tpu_torch import amp

    with amp.auto_cast():
        return _rn_loss(m, x, y)


def _rn_amp_step_launches(steps):
    """Launches of ``steps`` O1 steps with the pool kernel on: each training
    conv kernel 33 times in bf16 and never in float32, the stem's pool
    backward once in bf16, the float32 momentum update."""
    from paddle_tpu_torch.ops.cuda import KERNEL_COUNTERS

    want = {f"conv_bn_relu_{k}_bf16": RN_TRIPLES * steps for k in
            ("mm_stats", "centered_sumsq", "bn_relu", "bn_bwd_partials", "bn_bwd_dco")}
    want["momentum_update"] = _rn_momentum_launches() * steps
    want["max_pool2d_backward_bf16"] = steps
    return {name: want.get(name, 0) for name in KERNEL_COUNTERS}


# The O1 ResNet step against the CPU's plain path, each limit between two
# readings on an H100 (the bf16 step / the f32 step, which must fail it):
# the loss (0.0060 / 0.1216) and the share of the gradient's entries (not 0
# on both sides) that differ in any bit (0.9932 / 1.0000). At batch 2 this
# random-init ResNet-50's logits reach ~5,000 and its batch norms see 98
# values a channel in layer4: any two bf16 runs part in the gradient about
# as far as bf16 is from f32 (relative L2 1.15 / 1.33), so the gradient's
# relative L2 error is only a gross-fault limit.
RN_AMP_LOSS_ATOL = 3e-2
RN_AMP_GRAD_DIFFERING = 0.997
RN_AMP_GRAD_REL_L2 = 2.0


def rn_amp_train_parity():
    """One Momentum step of ResNet-50 under ``auto_cast`` (O1) at batch 2 x
    224 x 224, ``FLAGS_use_pallas_pool_bwd`` on (the caller sets it), on
    the card and on the CPU's plain path from the same weights; the f32
    step on the card as the control the limit must catch. Returns the
    readings."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = _resnet50(seed=2)
    cpu_model, control = copy.deepcopy(model), copy.deepcopy(model)
    rng = np.random.RandomState(16)
    batch = [rng.randn(2, 3, RN_HW, RN_HW).astype(np.float32),
             rng.randint(0, RN_CLASSES, (2,)).astype(np.int64)]
    t0 = time.perf_counter()
    cpu_loss = float(_rn_step_of(cpu_model, device="cpu", loss_fn=_rn_amp_loss)(*batch)["loss"])
    cpu_s = time.perf_counter() - t0
    control_loss = float(_rn_step_of(control)(*batch)["loss"])
    reset_launch_counts()
    loss = float(_rn_step_of(model, loss_fn=_rn_amp_loss)(*batch)["loss"])
    counts = launch_counts()
    want = _rn_amp_step_launches(1)
    if counts != want:
        raise AssertionError(f"ResNet AMP parity step launched {counts}; want {want}")
    l2, differ, worst = _grad_l2(model, cpu_model)
    c_l2, c_differ, c_worst = _grad_l2(control, cpu_model)
    equal = sorted(((int((p.grad.cpu() == q.grad).sum()), n) for (n, p), (_, q) in
                    zip(model.named_parameters(), cpu_model.named_parameters())), reverse=True)
    r = {"loss": loss, "cpu_loss": cpu_loss, "loss_err": abs(loss - cpu_loss),
         "grad_rel_l2": l2, "grad_differing": differ, "worst_entry": worst,
         "control_loss_err": abs(control_loss - cpu_loss), "control_grad_rel_l2": c_l2,
         "control_grad_differing": c_differ, "control_worst_entry": c_worst, "cpu_step_s": cpu_s,
         "buffer_rel_err": _buffer_errors(model, cpu_model),
         "control_buffer_rel_err": _buffer_errors(control, cpu_model),
         "most_equal_entries": equal[:5],
         "limits": {"loss": RN_AMP_LOSS_ATOL, "grad_rel_l2": RN_AMP_GRAD_REL_L2,
                    "grad_differing": RN_AMP_GRAD_DIFFERING}}
    log(f"ResNet AMP (O1) parity step: card loss {loss:.6f}, CPU (plain path, {cpu_s:.1f} s) "
        f"{cpu_loss:.6f}: loss err {r['loss_err']:.3g} (atol {RN_AMP_LOSS_ATOL}), gradient rel L2 "
        f"{l2:.3g} (limit {RN_AMP_GRAD_REL_L2}), entries differing {differ:.4f} (limit "
        f"{RN_AMP_GRAD_DIFFERING}), worst entry {worst[0]:.3g} of its layer's largest at "
        f"{worst[1]}, buffers {r['buffer_rel_err']}, bit-equal entries most in {equal[:5]}; f32 "
        f"control on the card: loss err {r['control_loss_err']:.3g}, gradient rel L2 "
        f"{c_l2:.3g}, entries differing {c_differ:.4f}, worst entry {c_worst[0]:.3g} at "
        f"{c_worst[1]}, buffers {r['control_buffer_rel_err']}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if not (np.isfinite(loss) and r["loss_err"] <= RN_AMP_LOSS_ATOL
            and l2 <= RN_AMP_GRAD_REL_L2 and differ <= RN_AMP_GRAD_DIFFERING):
        raise AssertionError(f"ResNet AMP parity step beyond its limits: {r}")
    if not (r["control_loss_err"] > RN_AMP_LOSS_ATOL and c_differ > RN_AMP_GRAD_DIFFERING):
        raise AssertionError(f"ResNet AMP: the f32 control passes the limits on the loss "
                             f"{RN_AMP_LOSS_ATOL} or on differing entries "
                             f"{RN_AMP_GRAD_DIFFERING}: {r}")
    return r


def train_resnet_amp():
    """bench.py's ResNet-50 step under ``auto_cast`` (O1): the parity step,
    then batch 128 x 224², Momentum lr 0.1, momentum 0.9,
    ``FLAGS_use_pallas_pool_bwd`` on, one fixed batch, ``RN_AMP_STEPS``
    timed steps whose losses must be finite and fall below the first, with
    exact launch counts (every fused conv kernel in bf16, none in float32;
    the bf16 pool backward once a step); the median step, images/s, peak
    memory; one profiled step by kernel kind, in which no fused conv
    product runs outside the bf16 kernel. Returns (launches over the timed
    steps, readings)."""
    import torch

    from paddle_tpu_torch.flags import set_flags

    set_flags({"use_pallas_pool_bwd": True})
    try:
        parity = rn_amp_train_parity()
        torch.cuda.empty_cache()
        model = _resnet50(seed=1)
        step = _rn_step_of(model, loss_fn=_rn_amp_loss)
        rng = np.random.RandomState(15)
        batch = [torch.from_numpy(rng.randn(RN_B, 3, RN_HW, RN_HW).astype(np.float32)).cuda(),
                 torch.from_numpy(rng.randint(0, RN_CLASSES, (RN_B,)).astype(np.int64)).cuda()]
        losses, step_ms, wall_ms, counts, peak = _timed_steps(step, batch, RN_AMP_STEPS)
        want = _rn_amp_step_launches(RN_AMP_STEPS)
        if counts != want:
            raise AssertionError(f"ResNet AMP {RN_AMP_STEPS} steps launched {counts}; want {want}")
        _rn_check_tensors(RN_AMP_STEPS, f"ResNet AMP {RN_AMP_STEPS} steps")
        if not all(np.isfinite(losses)) or not min(losses[1:]) < losses[0]:
            raise AssertionError(f"ResNet AMP losses not finite or not falling: {losses}")
        median = float(np.median(step_ms))
        log(f"ResNet-50 AMP (O1) {RN_AMP_STEPS} steps at batch {RN_B} x {RN_HW}^2, Momentum lr "
            f"{RN_LR}, pool kernel on: losses {', '.join(f'{x:.6f}' for x in losses)}")
        log(f"ResNet-50 AMP step {float(np.mean(step_ms)):.2f} ms (median {median:.2f}, min "
            f"{min(step_ms):.2f}, max {max(step_ms):.2f}; host clock {wall_ms:.2f}), "
            f"{RN_B / median * 1e3:.1f} images/s at the median; peak device memory {peak:.1f} GiB; "
            f"launches a step { {k: v // RN_AMP_STEPS for k, v in counts.items() if v} }")
        prof = _profile_step(step, batch, "ResNet AMP train step profiled (pool kernel on)")
    finally:
        set_flags({"use_pallas_pool_bwd": False})
    by_kind, events = _device_time_by_kind(prof)
    busy = sum(by_kind.values())
    if by_kind.get("conv_mm", 0.0) > 0 or not by_kind.get("conv_mm_bf16"):
        raise AssertionError(f"ResNet AMP step: fused conv products outside the bf16 kernel: "
                             f"{by_kind}")
    log(f"ResNet-50 AMP step: device busy {busy:.2f} ms in a profiled step, {busy / median:.1%} "
        f"of the median step")
    return counts, {"parity": parity, "step_ms_median": median, "step_ms": step_ms,
                    "images_per_s": RN_B / median * 1e3, "peak_gib": peak, "losses": losses,
                    "busy_ms": busy, "busy_share_of_median": busy / median,
                    "device_ms_by_kind": by_kind, "device_events": events}


# The eval forward under AMP against the CPU's plain path: max |logit error|
# over the largest |logit|, a gross-fault limit about 3x the reading on an
# H100 (0.0065); the f32 forward's error is logged beside it (0.0060): two
# bf16 forwards of 53 layers part about as far as bf16 is from f32, so it is
# no control a limit could reject
RN_AMP_SERVE_RTOL = 2e-2


def eval_resnet_amp():
    """One ResNet-50 eval forward under ``auto_cast`` at serving batch 32 on
    the card: 33 bf16 eval kernels (``mm_affine_relu_bf16``) and nothing
    else; its logits against the CPU's plain path under the same scope
    (the f32 forward's error logged beside); the forward's time. Returns
    the launches of the one forward and the readings."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    batch = RN_BUCKETS[-1]
    model = _resnet50(seed=0)
    model.eval()
    cpu_model = copy.deepcopy(model)
    x = np.random.RandomState(17).randn(batch, 3, RN_HW, RN_HW).astype(np.float32)
    with torch.no_grad(), amp.auto_cast():
        want = cpu_model(torch.from_numpy(x)).float()
    model.cuda()
    xc = torch.from_numpy(x).cuda()
    with torch.no_grad():
        with amp.auto_cast():
            reset_launch_counts()
            got = model(xc).float().cpu()
            counts = launch_counts()
        control = model(xc).float().cpu()
        with amp.auto_cast():
            ms = time_ms(model, [(xc,)] * 2, 10)
    wanted = {name: RN_TRIPLES if name == "conv_bn_relu_mm_affine_relu_bf16" else 0
              for name in counts}
    if counts != wanted:
        raise AssertionError(f"ResNet AMP eval forward launched {counts}; want {wanted}")
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"ResNet AMP eval logits {tuple(got.shape)} not finite or not "
                             f"{tuple(want.shape)}")
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    c_err = float((control - want).abs().max()) / scale
    log(f"ResNet-50 AMP eval forward, batch {batch}: logits err vs the CPU {err:.3g} of the "
        f"largest |logit| {scale:.4g} (limit {RN_AMP_SERVE_RTOL}; the f32 forward {c_err:.3g}); "
        f"{RN_TRIPLES} bf16 eval kernels; forward {ms:.3f} ms, {batch / ms * 1e3:.1f} images/s")
    if err > RN_AMP_SERVE_RTOL:
        raise AssertionError(f"ResNet AMP eval: err {err} beyond {RN_AMP_SERVE_RTOL}")
    return counts, {"logits_rel_err": err, "f32_forward_rel_err": c_err, "forward_ms": ms}


# -- the compiled step: captured CUDA graphs (runtime/compiled.py) -------------------

COMPILED_STEPS = 10  # timed steps of each of the eager and the captured step
PARITY_CALLS = 3  # the compiled step's eager first step and 2 replays
PARITY_SEED = 21
# BERT's AMP step does not repeat itself bit for bit on the card: torch's
# embedding backward over the position and token-type ids differs run to
# run, and two eager runs of 3 steps part in 80% of the weights. Its
# captured losses are held to an atol near the geometric mean of the
# captured reading and the stale-input control, read on an NVIDIA H100
# 80GB HBM3 at 700.00 W:
# captured 1.24e-3 and 9.6e-4 (eager against eager 1.19e-3 and 1.62e-3),
# stale 3.0
BERT_COMPILED_LOSS_ATOL = 5e-2
# AdamW's moments after the 3 calls, relative L2 distance captured/eager,
# by the same rule, read on the same card: captured 2.7e-3 (eager against
# eager 2.44e-3), stale 0.269
BERT_COMPILED_MOMENT_RTOL = 3e-2


@contextlib.contextmanager
def _recorded_draws():
    """Every random draw of the port (``framework.random.draw``: dropout
    masks, attention seeds) copied as it is made. Eager draws go to the
    list last appended to ``rec["eager"]``; the draws a capture records go
    to ``rec["graph"]`` as copies the graph itself makes, so after each
    replay they hold that replay's draws."""
    import torch

    from paddle_tpu_torch.framework import random as prandom

    rec = {"eager": [], "graph": []}
    orig = prandom.draw

    def recording(device, generator, fn):
        out = orig(device, generator, fn)
        if torch.cuda.is_current_stream_capturing():
            rec["graph"].append(out.clone())
        elif rec["eager"]:
            rec["eager"][-1].append(out.clone())
        return out

    prandom.draw = recording
    try:
        yield rec
    finally:
        prandom.draw = orig


def _snapshot(model):
    return [p.detach().clone() for p in model.parameters()]


def _differing(a, b):
    """Entries of two lists of tensors that differ in any bit."""
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def _same_draws(a, b):
    return len(a) == len(b) and all(torch_equal(x, y) for x, y in zip(a, b))


def torch_equal(x, y):
    import torch

    return x.shape == y.shape and bool(torch.equal(x, y))


# launch counter (ops/cuda KERNEL_COUNTERS, less a "_bf16") -> the kind its
# kernel has in a profile (_kernel_kind); the others are named alike
_COUNTER_KINDS = {"conv_bn_relu_mm_affine_relu": "conv_mm", "conv_bn_relu_mm_stats": "conv_mm",
                  "conv_bn_relu_centered_sumsq": "bn_reduce",
                  "conv_bn_relu_bn_bwd_partials": "bn_reduce",
                  "conv_bn_relu_bn_relu": "bn_elementwise",
                  "conv_bn_relu_bn_bwd_dco": "bn_elementwise", "momentum_update": "momentum",
                  "int8_matmul": "int8_mm", "max_pool2d_backward": "pool_bwd"}


def _counter_kind(name):
    base, bf16 = (name[:-len("_bf16")], "_bf16") if name.endswith("_bf16") else (name, "")
    return _COUNTER_KINDS.get(base, base) + bf16


def _booked_by_kind(counts):
    out = {}
    for name, n in counts.items():
        if n:
            kind = _counter_kind(name)
            out[kind] = out.get(kind, 0) + n
    return out


def _profiled_launches(prof):
    """Launches of the port's kernels that a profile saw run on the card, by
    kind: in a replayed graph too, where no wrapper counts. The f32 split-K
    reduce is the second kernel of one counted launch and is left out."""
    from paddle_tpu_torch.ops.cuda import KERNEL_COUNTERS

    ours = {_counter_kind(n) for n in KERNEL_COUNTERS}
    out = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or "conv_mm_reduce" in e.key:
            continue
        kind = _kernel_kind(e.key)
        if kind in ours:
            out[kind] = out.get(kind, 0) + e.count
    return out


def _check_profiled_launches(prof, booked, label):
    """The port's kernels the profile saw run equal, kind by kind, the
    launches the wrappers and the store booked over the same call (a graph
    that dropped or repeated a launch would part them). Returns the
    profile's counts."""
    seen, want = _profiled_launches(prof), _booked_by_kind(booked)
    if seen != want or not seen:
        raise AssertionError(f"{label}: the profile saw the port's kernels run {seen}; "
                             f"the counters booked {want}")
    return seen


def _rel_l2(a, b):
    """Relative L2 distance of two lists of tensors, over all their
    entries (float64 sums)."""
    num = sum(float((x.double() - y.double()).square().sum()) for x, y in zip(a, b))
    den = sum(float(y.double().square().sum()) for y in b)
    return (num / den) ** 0.5 if den else float(num > 0)


def compiled_parity(make_model, make_step, batches, label, lr, draws, loss_atol,
                    moment_rtol):
    """From identical weights and generator state, ``PARITY_CALLS`` calls on
    the batches ``b0, b1, b0`` of: the compiled step (its eager first step,
    then replays); the same calls run eagerly (``TrainStepFn.eager``: the
    same arithmetic, no graph); those eager calls once more (the repeat:
    whether eager repeats itself bit for bit); and eager calls on ``b0``
    three times (the stale-input control: what a replay that missed its
    new batch would compute). Where the repeat is bit-exact the captured
    losses and weights must equal the eager ones bit for bit; else each
    captured loss must lie within ``loss_atol`` of the eager one, and the
    stale control beyond it. The optimizer's accumulators (AdamW's
    moments, Momentum's velocities) are held the same way (bit for bit, or
    a relative L2 distance within ``moment_rtol`` with the stale control
    beyond it), and every run's host and device step counts must both be
    ``PARITY_CALLS`` (a graph that froze the step count would leave the
    device's behind). With ``draws``, every random draw of the
    captured calls must equal the eager step's and every draw of the second
    replay differ from the first's (a frozen seed would repeat it). Then a
    replay at lr 0 must leave every weight bit-identical and one at ``lr``
    move them (a frozen lr would not). Returns the readings."""
    from paddle_tpu_torch.framework import random as prandom

    base = make_model()
    order = (batches[0], batches[1], batches[0])
    runs = {}
    with _recorded_draws() as rec:
        for name in ("captured", "eager", "repeat", "stale"):
            model = copy.deepcopy(base)
            step = make_step(model)
            prandom.seed(PARITY_SEED)
            losses, step_draws, grads = [], [], None
            for i in range(PARITY_CALLS):
                rec["eager"].append([])
                b = batches[0] if name == "stale" else order[i]
                out = step(*b) if name == "captured" else step.eager(*b)
                losses.append(float(out["loss"]))
                step_draws.append([g.clone() for g in rec["graph"]]
                                  if name == "captured" and i else rec["eager"][-1])
                if i == 0 and name in ("eager", "repeat"):
                    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            opt = step.optimizer
            runs[name] = {"losses": losses, "params": _snapshot(model), "grads": grads,
                          "moments": [a.clone() for accs in opt._accumulators.values()
                                      for a in accs],
                          "step_count": (opt._global_step, int(opt._step_t)),
                          "draws": step_draws if draws and name in ("captured", "eager")
                          else None}
            rec["graph"].clear()
            rec["eager"].clear()
            if name == "captured":
                runs[name].update(step=step, model=model)
            del step, model
    cap, eag, rep, stale = (runs.pop(k) for k in ("captured", "eager", "repeat", "stale"))
    entries = cap["step"].store.entries()
    r = {"losses_captured": cap["losses"], "losses_eager": eag["losses"],
         "losses_repeat": rep["losses"], "losses_stale": stale["losses"],
         "loss_err": max(abs(a - b) for a, b in zip(cap["losses"], eag["losses"])),
         "repeat_loss_err": max(abs(a - b) for a, b in zip(rep["losses"], eag["losses"])),
         "stale_loss_err": abs(stale["losses"][1] - eag["losses"][1]),
         "loss_atol": loss_atol,
         "params_differing": _differing(cap["params"], eag["params"]),
         "repeat_params_differing": _differing(rep["params"], eag["params"]),
         "params": sum(int(p.numel()) for p in cap["params"]),
         "step_counts": {"captured": cap["step_count"], "eager": eag["step_count"]},
         "moments_differing": _differing(cap["moments"], eag["moments"]),
         "repeat_moments_differing": _differing(rep["moments"], eag["moments"]),
         "moments": sum(int(a.numel()) for a in cap["moments"]),
         "moment_err": _rel_l2(cap["moments"], eag["moments"]),
         "repeat_moment_err": _rel_l2(rep["moments"], eag["moments"]),
         "stale_moment_err": _rel_l2(stale["moments"], eag["moments"]),
         "moment_rtol": moment_rtol,
         "repeat_first_grads_differing": sorted(
             n for n in eag["grads"] if not torch_equal(eag["grads"][n], rep["grads"][n])),
         "store": {"entries": len(entries), "hits": cap["step"].store.hits,
                   "misses": cap["step"].store.misses,
                   "cache_keys": [e.cache_key for e in entries.values()]}}
    repeat_exact = r["repeat_loss_err"] == 0 and r["repeat_params_differing"] == 0
    if draws:
        r["draws_a_step"] = len(eag["draws"][0])
        r["draws_equal_eager"] = [_same_draws(c, e) for c, e in zip(cap["draws"], eag["draws"])]
        r["replay_draws_differing"] = sum(not torch_equal(a, b) for a, b in
                                          zip(cap["draws"][1], cap["draws"][2]))
    eag = rep = stale = None
    step, model = cap["step"], cap["model"]
    before = _snapshot(model)
    step.optimizer.set_lr(0.0)
    step(*batches[0])
    r["lr0_params_differing"] = _differing(before, _snapshot(model))
    step.optimizer.set_lr(lr)
    step(*batches[0])
    r["lr_params_differing"] = _differing(before, _snapshot(model))
    log(f"{label} parity, calls on b0, b1, b0 from one state: losses captured "
        f"{r['losses_captured']}, eager {r['losses_eager']}, eager repeat "
        f"{r['losses_repeat']}, stale (b0 thrice) {r['losses_stale']}; loss err captured/eager "
        f"{r['loss_err']:.3g}, repeat/eager {r['repeat_loss_err']:.3g}, stale/eager "
        f"{r['stale_loss_err']:.3g} (atol {loss_atol}); weights differing captured/eager "
        f"{r['params_differing']}, repeat/eager {r['repeat_params_differing']} of "
        f"{r['params']}; first-step gradients differing repeat/eager "
        f"{len(r['repeat_first_grads_differing'])}: {r['repeat_first_grads_differing'][:12]}; "
        f"draws equal to the eager step's {r.get('draws_equal_eager')}, differing between "
        f"replays {r.get('replay_draws_differing')} of {r.get('draws_a_step')}; a replay at lr 0 "
        f"moved {r['lr0_params_differing']} weights, one at lr {lr} "
        f"{r['lr_params_differing']}; store {r['store']}; step counts (host, device) "
        f"{r['step_counts']}; accumulator entries differing captured/eager "
        f"{r['moments_differing']}, repeat/eager {r['repeat_moments_differing']} of "
        f"{r['moments']}, relative L2 captured/eager {r['moment_err']:.3g}, repeat/eager "
        f"{r['repeat_moment_err']:.3g}, stale/eager {r['stale_moment_err']:.3g} "
        f"(rtol {moment_rtol})")
    if draws and (not all(r["draws_equal_eager"]) or not r["draws_a_step"]):
        raise AssertionError(f"{label}: the captured step's random draws differ from the "
                             f"eager step's from the same generator state: {r}")
    if draws and r["replay_draws_differing"] != r["draws_a_step"]:
        raise AssertionError(f"{label}: only {r['replay_draws_differing']} of "
                             f"{r['draws_a_step']} draws differ between consecutive replays: "
                             "a frozen seed")
    if r["lr0_params_differing"] != 0 or r["lr_params_differing"] == 0:
        raise AssertionError(f"{label}: the replayed lr is frozen: {r}")
    if repeat_exact and (r["loss_err"] or r["params_differing"]):
        raise AssertionError(f"{label}: the captured steps part from the eager ones, which "
                             f"repeat themselves bit for bit: {r}")
    if not repeat_exact and not r["loss_err"] <= loss_atol < r["stale_loss_err"]:
        raise AssertionError(f"{label}: captured loss err {r['loss_err']} or the stale "
                             f"control's {r['stale_loss_err']} against atol {loss_atol}: {r}")
    if r["stale_loss_err"] == 0:
        raise AssertionError(f"{label}: the stale-input control equals the eager run: {r}")
    if set(r["step_counts"].values()) != {(PARITY_CALLS, PARITY_CALLS)}:
        raise AssertionError(f"{label}: host and device step counts {r['step_counts']} after "
                             f"{PARITY_CALLS} calls")
    if repeat_exact and r["moments_differing"]:
        raise AssertionError(f"{label}: {r['moments_differing']} optimizer accumulator entries "
                             "part from the eager run's, which repeats itself bit for bit")
    if not repeat_exact and not r["moment_err"] <= moment_rtol < r["stale_moment_err"]:
        raise AssertionError(f"{label}: accumulators' relative L2 distance captured/eager "
                             f"{r['moment_err']}, stale control {r['stale_moment_err']}, "
                             f"against {moment_rtol}")
    return r


def _step_device_ms(step, batch, iters=COMPILED_STEPS):
    """Device ms a step with the host hidden behind a sleep kernel
    (:func:`device_ms`), and its host ms."""
    return device_ms(lambda: step(*batch), iters)


def compiled_timing(make_model, make_step, batch, label, units, unit_name):
    """The eager step (``jit=False``) and the compiled one (``jit=True``)
    from the same weights, ``COMPILED_STEPS`` timed steps each after a first
    step (the compiled one's eager first step and capture): median step,
    host clock, device busy in a profiled step, device time with the host
    hidden, peak memory, launch counts a step, which must be equal, and
    the port's kernels a profiled step saw run, which must equal what its
    counters booked. Returns (the captured run's launches, readings)."""
    import torch

    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    out = {}
    for name, jit in (("eager", False), ("captured", True)):
        torch.cuda.empty_cache()
        model = make_model()
        step = make_step(model, jit)
        prandom.seed(PARITY_SEED)
        losses, step_ms, wall_ms, counts, peak = _timed_steps(step, batch, COMPILED_STEPS)
        reset_launch_counts()
        prof = _profile_step(step, batch, f"{label} {name} step profiled")
        profiled = _check_profiled_launches(prof, launch_counts(), f"{label} {name}")
        by_kind, events = _device_time_by_kind(prof)
        dev_ms, host_ms = _step_device_ms(step, batch)
        median = float(np.median(step_ms))
        out[name] = {"losses": losses, "step_ms": step_ms, "step_ms_median": median,
                     "host_clock_ms": wall_ms, "busy_ms": sum(by_kind.values()),
                     "device_ms_by_kind": by_kind,
                     "device_events": events, "device_ms_host_hidden": dev_ms,
                     "host_ms_a_call": host_ms, "peak_gib": peak,
                     f"{unit_name}_per_s": units / median * 1e3,
                     "launches_a_step": {k: v // COMPILED_STEPS for k, v in counts.items() if v},
                     "launches_profiled": profiled, "counts": counts}
        if not all(np.isfinite(losses)) or not min(losses[1:]) < losses[0]:
            raise AssertionError(f"{label} {name}: losses not finite or not falling: {losses}")
        log(f"{label} {name} (jit={jit}): {COMPILED_STEPS} steps, median {median:.3f} ms "
            f"(mean {float(np.mean(step_ms)):.3f}, min {min(step_ms):.3f}, max {max(step_ms):.3f}; "
            f"host clock {wall_ms:.3f}), {units / median * 1e3:.1f} {unit_name}/s; device busy "
            f"{out[name]['busy_ms']:.3f} ms in {events} device events of a profiled step; "
            f"{dev_ms:.3f} device ms a step with the host hidden ({host_ms:.3f} host ms a "
            f"call); peak {peak:.2f} GiB; launches a step {out[name]['launches_a_step']}, seen "
            f"run by the profiler {profiled}")
        del model, step, prof
    if out["captured"]["counts"] != out["eager"]["counts"]:
        raise AssertionError(f"{label}: the captured steps launched {out['captured']['counts']}, "
                             f"the eager ones {out['eager']['counts']}")
    counts = out["captured"].pop("counts")
    out["eager"].pop("counts")
    return counts, out


def compiled_bert_amp():
    """bench.py's BERT-base step under ``auto_cast`` (O1, batch 32 x L=512,
    80 masked a row, dropout 0.1, AdamW lr 1e-4) through
    ``train_step(jit=True)``: the parity calls with their draws, then the
    eager and the captured step side by side. Returns (the captured run's
    launches, readings)."""
    import torch

    from paddle_tpu_torch.models import bert_base_config

    cfg = bert_base_config()  # hidden and attention dropout 0.1
    cfg.use_flash_attention = True
    base, loss_fn = _pretraining(cfg, seed=1)
    loss_fn = _amp_loss_fn(loss_fn, "O1")
    batch = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(9))]

    def make_model():
        return copy.deepcopy(base)

    other = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(10))]
    parity = compiled_parity(make_model, lambda m: _step_of(m, loss_fn, jit=True),
                             (batch, other), "BERT AMP compiled step", 1e-4, draws=True,
                             loss_atol=BERT_COMPILED_LOSS_ATOL,
                             moment_rtol=BERT_COMPILED_MOMENT_RTOL)
    torch.cuda.empty_cache()
    counts, timing = compiled_timing(make_model, lambda m, jit: _step_of(m, loss_fn, jit=jit),
                                     batch, "BERT AMP", TRAIN_B * TRAIN_SEQ, "tokens")
    want = _amp_launches("O1", cfg.num_hidden_layers, COMPILED_STEPS)
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"BERT AMP compiled: {counts}; want {want}")
    return counts, {"parity": parity, **timing}


def compiled_resnet_amp():
    """bench.py's ResNet-50 step under ``auto_cast`` (O1, batch 128 x 224²,
    Momentum lr 0.1 / 0.9, the pool kernel on) through
    ``train_step(jit=True)``: the parity calls, then the eager and the
    captured step side by side. Returns (the captured run's launches,
    readings)."""
    import torch

    from paddle_tpu_torch.flags import set_flags

    rng = np.random.RandomState(15)
    batch = [torch.from_numpy(rng.randn(RN_B, 3, RN_HW, RN_HW).astype(np.float32)).cuda(),
             torch.from_numpy(rng.randint(0, RN_CLASSES, (RN_B,)).astype(np.int64)).cuda()]
    base = _resnet50(seed=1)
    set_flags({"use_pallas_pool_bwd": True})
    try:
        other = [torch.from_numpy(rng.randn(RN_B, 3, RN_HW, RN_HW).astype(np.float32)).cuda(),
                 torch.from_numpy(rng.randint(0, RN_CLASSES, (RN_B,)).astype(np.int64)).cuda()]
        parity = compiled_parity(
            lambda: copy.deepcopy(base),
            lambda m: _rn_step_of(m, loss_fn=_rn_amp_loss, jit=True), (batch, other),
            "ResNet-50 AMP compiled step", RN_LR, draws=False, loss_atol=0.0, moment_rtol=0.0)
        torch.cuda.empty_cache()
        counts, timing = compiled_timing(
            lambda: copy.deepcopy(base),
            lambda m, jit: _rn_step_of(m, loss_fn=_rn_amp_loss, jit=jit), batch, "ResNet-50 AMP",
            RN_B, "images")
    finally:
        set_flags({"use_pallas_pool_bwd": False})
    if counts != _rn_amp_step_launches(COMPILED_STEPS):
        raise AssertionError(f"ResNet AMP compiled: {counts}")
    return counts, {"parity": parity, **timing}


COMPILED_EVAL_BATCHES = (1, 8)
COMPILED_EVAL_CALLS = 20


def compiled_eval_resnet_amp():
    """``eval_step`` of ResNet-50 under ``auto_cast`` at batch 1 and 8 (the
    bf16 eval kernel with split-K, row 8d): the captured forward bit-equal
    to the eager one (``jit=False``), with the same launches and split-K
    calls a forward, and the launches a profiled forward saw run equal to
    the booked ones; wall a call (host clock to the answer on the card)
    against the device's busy time. Returns (the captured forwards'
    launches, readings)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework.jit import eval_step
    from paddle_tpu_torch.ops.cuda import KERNEL_COUNTERS, launch_counts, reset_launch_counts
    from paddle_tpu_torch.ops.cuda import counts as all_counts

    def forward(m, x):
        with amp.auto_cast():
            return m(x)

    model = _resnet50(seed=0)
    total, out = {}, {}
    for batch in COMPILED_EVAL_BATCHES:
        x = torch.from_numpy(np.random.RandomState(18 + batch).randn(
            batch, 3, RN_HW, RN_HW).astype(np.float32)).cuda()
        steps = {"eager": eval_step(model, forward, jit=False),
                 "captured": eval_step(model, forward, jit=True)}
        r = {}
        steps["captured"](x)  # the eager first run and the capture
        for name, step in steps.items():
            step(x)
            torch.cuda.synchronize()
            reset_launch_counts()
            got = step(x)
            torch.cuda.synchronize()
            counts = all_counts()
            t0 = time.perf_counter()
            for _ in range(COMPILED_EVAL_CALLS):
                step(x)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / COMPILED_EVAL_CALLS
            reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(x)
                torch.cuda.synchronize()
            profiled = _check_profiled_launches(prof, launch_counts(),
                                                f"ResNet AMP eval_step batch {batch} {name}")
            by_kind, events = _device_time_by_kind(prof)
            r[name] = {"logits": got, "counts": counts, "wall_ms": wall,
                       "busy_ms": sum(by_kind.values()), "device_events": events,
                       "launches_profiled": profiled}
        e, c = r["eager"], r["captured"]
        if c["counts"] != e["counts"] or e["counts"]["conv_bn_relu_mm_affine_relu_bf16"] != \
                RN_TRIPLES:
            raise AssertionError(f"ResNet AMP eval_step batch {batch}: captured launched "
                                 f"{c['counts']}, eager {e['counts']}")
        if not torch.equal(c["logits"], e["logits"]) or not torch.isfinite(c["logits"]).all():
            raise AssertionError(f"ResNet AMP eval_step batch {batch}: the captured logits differ "
                                 "from the eager ones or are not finite")
        splits = c["counts"]["conv_bn_relu.MM_AFFINE_RELU_SPLITS"]
        out[f"batch_{batch}"] = {n: {k: v for k, v in r[n].items() if k not in ("logits",
                                                                                "counts")}
                                 for n in r}
        out[f"batch_{batch}"]["split_k_products"] = splits
        log(f"ResNet-50 AMP eval_step batch {batch}: captured logits bit-equal to eager, "
            f"{RN_TRIPLES} bf16 eval launches ({splits} split-K) a forward in both; wall a call "
            f"eager {e['wall_ms']:.3f} ms, captured {c['wall_ms']:.3f} ms; device busy eager "
            f"{e['busy_ms']:.3f} ms ({e['device_events']} events), captured "
            f"{c['busy_ms']:.3f} ms ({c['device_events']} events)")
        for k in KERNEL_COUNTERS:  # the one replayed forward's
            total[k] = total.get(k, 0) + c["counts"][k]
        del steps, r
    return total, out


def check_capture_refusals():
    """On the card nothing gives way to eager: a step that draws from a
    generator its capture did not register raises ``CaptureError`` after
    its one real first step, and the next call raises before it runs
    anything, with no graph stored and the weights as that first step left
    them; a ``GradScaler`` inside a compiled step raises. Returns the
    readings."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.runtime.compiled import CaptureError

    own = torch.Generator(device="cuda").manual_seed(3)
    model = torch.nn.Linear(64, 64)

    def loss_fn(m, x):
        return F.dropout(m(x), 0.5, generator=own).square().mean()

    step = train_step(model, Momentum(learning_rate=0.1, parameters=model.parameters()),
                      loss_fn)
    x = torch.randn(8, 64, device="cuda")
    errors, weights = [], []
    for _ in range(2):
        try:
            step(x)
        except CaptureError as e:
            errors.append(str(e)[:200])
        else:
            raise AssertionError("a step drawing from an unregistered generator was captured")
        torch.cuda.synchronize()
        weights.append(_snapshot(model))
    opt = step.optimizer
    if (len(step.store) or (opt._global_step, int(opt._step_t)) != (1, 1)
            or _differing(*weights) or "failed before" not in errors[1]):
        raise AssertionError(f"after a refused capture and a second call: {len(step.store)} "
                             f"graphs, step counts {opt._global_step} and {int(opt._step_t)} "
                             f"(want 0, 1 and 1), {_differing(*weights)} weights moved by the "
                             f"second call; errors {errors}")
    scaler = amp.GradScaler()

    def scaled(m, x):
        scaler.unscale_(step.optimizer)
        return m(x).square().mean()

    try:
        train_step(model, step.optimizer, scaled)(x)
    except RuntimeError as e:
        scaler_error = str(e)[:200]
    else:
        raise AssertionError("GradScaler ran inside a compiled step")
    log(f"capture refusals: unregistered generator -> {errors[0]}; its second call -> "
        f"{errors[1]}; GradScaler -> {scaler_error}")
    return {"unregistered_generator": errors, "grad_scaler": scaler_error}


FEATURE_WIDTH, FEATURE_ROWS, FEATURE_DROPOUT = 1024, 256, 0.1


def compiled_features():
    """``grad_accum_steps=2`` (two captured variants, accumulate and
    accumulate + apply, sharing one buffer) and ``recompute=True``
    (``torch.utils.checkpoint`` with the port's draws taped) captured on
    the card: an MLP with dropout drawn through the port, AdamW lr 1e-3,
    calls on ``b0, b1, b0, b1`` from one state and generator seed, the
    captured step's losses, weights, moments and draws held bit for bit
    against the same calls run eagerly (``TrainStepFn.eager``), its step
    counts against the calls that applied the optimizer, and its draws new
    at each replay. Returns the readings."""
    import torch

    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    torch.manual_seed(5)
    base = torch.nn.Sequential(torch.nn.Linear(FEATURE_WIDTH, FEATURE_WIDTH), torch.nn.ReLU(),
                               torch.nn.Linear(FEATURE_WIDTH, FEATURE_WIDTH)).cuda()

    def loss_fn(m, x, t):
        h = F.dropout(torch.relu(m[0](x)), FEATURE_DROPOUT)
        return (m[2](h) - t).square().mean()

    rng = np.random.RandomState(23)
    batches = [[torch.from_numpy(rng.randn(FEATURE_ROWS, FEATURE_WIDTH).astype(np.float32)).cuda()
                for _ in range(2)] for _ in range(2)]
    order = (batches[0], batches[1], batches[0], batches[1])
    out = {}
    # feature: (its arguments, the calls of the four that apply the optimizer,
    # the captured variants)
    for feature, (kw, applies, variants) in {
            "grad_accum_steps=2": (dict(grad_accum_steps=2), 2, 2),
            "grad_accum_steps=2 grad_accum_avg=False":
                (dict(grad_accum_steps=2, grad_accum_avg=False), 2, 2),
            "recompute=True": (dict(recompute=True), 4, 1)}.items():
        runs = {}
        with _recorded_draws() as rec:
            for name in ("captured", "eager"):
                model = copy.deepcopy(base)
                step = train_step(model, AdamW(learning_rate=1e-3, parameters=model.parameters()),
                                  loss_fn, **kw)
                prandom.seed(PARITY_SEED)
                losses, draws = [], []
                for i, b in enumerate(order):
                    rec["eager"].append([])
                    out_i = step(*b) if name == "captured" else step.eager(*b)
                    losses.append(float(out_i["loss"]))
                    torch.cuda.synchronize()
                    if name == "eager" or i < variants:  # a first run: eager draws
                        draws.append(rec["eager"][-1])
                    else:  # the draws the replayed graph (one of variants) recorded
                        per = len(rec["graph"]) // variants
                        v = i % variants
                        draws.append([g.clone() for g in rec["graph"][v * per:(v + 1) * per]])
                opt = step.optimizer
                runs[name] = {"losses": losses, "params": _snapshot(model), "draws": draws,
                              "moments": [a.clone() for accs in opt._accumulators.values()
                                          for a in accs],
                              "step_count": (opt._global_step, int(opt._step_t)),
                              "graphs": len(step.store)}
                rec["graph"].clear()
                rec["eager"].clear()
                del step, model
        c, e = runs["captured"], runs["eager"]
        r = {"losses_captured": c["losses"], "losses_eager": e["losses"],
             "params_differing": _differing(c["params"], e["params"]),
             "moments_differing": _differing(c["moments"], e["moments"]),
             "draws_equal_eager": [_same_draws(a, b) for a, b in zip(c["draws"], e["draws"])],
             "draws_a_call": [len(d) for d in c["draws"]],
             "step_counts": {"captured": c["step_count"], "eager": e["step_count"]},
             "graphs": c["graphs"]}
        # the last call against the one two before: the same variant
        r["replay_draws_differing"] = sum(not torch_equal(a, b) for a, b in
                                          zip(c["draws"][-3], c["draws"][-1]))
        log(f"compiled {feature}: losses captured {c['losses']}, eager {e['losses']}; weights "
            f"differing {r['params_differing']}, moments differing {r['moments_differing']}; "
            f"draws a call {r['draws_a_call']}, equal to eager {r['draws_equal_eager']}, "
            f"differing between the last call and the one two before "
            f"{r['replay_draws_differing']}; step counts "
            f"(host, device) {r['step_counts']}; {r['graphs']} graphs")
        if (c["losses"] != e["losses"] or r["params_differing"] or r["moments_differing"]
                or not all(r["draws_equal_eager"]) or not all(r["draws_a_call"])
                or r["replay_draws_differing"] != r["draws_a_call"][-1]
                or set(r["step_counts"].values()) != {(applies, applies)}
                or r["graphs"] != variants):
            raise AssertionError(f"compiled {feature}: the captured calls part from the eager "
                                 f"ones: {r}")
        out[feature] = r
    return out


BIAS_T = 10000  # steps at which the card's bias correction is read


def bias_correction_on_card():
    """AdamW's compiled bias correction ``1 - beta**t`` on the card, as
    ``Adam._bias_corrections`` computes it there (``optimizer._bias_correction``:
    the power of the float32 ``beta`` widened and the int32 ``t`` in
    float64, rounded once to float32), for t = 1..``BIAS_T`` on 0-dim
    operands, as the optimizer's: it must equal the same formula on the CPU
    bit for bit at every t. Logs where it differs from the CPU's float32
    ``pow`` (the JAX compiled step's value) and by how many float32 ulps.
    Returns the readings."""
    import torch

    from paddle_tpu_torch.optimizer import _bias_correction

    out = {}
    t_card = list(torch.arange(1, BIAS_T + 1, dtype=torch.int32, device="cuda"))
    t_cpu = list(torch.arange(1, BIAS_T + 1, dtype=torch.int32))
    for beta in (0.9, 0.999):
        card = torch.stack([_bias_correction(beta, t) for t in t_card]).cpu()
        f64 = torch.stack([_bias_correction(beta, t) for t in t_cpu])
        b = torch.full((), beta, dtype=torch.float32)
        f32 = torch.stack([1 - b**t for t in t_cpu])  # 0-dim, as the CPU step's
        apart = (card != f64).nonzero().flatten()
        diff = (card != f32).nonzero().flatten()
        ulps = (np.abs(card.numpy().astype(np.float64) - f32.numpy())
                / np.spacing(np.abs(f32.numpy())))
        out[str(beta)] = {"t_differing_from_cpu_float64_route": int(apart.numel()),
                          "t_differing_from_cpu_float32_pow": int(diff.numel()), "of": BIAS_T,
                          "t_float32_pow": [int(i) + 1 for i in diff[:8]],
                          "max_ulps_float32_pow": float(ulps.max())}
        log(f"bias correction 1 - {beta}**t on the card, t = 1..{BIAS_T}: {out[str(beta)]}")
        if apart.numel():
            raise AssertionError(f"bias correction {beta}: the card parts from the CPU's float64 "
                                 f"route at t = {[int(i) + 1 for i in apart[:8]]}")
    return out


def compiled_steps():
    """Phase 12b. Returns (the captured runs' launches, readings)."""
    import torch

    torch.cuda.empty_cache()
    bert_counts, bert = compiled_bert_amp()
    torch.cuda.empty_cache()
    rn_counts, rn = compiled_resnet_amp()
    torch.cuda.empty_cache()
    eval_counts, ev = compiled_eval_resnet_amp()
    features = compiled_features()
    refusals = check_capture_refusals()
    bias = bias_correction_on_card()
    counts = {k: bert_counts.get(k, 0) + rn_counts.get(k, 0) + eval_counts.get(k, 0)
              for k in bert_counts}
    return counts, {"bert_amp": bert, "resnet_amp": rn, "resnet_amp_eval": ev,
                    "features": features, "refusals": refusals, "bias_correction": bias}


# -- Transformer-base seq2seq and ERNIE-base (BASELINE.json's fifth config) ----------

# Transformer-base (Vaswani et al. 2017): 512 wide, 8 heads, 6 + 6 layers, FFN
# 2048, dropout 0.1, over WMT14 En-De's shared 37,000-token vocabulary
S2S_VOCAB, S2S_D, S2S_HEADS, S2S_LAYERS, S2S_FFN, S2S_DROPOUT = 37000, 512, 8, 6, 2048, 0.1
S2S_B, S2S_SRC, S2S_TGT = 64, 64, 64  # pairs a step, source and target tokens a pair
S2S_ROWS = S2S_B * S2S_TGT  # the LayerNorm rows of the decoder: [4096, 512]
# the paper's schedule, NoamDecay(d_model=512, warmup_steps=4000, learning_rate=1.0),
# and ClipGradByGlobalNorm(1.0). The timed runs take the schedule up at step 1000
# (lr 1.75e-4, rising): from step 1 their 11 steps would run at 1.7e-7 to 1.9e-6,
# too little for the falling-loss check to see through dropout's noise.
S2S_WARMUP, S2S_CLIP, S2S_NOAM_START = 4000, 1.0, 1000
S2S_BOS, S2S_EOS, S2S_PAD = 0, 1, 2  # TransformerSeq2Seq's defaults
# post-norm residual LayerNorms a forward: 2 an encoder layer, 3 a decoder layer;
# under AMP the first of each stack adds a bf16 sublayer output to the f32
# embedding sum (the mixed forward, the f32 backward)
S2S_ENC_NORMS, S2S_DEC_NORMS = 2 * S2S_LAYERS, 3 * S2S_LAYERS
# The AMP step at batch 2 against the CPU's plain path under the same
# auto_cast, read on an NVIDIA H100 80GB HBM3 at 700.00 W: loss 1.6e-4
# apart, gradient rel L2 0.0139, 0.762 of the gradient entries differing in
# some bit; the f32 step (the control) 8.2e-5, 0.0197, 1.000. As for BERT
# the loss and L2 limits (about 6 and 2.5 times the reading) catch gross
# faults only; the share of differing entries is held near the geometric
# mean of the two readings, which the f32 control must fail. The f32
# teacher-forced logits read 1.4e-6 of the largest |logit| from the CPU's,
# TF32 (the control) 1.03e-3.
S2S_AMP_LIMITS = {"loss": 1e-3, "grad_rel_l2": 0.035}
S2S_AMP_GRAD_DIFFERING = 0.87
S2S_LOGITS_RTOL = 3e-5
# decoding: the card's greedy tokens, and the hypotheses each beam step
# keeps, must equal the CPU's at every step before the first whose CPU
# margin is under this: the top-two logits' gap (greedy), the gap between
# the last total kept and the first dropped (beam). It is ~700 times the
# f32 logits' card-vs-CPU error at batch 2 (1.4e-6 of the largest |logit|,
# PERF.md section 2) and ~10 times that error summed over 31 steps.
S2S_MARGIN = 1e-3
S2S_GREEDY_B, S2S_BEAM_B, S2S_BEAM, S2S_DECODE_LEN = 16, 4, 4, 32
# ERNIE-base at bench's BERT phase 2: batch 32 x 512, 80 masked a row
ERNIE_MASK_ID = 3  # ERNIE 1.0's [MASK]


def _seq2seq(seed, dropout=S2S_DROPOUT):
    import torch

    from paddle_tpu_torch.models import TransformerSeq2Seq

    return TransformerSeq2Seq(S2S_VOCAB, S2S_VOCAB, d_model=S2S_D, nhead=S2S_HEADS,
                              num_layers=S2S_LAYERS, dim_feedforward=S2S_FFN, dropout=dropout,
                              generator=torch.Generator().manual_seed(seed))


def s2s_batch(batch, rng):
    """A synthetic translation batch: source ids with seeded pad tails (at
    least half of each row real), the target fed in (BOS first) and the
    target to predict (EOS after the last real token, pads after that)."""
    src = rng.randint(3, S2S_VOCAB, (batch, S2S_SRC)).astype(np.int64)
    body = rng.randint(3, S2S_VOCAB, (batch, S2S_TGT)).astype(np.int64)
    tin = np.concatenate([np.full((batch, 1), S2S_BOS, np.int64), body[:, :-1]], axis=1)
    tout = body.copy()
    for i in range(batch):
        n = rng.randint(S2S_SRC // 2, S2S_SRC + 1)
        src[i, n:] = S2S_PAD
        t = rng.randint(S2S_TGT // 2, S2S_TGT + 1)
        tout[i, t - 1], tout[i, t:], tin[i, t:] = S2S_EOS, S2S_PAD, S2S_PAD
    return [src, tin, tout]


def _s2s_loss(m, src, tin, tout):
    """The pad-masked cross entropy of tests/test_book.py's WMT14 test."""
    from paddle_tpu_torch.nn import functional as F

    logits = m(src, tin)
    mask = (tout != S2S_PAD).float()
    ce = F.cross_entropy(logits.reshape(-1, S2S_VOCAB), tout.reshape(-1), reduction="none")
    return (ce * mask.reshape(-1)).sum() / mask.sum()


def _noam_lr(step, d_model=S2S_D, warmup=S2S_WARMUP, base=1.0):
    """``paddle_tpu/optimizer/lr.py`` ``NoamDecay.get_lr``, copied: the value
    the port's schedule must give at ``step``."""
    step = max(step, 1)
    return base * d_model**-0.5 * min(step**-0.5, step * warmup**-1.5)


class _NoamStep:
    """A train step under ``NoamDecay``: each call runs the step, keeps the
    lr the optimizer read (under ``jit=True`` a copy of the float32 on the
    card that the step wrote before its replay; else the host float) and the
    schedule's step, then advances the schedule."""

    def __init__(self, step, sched, record):
        self.step, self.sched = step, sched
        self.record = record  # {"lrs": [...], "epochs": [...], "store": ...}
        record.update(lrs=[], epochs=[], store=step.store)

    def __call__(self, *batch):
        out = self.step(*batch)
        opt = self.step.optimizer
        self.record["lrs"].append(opt._lr_t.clone() if self.step.jit else opt.get_lr())
        self.record["epochs"].append(self.sched.last_epoch)
        self.sched.step()
        return out


def _s2s_step_of(model, loss_fn, device=None, jit=False, start=0, record=None):
    """Adam(0.9, 0.98, 1e-9), the paper's moments, under
    ``NoamDecay(512, 4000, 1.0)`` from step ``start`` (0: the first) with
    ``ClipGradByGlobalNorm(1.0)``; ``record`` (a dict) receives the lrs
    (:class:`_NoamStep`)."""
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.optimizer import Adam, ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer.lr import NoamDecay

    sched = NoamDecay(d_model=S2S_D, warmup_steps=S2S_WARMUP, learning_rate=1.0,
                      last_epoch=start - 1)
    opt = Adam(learning_rate=sched, beta1=0.9, beta2=0.98, epsilon=1e-9,
               parameters=model.parameters(), grad_clip=ClipGradByGlobalNorm(S2S_CLIP))
    step = train_step(model, opt, loss_fn, device=device, jit=jit)
    return _NoamStep(step, sched, {} if record is None else record)


def _check_noam(records):
    """The lr each step of the seq2seq runs read: eagerly the schedule's
    float, captured the float32 on the card equal to that float rounded to
    float32 (``_noam_lr``, the JAX package's formula), a new value at every
    step; and the captured run's store one graph, captured once. Returns
    the readings."""
    import torch

    out = {}
    for name, rec in records.items():
        want = [_noam_lr(e) for e in rec["epochs"]]
        if name == "captured":
            got = torch.stack(rec["lrs"]).cpu().numpy().tolist()
            want = [float(np.float32(w)) for w in want]
        else:
            got = rec["lrs"]
        store = rec["store"]
        if got != want or len(set(want)) != len(want):
            raise AssertionError(f"seq2seq {name}: the steps read lrs {got[:4]}...; the "
                                 f"schedule gives {want[:4]}...")
        if name == "captured" and (len(store) != 1 or store.misses != 1):
            raise AssertionError(f"seq2seq captured under Noam: {len(store)} graphs, "
                                 f"{store.misses} captures; want one of each")
        out[name] = {"steps": len(got), "first_lr": got[0], "last_lr": got[-1],
                     "schedule_steps": [rec["epochs"][0], rec["epochs"][-1]],
                     "graphs": len(store), "captures": store.misses}
    log(f"seq2seq under NoamDecay(512, 4000) from step {S2S_NOAM_START}: every step's lr "
        f"equals the schedule's ({out['captured']['steps']} captured steps read the float32 "
        f"on the card, {out['captured']['first_lr']:.6g} to {out['captured']['last_lr']:.6g}); "
        f"one graph, captured once")
    return out


def _s2s_launches(amp, steps=1, backward=True):
    """LayerNorm launches of ``steps`` seq2seq steps (forwards when not
    ``backward``): every residual norm of the encoder and decoder, in f32,
    or under AMP the mixed case at the first norm of each stack and bf16
    at the rest."""
    norms = S2S_ENC_NORMS + S2S_DEC_NORMS
    if amp:
        want = {"layernorm_residual_fwd_mixed": 2, "layernorm_residual_fwd_bf16": norms - 2}
        if backward:
            want.update(layernorm_residual_bwd=2, layernorm_residual_bwd_bf16=norms - 2)
    else:
        want = {"layernorm_residual_fwd": norms}
        if backward:
            want["layernorm_residual_bwd"] = norms
    return {k: v * steps for k, v in want.items()}


def check_layernorm_h512():
    """Rows 1, 1b, 2 and 2b at the seq2seq path's [4096, 512] (H = 512, the
    width no other path gives them): f32, bf16 and the mixed case (through
    the op, forward and backward), each with the existing limits, timed
    beside its bound and ``F.layer_norm``. Returns {kernel name: entry}."""
    out = {"layernorm_residual_fwd": check_layernorm("float32", S2S_ROWS, S2S_D),
           "layernorm_residual_fwd_bf16": check_layernorm("bfloat16", S2S_ROWS, S2S_D),
           "layernorm_residual_fwd_mixed": check_layernorm_mixed(S2S_ROWS, S2S_D),
           "layernorm_residual_bwd": check_layernorm_bwd("float32", S2S_ROWS, S2S_D),
           "layernorm_residual_bwd_bf16": check_layernorm_bwd("bfloat16", S2S_ROWS, S2S_D)}
    for e in out.values():
        e["path"] = "Transformer-base seq2seq"
    return out


def s2s_parity():
    """Transformer-base at dropout 0 and batch 2, from one set of weights:
    one f32 teacher-forced forward on the card against the CPU's (the
    logits relative to the largest; TF32 the control), and one AMP step
    (O1) on the card against the CPU's plain path under the same
    ``auto_cast`` (loss, the gradient's relative L2 and the share of its
    entries that differ in any bit; the f32 step the control), with the
    card's LayerNorm launches exact. Every reading is logged before a
    limit fails. Returns the readings."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = _seq2seq(seed=0, dropout=0.0)
    batch = s2s_batch(2, np.random.RandomState(30))
    cpu_model = copy.deepcopy(model).eval()
    card_model = copy.deepcopy(model).cuda().eval()
    src, tin = (torch.from_numpy(a) for a in batch[:2])
    with torch.no_grad():
        t0 = time.perf_counter()
        want = cpu_model(src, tin)
        cpu_s = time.perf_counter() - t0
        reset_launch_counts()
        got = card_model(src.cuda(), tin.cuda()).cpu()
        counts = {k: v for k, v in launch_counts().items() if v}
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = card_model(src.cuda(), tin.cuda()).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    scale = float(want.abs().max())
    r = {"logits_rel_err": float((got - want).abs().max()) / scale,
         "tf32_logits_rel_err": float((tf32 - want).abs().max()) / scale,
         "logits_rtol": S2S_LOGITS_RTOL, "cpu_forward_s": cpu_s}
    if counts != _s2s_launches(False, backward=False):
        raise AssertionError(f"seq2seq f32 forward launched {counts}")
    del card_model
    control = copy.deepcopy(model)
    control_loss = float(_s2s_step_of(control, _s2s_loss)(*batch)["loss"])
    amp_loss = _amp_loss_fn(_s2s_loss, "O1")
    cpu = copy.deepcopy(model)
    t0 = time.perf_counter()
    cpu_loss = float(_s2s_step_of(cpu, amp_loss, device="cpu")(*batch)["loss"])
    r["cpu_amp_step_s"] = time.perf_counter() - t0
    card = copy.deepcopy(model)
    reset_launch_counts()
    loss = float(_s2s_step_of(card, amp_loss)(*batch)["loss"])
    amp_counts = {k: v for k, v in launch_counts().items() if v}
    l2, differ, worst = _grad_l2(card, cpu)
    c_l2, c_differ, c_worst = _grad_l2(control, cpu)
    r.update(loss=loss, cpu_loss=cpu_loss, loss_err=abs(loss - cpu_loss), grad_rel_l2=l2,
             grad_differing=differ, worst_entry=worst,
             control_loss_err=abs(control_loss - cpu_loss), control_grad_rel_l2=c_l2,
             control_grad_differing=c_differ, control_worst_entry=c_worst,
             limits=dict(S2S_AMP_LIMITS, grad_differing=S2S_AMP_GRAD_DIFFERING),
             launches=amp_counts)
    log(f"seq2seq parity at batch 2: f32 logits rel err {r['logits_rel_err']:.3g} (rtol "
        f"{S2S_LOGITS_RTOL}; TF32 control {r['tf32_logits_rel_err']:.3g}; CPU forward "
        f"{cpu_s:.1f} s); AMP O1 step: card loss {loss:.6f}, CPU {cpu_loss:.6f} "
        f"({r['cpu_amp_step_s']:.1f} s): loss err {r['loss_err']:.3g}, gradient rel L2 "
        f"{l2:.3g}, entries differing {differ:.4f}, worst entry {worst[0]:.3g} at {worst[1]}; "
        f"f32 control: loss err {r['control_loss_err']:.3g}, rel L2 {c_l2:.3g}, differing "
        f"{c_differ:.4f}; launches {amp_counts}")
    if amp_counts != _s2s_launches(True):
        raise AssertionError(f"seq2seq AMP parity step launched {amp_counts}; want "
                             f"{_s2s_launches(True)}")
    if not r["logits_rel_err"] <= S2S_LOGITS_RTOL < r["tf32_logits_rel_err"]:
        raise AssertionError(f"seq2seq f32 logits: {r['logits_rel_err']} (TF32 control "
                             f"{r['tf32_logits_rel_err']}) against rtol {S2S_LOGITS_RTOL}")
    lim = S2S_AMP_LIMITS
    if not (np.isfinite(loss) and r["loss_err"] <= lim["loss"]
            and l2 <= lim["grad_rel_l2"] and differ <= S2S_AMP_GRAD_DIFFERING):
        raise AssertionError(f"seq2seq AMP parity step beyond its limits: {r}")
    if not c_differ > S2S_AMP_GRAD_DIFFERING:
        raise AssertionError(f"seq2seq AMP: the f32 control passes the limit on differing "
                             f"entries {S2S_AMP_GRAD_DIFFERING}: {r}")
    return r


def train_seq2seq_amp():
    """Phase 12c. Transformer-base (37,000-token vocabulary, dropout 0.1)
    trained under ``auto_cast`` (O1) at 64 pairs x 64 + 64 tokens with
    Adam(0.9, 0.98, 1e-9) under ``NoamDecay(512, 4000)`` with
    ``ClipGradByGlobalNorm(1.0)``, the pad-masked cross entropy, through
    ``train_step``: the parity checks at batch 2, then 10 eager steps and
    10 captured ones (``jit=True``: the eager first step, then replays) from
    one set of weights, each launching exactly 30 residual LayerNorms
    forward and backward (2 mixed), every step's lr the schedule's (on the
    card its float32) with one capture. Returns (eager launches, captured
    launches, readings)."""
    import torch

    parity = s2s_parity()
    torch.cuda.empty_cache()
    base = _seq2seq(seed=1)
    batch = [torch.from_numpy(a).cuda() for a in s2s_batch(S2S_B, np.random.RandomState(31))]
    loss_fn = _amp_loss_fn(_s2s_loss, "O1")
    records = {"eager": {}, "captured": {}}
    counts, timing = compiled_timing(
        lambda: copy.deepcopy(base),
        lambda m, jit: _s2s_step_of(m, loss_fn, jit=jit, start=S2S_NOAM_START,
                                    record=records["captured" if jit else "eager"]),
        batch, "seq2seq AMP", S2S_B * S2S_TGT, "target_tokens")
    noam = _check_noam(records)
    del records
    want = _s2s_launches(True, COMPILED_STEPS)
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"seq2seq AMP: {COMPILED_STEPS} steps launched {counts}; want "
                             f"{want}")
    eager = {k: v * COMPILED_STEPS for k, v in timing["eager"]["launches_a_step"].items()}
    real = int((batch[2] != S2S_PAD).sum())
    for run in timing.values():
        run["busy_share"] = run["busy_ms"] / run["step_ms_median"]
        run["real_target_tokens_per_s"] = real / run["step_ms_median"] * 1e3
    log(f"seq2seq AMP: {real} of {S2S_B * S2S_TGT} target positions real; median step eager "
        f"{timing['eager']['step_ms_median']:.3f} ms, captured "
        f"{timing['captured']['step_ms_median']:.3f} ms (busy share "
        f"{timing['captured']['busy_share']:.1%}); device ms by kind, captured: "
        f"{ {k: round(v, 3) for k, v in timing['captured']['device_ms_by_kind'].items()} }")
    return eager, counts, {"parity": parity, **timing, "real_target_tokens": real,
                           "noam": noam}


def _greedy_margins(model, src, ys):
    """The CPU model's top-two margin of the logits that chose each of
    ``ys``' tokens after BOS, ``[B, T - 1]``."""
    import torch

    with torch.no_grad():
        logits = model.decode_logits(model.encode(src), model._pad_mask(src), ys[:, :-1])
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


@contextlib.contextmanager
def _recorded_beam_steps():
    """Every ``beam_search_step`` the seq2seq model calls, recorded as
    (the top k + 1 flat totals, parents, tokens) on the host, the op itself
    unchanged."""
    import torch

    from paddle_tpu_torch.models import seq2seq as s2s
    from paddle_tpu_torch.ops import registry

    rec = []
    step = registry.kernel("beam_search_step")

    def recording(logp, scores, *, beam_size, first_step=False, **kw):
        out = step(logp, scores, beam_size=beam_size, first_step=first_step, **kw)
        b, k, v = logp.shape
        total = scores[:, :, None] + logp
        if first_step:
            total = torch.cat([total[:, :1], torch.full_like(total[:, 1:], float("-inf"))], 1)
        top = total.reshape(b, k * v).topk(beam_size + 1, dim=1).values
        rec.append((top.cpu(), out[1].cpu(), out[2].cpu()))
        return out

    orig = s2s.kernel
    s2s.kernel = lambda name: recording if name == "beam_search_step" else orig(name)
    try:
        yield rec
    finally:
        s2s.kernel = orig


def _beam_hypotheses(rec):
    """The hypotheses (token tuples) each recorded beam step keeps, as a
    sorted list a row: ``[rows][steps]``. Two runs that keep the same
    hypotheses in another slot order compare equal."""
    rows, k = rec[0][1].shape
    hyps = [[()] * k for _ in range(rows)]
    out = [[] for _ in range(rows)]
    for _, parent, token in rec:
        for r in range(rows):
            hyps[r] = [hyps[r][int(parent[r, j])] + (int(token[r, j]),) for j in range(k)]
            out[r].append(sorted(hyps[r]))
    return out


def _held(card, cpu, margins):
    """Positions (``[rows][positions]`` of comparable items) at which the
    card must agree with the CPU: in each row, every one before the first
    with a CPU margin under ``S2S_MARGIN``. Returns (held, positions, held
    ones that differ)."""
    held = bad = 0
    for r, row in enumerate(margins):
        low = np.nonzero(row < S2S_MARGIN)[0]
        n = int(low[0]) if len(low) else len(row)
        held += n
        bad += sum(card[r][i] != cpu[r][i] for i in range(n))
    return held, margins.size, bad


def decode_seq2seq():
    """Phase 12d. Transformer-base in f32 eval from seeded weights: greedy
    decoding of 16 sources to 32 tokens and beam search (beam 4) of 4
    sources to 32, on the card and on the CPU; the card's tokens (greedy)
    and the hypotheses each beam step keeps must equal the CPU's at every
    step before the first whose CPU margin is under
    ``S2S_MARGIN``, and at least a quarter of the positions must be held so
    (the check must not pass on nothing); each
    decode launches exactly 12 LayerNorms for the encoder and 18 a step.
    Returns (launches, readings)."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    model = _seq2seq(seed=2).eval()
    rng = np.random.RandomState(32)
    cpu = copy.deepcopy(model)
    card = model.cuda()
    steps = S2S_DECODE_LEN - 1
    want_counts = {"layernorm_residual_fwd": S2S_ENC_NORMS + S2S_DEC_NORMS * steps}
    total, out = {}, {}
    for kind, b in (("greedy", S2S_GREEDY_B), ("beam", S2S_BEAM_B)):
        src = torch.from_numpy(s2s_batch(b, rng)[0])
        if kind == "greedy":
            run = lambda m, x: m.greedy_decode(x, max_len=S2S_DECODE_LEN)  # noqa: E731
        else:
            run = lambda m, x: m.beam_search(x, S2S_BEAM, S2S_DECODE_LEN)  # noqa: E731
        with _recorded_beam_steps() as card_steps:  # the first run: also cuBLAS's plans
            got = run(card, src.cuda())
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        timed = run(card, src.cuda())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in launch_counts().items() if v}
        repeats = all(torch.equal(a, b) for a, b in zip(
            (got,) if kind == "greedy" else got, (timed,) if kind == "greedy" else timed))
        if counts != want_counts:
            raise AssertionError(f"seq2seq {kind} decode launched {counts}; want {want_counts}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        t0 = time.perf_counter()
        with _recorded_beam_steps() as cpu_steps:
            want = run(cpu, src)
        cpu_s = time.perf_counter() - t0
        if kind == "greedy":
            margins = _greedy_margins(cpu, src, want)
            held, positions, bad = _held(got.cpu().numpy()[:, 1:].tolist(),
                                         want.numpy()[:, 1:].tolist(), margins)
            extra = {}
        else:
            # a step's margin: the last kept total less the first dropped one
            top = torch.stack([t for t, _, _ in cpu_steps], 1)  # [B, T, k + 1]
            margins = (top[..., -2] - top[..., -1]).numpy()
            held, positions, bad = _held(_beam_hypotheses(card_steps),
                                         _beam_hypotheses(cpu_steps), margins)
            # rows held at every step: the same final hypotheses and scores
            full = [r for r in range(b) if (margins[r] >= S2S_MARGIN).all()]
            seqs, scores = (t.cpu() for t in got)

            def final(sq, sc, r):
                return sorted(zip(sc[r].tolist(), map(tuple, sq[:, r].T.tolist())))

            pairs = [(final(seqs, scores, r), final(*want, r)) for r in full]
            extra = {"rows_held_whole": len(full),
                     "final_scores_err": max((abs(a[0] - c[0]) for g, w in pairs
                                              for a, c in zip(g, w)), default=None),
                     "final_sequences_equal": all([a[1] for a in g] == [c[1] for c in w]
                                                  for g, w in pairs)}
            if not extra["final_sequences_equal"]:
                raise AssertionError(f"beam search: rows held at every step end apart: {extra}")
        rows = got.shape[0] if kind == "greedy" else b
        out[kind] = {"ms": ms, "ms_per_step": ms / steps, "ms_per_token": ms / (steps * rows),
                     "tokens_per_s": steps * rows / ms * 1e3, "rows": rows, "steps": steps,
                     "positions_held": held, "positions": positions, "mismatches_held": bad,
                     "min_cpu_margin": float(margins.min()), "cpu_s": cpu_s,
                     "timed_run_equals_checked": repeats, "launches": counts, **extra}
        log(f"seq2seq {kind} decode ({rows} rows to {S2S_DECODE_LEN} tokens): {ms:.1f} ms on "
            f"the card, {ms / steps:.3f} ms a step, {ms / (steps * rows):.4f} ms a token "
            f"(CPU {cpu_s:.1f} s); {held} of {positions} positions held to the CPU's (margin >= "
            f"{S2S_MARGIN}), {bad} differ; the timed run equal to the checked one: {repeats}; "
            f"launches {counts}; {extra}")
        if bad or held < positions / 4:
            raise AssertionError(f"seq2seq {kind} decode: {bad} of {held} held positions differ "
                                 f"from the CPU's ({positions} in all)")
    return total, out


def _ernie_batch(cfg, rng, seed):
    """bench's phase-2 shape with ERNIE's masking: ids, segment ids, spans
    of 1-4 tokens (a quarter of them single tokens), ``knowledge_masking``
    at 0.15 from a seeded generator, the first ``TRAIN_PRED`` masked
    positions of each row predicted (masks past them restored; a row with
    fewer pads its positions with ignored labels at its position 0)."""
    import torch

    from paddle_tpu_torch.models import knowledge_masking

    b, l = TRAIN_B, TRAIN_SEQ
    ids = rng.randint(5, cfg.vocab_size, (b, l)).astype(np.int64)
    spans = np.zeros((b, l), np.int64)
    for r in range(b):
        j, sid = 0, 1
        while j < l:
            n = rng.randint(1, 5)
            spans[r, j:j + n] = 0 if n == 1 else sid
            j, sid = j + n, sid + 1
    masked, mask = knowledge_masking(torch.from_numpy(ids), torch.from_numpy(spans),
                                     ERNIE_MASK_ID, torch.Generator().manual_seed(seed))
    masked, mask = masked.numpy().copy(), mask.numpy()
    pos = np.zeros((b, TRAIN_PRED), np.int64)
    labels = np.full((b, TRAIN_PRED), -100, np.int64)
    counts = []
    for r in range(b):
        where = np.nonzero(mask[r])[0]
        counts.append(len(where))
        masked[r, where[TRAIN_PRED:]] = ids[r, where[TRAIN_PRED:]]
        where = where[:TRAIN_PRED]
        pos[r, :len(where)] = where + r * l
        pos[r, len(where):] = r * l
        labels[r, :len(where)] = ids[r, where]
    types = rng.randint(0, 2, (b, l)).astype(np.int64)
    nsp = rng.randint(0, 2, (b, 1)).astype(np.int64)
    return [masked, types, pos.ravel(), labels.ravel(), nsp], counts


def train_ernie_amp():
    """Phase 12e. ERNIE-base (``ernie_base_config()``, flash on) pretrained
    under ``auto_cast`` (O1) at batch 32 x 512, 80 predictions a row from
    ``knowledge_masking``, AdamW lr 1e-4, dropout 0.1: 10 eager and 10
    captured steps from one set of weights, each launching the three bf16
    attention kernels once a layer and the residual LayerNorms (layer 0's
    first mixed, the rest bf16) exactly. Returns (eager launches, captured
    launches, readings)."""
    import torch

    from paddle_tpu_torch.models import (BertPretrainingCriterion, ErnieForPretraining,
                                         ernie_base_config)

    cfg = ernie_base_config()
    cfg.use_flash_attention = True
    base = ErnieForPretraining(cfg, generator=torch.Generator().manual_seed(3))
    crit = BertPretrainingCriterion(cfg.vocab_size)

    def loss_fn(m, ids, types, pos, mlm, nsp):
        pred, rel = m(ids, types, masked_positions=pos)
        return crit(pred, rel, mlm, nsp)

    arrays, masked = _ernie_batch(cfg, np.random.RandomState(33), seed=34)
    batch = [torch.from_numpy(a).cuda() for a in arrays]
    amp_loss = _amp_loss_fn(loss_fn, "O1")
    counts, timing = compiled_timing(lambda: copy.deepcopy(base),
                                     lambda m, jit: _step_of(m, amp_loss, jit=jit), batch,
                                     "ERNIE AMP", TRAIN_B * TRAIN_SEQ, "tokens")
    want = _amp_launches("O1", cfg.num_hidden_layers, COMPILED_STEPS)
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"ERNIE AMP: {counts}; want {want}")
    eager = {k: v * COMPILED_STEPS for k, v in timing["eager"]["launches_a_step"].items()}
    stats = {"masked_a_row_min": min(masked), "masked_a_row_max": max(masked),
             "masked_a_row_mean": float(np.mean(masked)),
             "rows_under_80": sum(c < TRAIN_PRED for c in masked)}
    log(f"ERNIE AMP: knowledge masking {stats}; median step eager "
        f"{timing['eager']['step_ms_median']:.3f} ms, captured "
        f"{timing['captured']['step_ms_median']:.3f} ms")
    return eager, counts, {"masking": stats, **timing}


def train_seq2seq_and_ernie():
    """Phases 12c-12e. Returns ({"training", "compiled", "serving"}: launches,
    readings)."""
    import torch

    torch.cuda.empty_cache()
    s2s_eager, s2s_captured, s2s = train_seq2seq_amp()
    torch.cuda.empty_cache()
    dec_counts, dec = decode_seq2seq()
    torch.cuda.empty_cache()
    er_eager, er_captured, ernie = train_ernie_amp()
    torch.cuda.empty_cache()

    def add(*ds):
        return {k: sum(d.get(k, 0) for d in ds) for d in ds for k in d}

    return ({"training": add(s2s_eager, er_eager), "compiled": add(s2s_captured, er_captured),
             "serving": dec_counts},
            {"seq2seq_amp": s2s, "seq2seq_decode": dec, "ernie_amp": ernie})


# -- BASELINE.json's first config: the MNIST LeNet as a static program, SGD --------

LENET_B, LENET_STEPS, LENET_LR, LENET_SEED = 64, 200, 0.05, 16
LENET_PARITY_STEPS = 5  # steps held against the CPU interpreter
LENET_EAGER_STEPS = 20  # steps of the interpreter run eagerly on the card, timed
LENET_TIMED = 50  # replays of the forward program, timed
# LeNet's pools: [64, 6, 28, 28] -> [64, 6, 14, 14] and [64, 16, 10, 10] -> [64, 16, 5, 5]
LENET_POOLS = ((LENET_B, 6, 28, 28), (LENET_B, 16, 10, 10))
# The card's losses against the CPU interpreter's from the same weights and
# batches; the control is the CPU's run at lr 0 (the update ignored), whose
# losses part from the trained ones at the second step.
LENET_LOSS_ATOL = 1e-4
LENET_ACC_BAR = 0.9  # accuracy on the 512 held-out synthetic images after 200 steps


def _lenet_programs(train):
    """(main, startup, loss, acc) of the LeNet-5 program (the JAX package's
    ``models/lenet.py`` widths), with ``static.optimizer.SGD``'s training
    ops when ``train``. Two builds name their parameters alike (``param_0``
    ... ``param_9``), so a forward-only build reads a training build's
    scope."""
    from paddle_tpu_torch import nets, ops, static

    main, startup = static.Program(), static.Program()
    static.enable_static()
    try:
        with static.program_guard(main, startup):
            img = static.data("img", [None, 1, 28, 28], "float32")
            label = static.data("label", [None, 1], "int64")
            h = nets.simple_img_conv_pool(img, 6, 3, 2, 2, conv_padding=1, act="relu")
            h = nets.simple_img_conv_pool(h, 16, 5, 2, 2, act="relu")
            h = static.nn.fc(h, 120, activation="relu")
            h = static.nn.fc(h, 84, activation="relu")
            logits = static.nn.fc(h, 10)
            loss = ops.mean(ops.softmax_with_cross_entropy(logits, label))
            acc = ops.accuracy(ops.softmax(logits), label)
            if train:
                static.optimizer.SGD(learning_rate=LENET_LR).minimize(loss)
    finally:
        static.disable_static()
    return main, startup, loss, acc


def check_pool_backward_lenet(shape):
    """Rows 16e/16f: the max-pool backward kernel at one of LeNet's pools
    (2x2, stride 2, no padding) on a relu'd input (whole windows of zeros
    tie), bit-equal to its plain version and within 4 ulps of
    ``aten.max_pool2d_with_indices_backward`` (the library yardstick: the
    same first-maximum rule, another order of adding), each timed in device
    time behind a sleep kernel, with the bound of the table's rule
    ``4·(|x|+|y|+|dy|+|dx|)`` bytes."""
    import torch

    from paddle_tpu_torch.ops.cuda import pool_backward as pb

    g = torch.Generator(device="cuda").manual_seed(40 + shape[1])
    ks = st = (2, 2)
    pad = (0, 0)
    x = torch.relu(torch.randn(shape, generator=g, device="cuda"))
    y, idx = torch.nn.functional.max_pool2d(x, ks, st, pad, return_indices=True)
    dy = torch.randn(y.shape, generator=g, device="cuda")
    dx = pb.max_pool2d_backward(x, y, dy, ks, st, pad)
    ref = pb._plain_max_pool2d_backward(x, y, dy, ks, st, pad)
    lib_fn = lambda: torch.ops.aten.max_pool2d_with_indices_backward(  # noqa: E731
        dy, x, list(ks), list(st), list(pad), [1, 1], False, idx)
    lib = lib_fn()
    torch.cuda.synchronize()
    err = float((dx - ref).abs().max())
    lib_err = float((dx - lib).abs().max())
    ulp = float(torch.finfo(torch.float32).eps * ref.abs().max())
    if not torch.equal(dx, ref):
        raise AssertionError(f"max_pool2d_backward {list(shape)} 2x2/2: {err} from the plain "
                             "version")
    if lib_err > 4 * ulp:
        raise AssertionError(f"max_pool2d_backward {list(shape)} 2x2/2: {lib_err} from torch's "
                             f"backward, beyond 4 ulps ({4 * ulp})")
    t_b, by = bound(4 * (2 * x.numel() + 2 * y.numel()), 4 * x.numel())
    args = [(x, y, dy, ks, st, pad)]
    ms, host_ms = device_ms_sets(pb.max_pool2d_backward, args, 50)
    plain_ms = device_ms_sets(pb._plain_max_pool2d_backward, args, 20)[0]
    lib_ms = device_ms(lib_fn, 50)[0]
    entry = {"name": "max_pool2d_backward", "row": "16e" if shape[1] == 6 else "16f",
             "path": "MNIST LeNet static program", "shape": list(shape),
             "geometry": "2x2 stride 2 padding 0", "input": "relu", "layout": "nchw",
             "dtype": "float32", "max_abs_err": err,
             "tolerance": "bit-equal to the plain version", "library_max_abs_err": lib_err,
             "zeros_share": float((x == 0).float().mean()), "ms": ms, "kernel_ms": ms,
             "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by,
             "library_ms": lib_ms,
             "library": "aten.max_pool2d_with_indices_backward at the same shape",
             "timing": "device time behind a sleep kernel"}
    log(f"max_pool2d_backward {list(shape)} 2x2/2/0 (LeNet, row {entry['row']}): bit-equal to "
        f"the plain version, {lib_err:.3g} from torch's backward; kernel {ms:.4f} ms device "
        f"(host {host_ms:.4f} ms a call), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
        f"bound {t_b:.5f} ms ({by})")
    return entry


def _lenet_run(exe, program, feeds, fetch, scope):
    """``exe.run`` of ``program`` on each of ``feeds`` (device tensors kept
    on the device); returns the fetches stacked, on the host."""
    import torch

    outs = [exe.run(program, feed=f, fetch_list=fetch, scope=scope, return_numpy=False)
            for f in feeds]
    return [torch.stack([o[i] for o in outs]).cpu().numpy() for i in range(len(fetch))]


def _lenet_interpret_ms(exe, program, feeds, fetch, scope, steps):
    """The executor's interpreter run eagerly on the card (no graph), ``steps``
    steps timed with CUDA events and the host clock: (median ms, host ms a
    step, launches a step)."""
    import torch

    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    block, names = program.global_block(), [v.name for v in fetch]
    with torch.no_grad():
        exe._interpret(block, dict(feeds[0]), scope, names)
        torch.cuda.synchronize()
        reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        t0 = time.perf_counter()
        ev[0].record()
        for i in range(steps):
            exe._interpret(block, dict(feeds[i % len(feeds)]), scope, names)
            ev[i + 1].record()
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / steps
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    return float(np.median(ms)), host, {k: v // steps for k, v in launch_counts().items() if v}


def train_lenet_static():
    """Phase 12f. The LeNet-5 program trained by static SGD on the card
    through the executor's graph, ``FLAGS_use_pallas_pool_bwd`` on. Returns
    (the launches of the 200 steps, readings)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import convert, static
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.vision.datasets import MNIST

    main, startup, loss, acc = _lenet_programs(train=True)
    fwd, _, fwd_loss, fwd_acc = _lenet_programs(train=False)
    train_set, test_set = MNIST(mode="train"), MNIST(mode="test")
    images = torch.from_numpy(train_set.images).cuda()  # the data set on the card, once
    labels = torch.from_numpy(train_set.labels).reshape(-1, 1).cuda()
    n_batches = len(train_set) // LENET_B
    feeds = [{"img": images[i * LENET_B:(i + 1) * LENET_B],
              "label": labels[i * LENET_B:(i + 1) * LENET_B]} for i in range(n_batches)]
    ops_count = len(main.global_block().ops)
    grad_ops = sum(o.type.startswith("grad::") for o in main.global_block().ops)
    set_flags({"use_pallas_pool_bwd": True})
    try:
        ptt.seed(LENET_SEED)
        scope = static.Scope()
        exe = static.Executor()
        exe.run_startup(startup, scope=scope)
        init = {n: scope.numpy(n) for n in scope.var_names()}

        # the CPU interpreter from the same weights: trained, and at lr 0
        host_feeds = [{k: v.cpu().numpy() for k, v in f.items()}
                      for f in feeds[:LENET_PARITY_STEPS]]
        cpu = {}
        for name, lr in (("trained", None), ("control", 0.0)):
            cscope = convert.scope_from_numpy(init, device="cpu")
            if lr is not None:
                cscope.get("learning_rate_0").fill_(lr)
            cexe = static.Executor("cpu")
            cpu[name] = [float(cexe.run(main, feed=f, fetch_list=[loss], scope=cscope)[0])
                         for f in host_feeds]

        # 200 steps through the executor's graph, the counts set to 0 just
        # before: the first runs eagerly and is captured, the rest replay
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = [exe.run(main, feed=feeds[0], fetch_list=[loss, acc], scope=scope,
                        return_numpy=False)]
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(LENET_STEPS)]
        t0 = time.perf_counter()
        ev[0].record()
        for i in range(1, LENET_STEPS):
            outs.append(exe.run(main, feed=feeds[i % n_batches], fetch_list=[loss, acc],
                                scope=scope, return_numpy=False))
            ev[i].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / (LENET_STEPS - 1)
        counts = {k: v for k, v in launch_counts().items() if v}
        losses = torch.stack([o[0] for o in outs]).cpu().numpy()
        accs = torch.stack([o[1] for o in outs]).cpu().numpy()
        step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(LENET_STEPS - 1)]
        graphs, captures, replays = len(exe.store), exe.store.misses, exe.store.hits

        # the lr is read by the graph from the scope's tensor, written in place
        # (as set_lr does): a replay at lr 0 moves no parameter, one at the lr
        # moves them, and neither captures again
        params = [n for n in scope.var_names() if n.startswith("param_")]
        lr_t = scope.get("learning_rate_0")
        moved = []
        for lr in (0.0, LENET_LR):
            before = [scope.get(n).clone() for n in params]
            lr_t.fill_(lr)
            exe.run(main, feed=feeds[1], fetch_list=[loss, acc], scope=scope,
                    return_numpy=False)
            moved.append(sum(not torch.equal(scope.get(n), b) for n, b in zip(params, before)))
        lr_captures = exe.store.misses - captures

        # one replay profiled: device busy by kind
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            exe.run(main, feed=feeds[0], fetch_list=[loss, acc], scope=scope,
                    return_numpy=False)
            torch.cuda.synchronize()
        by_kind, events = _device_time_by_kind(prof)

        # the forward alone (what the grad ops' re-run of their forwards costs
        # at most) and the held-out accuracy, through another executor's graphs
        fexe = static.Executor()
        _lenet_run(fexe, fwd, feeds[:1], [fwd_loss, fwd_acc], scope)
        torch.cuda.synchronize()
        f0, f1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        f0.record()
        for i in range(LENET_TIMED):
            fexe.run(fwd, feed=feeds[i % n_batches], fetch_list=[fwd_loss, fwd_acc], scope=scope,
                     return_numpy=False)
        f1.record()
        torch.cuda.synchronize()
        fwd_ms = f0.elapsed_time(f1) / LENET_TIMED
        test = {"img": torch.from_numpy(test_set.images).cuda(),
                "label": torch.from_numpy(test_set.labels).reshape(-1, 1).cuda()}
        test_loss, test_acc = (float(v[0]) for v in _lenet_run(fexe, fwd, [test],
                                                                 [fwd_loss, fwd_acc], scope))

        # the same steps run eagerly on the card (the interpreter, no graph)
        escope = convert.scope_from_numpy({n: scope.numpy(n) for n in scope.var_names()})
        eager_ms, eager_host_ms, eager_launches = _lenet_interpret_ms(
            exe, main, feeds, [loss, acc], escope, LENET_EAGER_STEPS)
    finally:
        set_flags({"use_pallas_pool_bwd": False})

    card5 = losses[:LENET_PARITY_STEPS].tolist()
    err = max(abs(a - b) for a, b in zip(card5, cpu["trained"]))
    control_err = max(abs(a - b) for a, b in zip(card5, cpu["control"]))
    median = float(np.median(step_ms))
    r = {"steps": LENET_STEPS, "batch": LENET_B, "lr": LENET_LR, "ops": ops_count,
         "grad_ops": grad_ops, "graphs": graphs, "captures": captures, "replays": replays,
         "launches": counts, "losses_first": card5, "cpu_losses": cpu["trained"],
         "control_losses": cpu["control"], "loss_err": err, "control_loss_err": control_err,
         "loss_atol": LENET_LOSS_ATOL, "loss_last_20_mean": float(losses[-20:].mean()),
         "train_acc_last_20_mean": float(accs[-20:].mean()), "test_loss": test_loss,
         "test_acc": test_acc, "test_acc_bar": LENET_ACC_BAR,
         "first_step_and_capture_ms": first_ms, "captured_step_ms_median": median,
         "captured_step_ms_min": min(step_ms), "captured_host_clock_ms": wall_ms,
         "images_per_s": LENET_B / median * 1e3, "busy_ms": sum(by_kind.values()),
         "device_ms_by_kind": by_kind, "device_events": events,
         "params_moved_at_lr_0_then_lr": moved, "eager_step_ms_median": eager_ms,
         "eager_host_ms": eager_host_ms,
         "eager_launches_a_step": eager_launches, "forward_ms_captured": fwd_ms,
         "forward_share_of_step": fwd_ms / median}
    log(f"LeNet static SGD ({ops_count} ops, {grad_ops} grad ops): {LENET_STEPS} steps at "
        f"batch {LENET_B}, {graphs} graph ({captures} capture, {replays} replays); launches "
        f"{counts}; first losses {[round(x, 6) for x in card5]}, CPU {cpu['trained']} (err "
        f"{err:.3g}, atol {LENET_LOSS_ATOL}; lr-0 control err {control_err:.3g}); last 20 mean "
        f"loss {r['loss_last_20_mean']:.4f}, train acc {r['train_acc_last_20_mean']:.4f}; "
        f"held-out acc {test_acc:.4f} (bar {LENET_ACC_BAR}), loss {test_loss:.4f}; first step "
        f"and capture {first_ms:.1f} ms; captured step {median:.4f} ms median between CUDA "
        f"events (min {min(step_ms):.4f}; host clock {wall_ms:.4f} a replay), "
        f"{r['images_per_s']:.0f} images/s, busy "
        f"{r['busy_ms']:.4f} ms in {events} device events; eager {eager_ms:.3f} ms (host "
        f"{eager_host_ms:.3f}); replays at lr 0 and {LENET_LR} moved {moved} of "
        f"{len(params)} parameters; the forward alone captured {fwd_ms:.4f} ms "
        f"({r['forward_share_of_step']:.1%} of the step)")
    if graphs != 1 or captures != 1 or replays != LENET_STEPS - 1:
        raise AssertionError(f"LeNet: {graphs} graphs, {captures} captures, {replays} replays "
                             f"in {LENET_STEPS} steps; want 1, 1, {LENET_STEPS - 1}")
    if counts != {"max_pool2d_backward": 2 * LENET_STEPS}:
        raise AssertionError(f"LeNet: {LENET_STEPS} steps launched {counts}; want "
                             f"max_pool2d_backward x {2 * LENET_STEPS}")
    if moved != [0, len(params)] or lr_captures:
        raise AssertionError(f"LeNet: replays at lr 0 and {LENET_LR} moved {moved} of "
                             f"{len(params)} parameters and captured {lr_captures} graphs")
    if eager_launches != {"max_pool2d_backward": 2}:
        raise AssertionError(f"LeNet eager: launches a step {eager_launches}")
    if not err <= LENET_LOSS_ATOL < control_err:
        raise AssertionError(f"LeNet: the card's first losses {err} from the CPU's (atol "
                             f"{LENET_LOSS_ATOL}; the lr-0 control {control_err} must fail)")
    if not (np.isfinite(losses).all() and r["loss_last_20_mean"] < losses[0]
            and test_acc > LENET_ACC_BAR):
        raise AssertionError(f"LeNet: did not train: {r}")
    return counts, r


# -- the rest of training: Lamb, EMA, the NaN check, checkpoints; the other optimizers --------

LAMB_LR, LAMB_WD, LAMB_SEED, LAMB_EMA_DECAY = 1e-4, 0.01, 31, 0.999
LAMB_SAVE_AT = 3  # the step the checkpoint is taken after
LAMB_TIMED = COMPILED_STEPS  # captured steps timed, an EMA update after each
LAMB_CHECKED_TIMED = 5  # checked replays timed
LAMB_PARITY_B = 1  # one step on the card against the CPU's plain path, dropout 0
# Lamb's first step at batch 1 x 512 under O1 on the card against the
# CPU's plain path, read on an NVIDIA H100 80GB HBM3 at 700.00 W: the loss
# after the update (a second step's, then a forward alone) 1.2e-3 apart,
# the f32 step (the control) 3.54e-2; the limit sits near their geometric
# mean, and the control must fail it. The rel L2 of the parameters' change
# read 0.143 (the control 0.142): Lamb's first direction m/(sqrt(v)+eps) is
# about sign(g), so entries whose gradient is near eps swing it either way;
# it is a gross limit only.
LAMB_LOSS_ATOL, LAMB_UPDATE_REL_L2 = 6.5e-3, 0.25
LENET_OPT_STEPS = 20  # captured steps under each optimizer
# the 20 captured losses under each optimizer against the CPU's 20 from the
# same weights and batches, read on an NVIDIA H100 80GB HBM3 at 700.00 W:
# 2.4e-7 to 1.3e-6 apart; the controls at half the lr 0.113 (Adagrad) to
# 0.956; the limit sits near the geometric mean of the worst reading and
# the weakest control
LENET_OPT_LOSS_ATOL = 3e-4
LENET_OPT_HELD_OUT = 512  # held-out images for the accuracy under ModelAverage


def _lamb_exclude(p):
    """LAMB's BERT recipe: no decay on LayerNorm weights and on biases."""
    return "norm" in p.name or "bias" in p.name


def _lamb_step_of(model, loss_fn, device=None, jit=True):
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.optimizer import Lamb

    opt = Lamb(learning_rate=LAMB_LR, lamb_weight_decay=LAMB_WD,
               parameters=model.named_parameters(),
               exclude_from_weight_decay_fn=_lamb_exclude)
    return train_step(model, opt, loss_fn, device=device, jit=jit)


def _bits_equal(a, b):
    """Bit for bit (a NaN equals the same NaN)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _lamb_parity():
    """Lamb's first step (batch 1 x 512, dropout 0, O1) through
    ``train_step(jit=True)`` on the card and the same step on the CPU's
    plain path (the attention kernels' plain versions) from the same
    weights, then the loss after it (a forward); the f32 step on the card
    the control. Returns the readings."""
    import torch

    from paddle_tpu_torch.models import bert_base_config

    cfg = bert_base_config()
    cfg.use_flash_attention = True
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    model, loss_fn = _pretraining(cfg, seed=0)
    batch = pretraining_batch(cfg, LAMB_PARITY_B, TRAIN_SEQ, TRAIN_PRED,
                              np.random.RandomState(12))
    amp_loss = _amp_loss_fn(loss_fn, "O1")
    start = [p.detach().clone() for p in model.parameters()]
    runs = {}
    for name, fn, dev in (("cpu", amp_loss, "cpu"), ("card", amp_loss, None),
                          ("control_f32", loss_fn, None)):
        m = copy.deepcopy(model)
        step = _lamb_step_of(m, fn, device=dev)
        t0 = time.perf_counter()
        route = _cpu_kernel_route() if dev == "cpu" else contextlib.nullcontext()
        with route:
            losses = [float(step(*batch)["loss"])]
            with torch.no_grad():
                m.train()
                losses.append(float(fn(m, *[torch.from_numpy(a).to(step.device)
                                            for a in batch])))
        runs[name] = {"losses": losses, "s": time.perf_counter() - t0,
                      "delta": [p.detach().cpu().double() - s.double()
                                for p, s in zip(m.parameters(), start)]}
        del m, step
    ref = runs["cpu"]

    def rel_l2(delta):
        num = sum(float((d - r).square().sum()) for d, r in zip(delta, ref["delta"]))
        return (num / sum(float(r.square().sum()) for r in ref["delta"])) ** 0.5

    out = {}
    for name in ("card", "control_f32"):
        r = runs[name]
        out[name] = {"losses": r["losses"], "loss_err": abs(r["losses"][-1] - ref["losses"][-1]),
                     "update_rel_l2": rel_l2(r["delta"]), "s": r["s"]}
    out["cpu"] = {"losses": ref["losses"], "s": ref["s"]}
    out["limits"] = {"loss_atol": LAMB_LOSS_ATOL, "update_rel_l2": LAMB_UPDATE_REL_L2}
    c, k = out["card"], out["control_f32"]
    log(f"Lamb parity (BERT-base, batch {LAMB_PARITY_B} x {TRAIN_SEQ}, O1, dropout 0, a "
        f"step and the loss after it): card losses {c['losses']}, CPU plain path "
        f"{ref['losses']} ({ref['s']:.1f} s); loss err after the step {c['loss_err']:.3g} (atol "
        f"{LAMB_LOSS_ATOL}), update rel L2 {c['update_rel_l2']:.3g} (limit "
        f"{LAMB_UPDATE_REL_L2}); f32 control: loss err {k['loss_err']:.3g}, update rel L2 "
        f"{k['update_rel_l2']:.3g}")
    if not (np.isfinite(c["losses"]).all() and c["loss_err"] <= LAMB_LOSS_ATOL
            and c["update_rel_l2"] <= LAMB_UPDATE_REL_L2):
        raise AssertionError(f"Lamb parity beyond its limits: {out}")
    if not k["loss_err"] > LAMB_LOSS_ATOL:
        raise AssertionError(f"Lamb parity: the f32 control passes the loss limit: {out}")
    return out


def train_bert_lamb(adamw_ms=None):
    """Phase 12g. BERT-base pretraining under ``Lamb`` at bench's phase 2
    (O1, dropout 0.1) captured, an EMA updated after each step; the checked
    step (``FLAGS_check_nan_inf``) and a planted NaN; a checkpoint taken
    after step 3 and restored into a fresh model and step. Returns (the
    launches of the timed steps, readings)."""
    import os
    import shutil

    import torch

    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.errors import FatalError
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.framework import random as prandom
    from paddle_tpu_torch.models import bert_base_config
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.optimizer import ExponentialMovingAverage

    r = {"parity": _lamb_parity()}
    torch.cuda.empty_cache()
    cfg = bert_base_config()  # hidden and attention dropout 0.1
    cfg.use_flash_attention = True
    _, loss_fn = _pretraining(cfg, seed=1)
    loss_fn = _amp_loss_fn(loss_fn, "O1")
    batch = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(9))]
    tokens = TRAIN_B * TRAIN_SEQ
    tmp = tempfile.mkdtemp(prefix="ptt_lamb_ckpt_")
    try:
        model, _ = _pretraining(cfg, seed=LAMB_SEED)
        step = _lamb_step_of(model, loss_fn)
        ema = ExponentialMovingAverage(model.parameters(), decay=LAMB_EMA_DECAY)
        losses = []
        for _ in range(LAMB_SAVE_AT):
            losses.append(float(step(*batch)["loss"]))
            ema.update()
        torch.cuda.synchronize()
        path = os.path.join(tmp, f"step_{LAMB_SAVE_AT}")
        saved = {n: t.detach().clone() for n, t in step.state_leaves()}  # the state saved
        t0 = time.perf_counter()
        step.save_checkpoint(path, step=LAMB_SAVE_AT, async_=True)
        capture_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ckpt.wait_pending()
        write_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        prandom.seed(PARITY_SEED)
        resumed_ref = float(step(*batch)["loss"])

        # timed: captured steps, each followed by an EMA update
        torch.cuda.synchronize()
        reset_launch_counts()
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(LAMB_TIMED)]
        t0 = time.perf_counter()
        for e in ev:
            e[0].record()
            losses.append(step(*batch)["loss"])
            e[1].record()
            ema.update()
            e[2].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / LAMB_TIMED
        counts = {k: v for k, v in launch_counts().items() if v}
        losses = [float(x) for x in losses]
        step_ms = [e[0].elapsed_time(e[1]) for e in ev]
        ema_ms = [e[1].elapsed_time(e[2]) for e in ev]
        want = _amp_launches("O1", cfg.num_hidden_layers, LAMB_TIMED)
        if counts != want:
            raise AssertionError(f"Lamb: {LAMB_TIMED} captured steps launched {counts}; "
                                 f"want {want}")
        graphs = len(step.store)
        ptrs = [p.data_ptr() for p in model.parameters()]
        with ema.apply():
            moved = sum(not torch.equal(p, e / (1 - ema._decay_prod))
                        for p, e in zip(model.parameters(), ema._ema))
            kept = [p.data_ptr() for p in model.parameters()] == ptrs
        kept = kept and [p.data_ptr() for p in model.parameters()] == ptrs
        median = float(np.median(step_ms))
        r["captured"] = {"losses": losses, "step_ms": step_ms, "step_ms_median": median,
                         "host_clock_ms": wall_ms, "tokens_per_s": tokens / median * 1e3,
                         "adamw_step_ms_median": adamw_ms, "ema_update_ms": ema_ms,
                         "ema_update_ms_median": float(np.median(ema_ms)),
                         "launches_a_step": {k: v // LAMB_TIMED for k, v in counts.items()},
                         "graphs": graphs}
        log(f"BERT Lamb captured: {LAMB_TIMED} steps, median {median:.3f} ms (host clock "
            f"{wall_ms:.3f} with the EMA), {tokens / median * 1e3:.1f} tokens/s; AdamW's "
            f"captured step {adamw_ms} ms; EMA update median {float(np.median(ema_ms)):.3f} "
            f"ms; launches a step {r['captured']['launches_a_step']}; losses {losses}")
        # (at lr 1e-4 a Lamb step moves each tensor by 1e-4 of its norm: over
        # 13 steps that is below dropout's noise, so only finiteness is held)
        if not np.isfinite(losses).all():
            raise AssertionError(f"Lamb: losses not finite: {losses}")
        if graphs != 1 or not kept or moved:
            raise AssertionError(f"Lamb: {graphs} graphs; ema.apply kept the storage {kept}, "
                                 f"{moved} parameters not the averages under it")

        # the checked step: its own graph; a NaN planted in a row the batch reads
        set_flags({"check_nan_inf": True})
        try:
            step(*batch)  # the checked variant's first run and capture
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(LAMB_CHECKED_TIMED + 1)]
            t0 = time.perf_counter()
            ev[0].record()
            for i in range(LAMB_CHECKED_TIMED):
                step(*batch)
                ev[i + 1].record()
            torch.cuda.synchronize()
            checked_wall = (time.perf_counter() - t0) * 1e3 / LAMB_CHECKED_TIMED
            checked_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(LAMB_CHECKED_TIMED)]
            ops_checked = len(step._nan_names)
            backward_ops = sum(n.endswith("_backward") for n in step._nan_names)
            # every kernel of the step checked under its own name, as often as it launches
            kernel_checks = {n: step._nan_names.count(n) for n in set(step._nan_names)
                             if not n.startswith("aten::")}
            table = model.bert.embeddings.word_embeddings.weight
            row = int(batch[0][0, 0])
            saved_row = table[row].detach().clone()
            with torch.no_grad():
                table[row, 0] = float("nan")
            state = [t.detach().clone() for t in step._state_tensors()]
            host_step = step.optimizer._global_step
            try:
                step(*batch)
                raised = None
            except FatalError as e:
                raised = str(e)
            same = all(_bits_equal(t, s) for t, s in zip(step._state_tensors(), state))
            same = same and step.optimizer._global_step == host_step == int(
                step.optimizer._step_t)
            with torch.no_grad():
                table[row].copy_(saved_row)
            step(*batch)  # clean again: passes
            checked_graphs = len(step.store)
        finally:
            set_flags({"check_nan_inf": False})
        r["checked"] = {"step_ms": checked_ms, "step_ms_median": float(np.median(checked_ms)),
                        "host_clock_ms": checked_wall, "ops_checked": ops_checked,
                        "backward_ops_checked": backward_ops, "kernels_checked": kernel_checks,
                        "graphs": checked_graphs,
                        "planted_nan": raised, "state_kept": same}
        log(f"BERT Lamb checked step (FLAGS_check_nan_inf): median "
            f"{r['checked']['step_ms_median']:.3f} ms (host clock {checked_wall:.3f} with the "
            f"verdict's read), {ops_checked} ops checked ({backward_ops} aten backward ops, "
            f"kernels {kernel_checks}); "
            f"graphs {checked_graphs}; planted NaN: {raised}; state bit-equal after: {same}")
        if (raised is None or "aten::embedding" not in raised or not same
                or checked_graphs != 2 or not backward_ops
                or kernel_checks != r["captured"]["launches_a_step"]):
            raise AssertionError(f"Lamb checked step: {r['checked']}")
        del step, model, ema
        torch.cuda.empty_cache()

        # restore into a freshly built model and step (one step captured first)
        model2, _ = _pretraining(cfg, seed=LAMB_SEED + 1)
        step2 = _lamb_step_of(model2, loss_fn)
        step2(*batch)
        misses = step2.store.misses
        t0 = time.perf_counter()
        manifest = step2.load_checkpoint(path)
        load_s = time.perf_counter() - t0
        leaves = step2.state_leaves()
        differ = [n for n, t in leaves if not _bits_equal(t.detach(), saved.get(n, t[None]))]
        differ += sorted(set(saved) - {n for n, _ in leaves})
        prandom.seed(PARITY_SEED)
        resumed = float(step2(*batch)["loss"])
        r["checkpoint"] = {"capture_ms": capture_ms, "write_s": write_s, "bytes": ckpt_bytes,
                           "load_s": load_s, "leaves": len(saved), "leaves_differing": differ,
                           "manifest_step": manifest["step"], "new_captures":
                           step2.store.misses - misses, "next_loss": resumed,
                           "next_loss_uninterrupted": resumed_ref}
        log(f"BERT Lamb checkpoint after step {LAMB_SAVE_AT}: capture {capture_ms:.1f} ms on "
            f"the step's thread, write {write_s:.2f} s, {ckpt_bytes} bytes, {len(saved)} leaves; "
            f"restored into a fresh step in {load_s:.2f} s with {len(differ)} leaves differing, "
            f"{r['checkpoint']['new_captures']} new captures; next loss {resumed!r}, "
            f"uninterrupted {resumed_ref!r}")
        if (differ or r["checkpoint"]["new_captures"] or resumed != resumed_ref
                or manifest["step"] != LAMB_SAVE_AT
                or step2.optimizer._global_step != LAMB_SAVE_AT + 1):
            raise AssertionError(f"Lamb checkpoint: {r['checkpoint']}")
        del step2, model2, saved
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, r


def _lenet_optimizers():
    """name -> a constructor over LeNet's parameters."""
    from paddle_tpu_torch import optimizer as O

    return {
        "adagrad": lambda p, s=1.0: O.Adagrad(0.01 * s, parameters=p,
                                              initial_accumulator_value=0.1),
        "adadelta": lambda p, s=1.0: O.Adadelta(1.0 * s, parameters=p),
        "rmsprop": lambda p, s=1.0: O.RMSProp(0.001 * s, parameters=p, centered=True,
                                              momentum=0.9),
        "adamax": lambda p, s=1.0: O.Adamax(0.002 * s, parameters=p),
        "lookahead": lambda p, s=1.0: O.Lookahead(O.Momentum(0.05 * s, 0.9, parameters=p),
                                                  alpha=0.5, k=5),
    }


def train_lenet_optimizers():
    """Phase 12h. The dygraph LeNet at batch 64 on synthetic MNIST, pool
    kernel on, 20 captured steps under each of Adagrad, Adadelta, RMSProp,
    Adamax and Lookahead(Momentum), one graph each, each held against the
    same 20 steps on the CPU (a half-lr control must fail); ModelAverage
    accumulated over the Lookahead run and applied for the held-out
    accuracy. Returns (the launches of the captured steps, readings)."""
    import torch

    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.framework.jit import train_step
    from paddle_tpu_torch.models import LeNet
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from paddle_tpu_torch.optimizer import ModelAverage
    from paddle_tpu_torch.vision.datasets import MNIST

    train_set, test_set = MNIST(mode="train"), MNIST(mode="test")
    batches = [(train_set.images[i * LENET_B:(i + 1) * LENET_B],
                train_set.labels[i * LENET_B:(i + 1) * LENET_B].astype(np.int64))
               for i in range(LENET_OPT_STEPS)]
    card_batches = [[torch.from_numpy(a).cuda() for a in b] for b in batches]
    held_x = torch.from_numpy(test_set.images[:LENET_OPT_HELD_OUT]).cuda()
    held_y = torch.from_numpy(test_set.labels[:LENET_OPT_HELD_OUT].astype(np.int64)).cuda()
    init = LeNet(generator=torch.Generator().manual_seed(LENET_SEED)).state_dict()

    def loss_fn(m, x, y):
        return F.cross_entropy(m(x), y)

    def run(name, device, scale=1.0, average=None):
        model = LeNet()
        model.load_state_dict(init)
        opt = _lenet_optimizers()[name](model.parameters(), scale)
        step = train_step(model, opt, loss_fn, jit=True, device=device)
        ma = average(model) if average else None
        data = card_batches if device is None else batches
        out = []
        for b in data:
            out.append(step(*b)["loss"])
            if ma is not None:
                ma.accumulate()
        return [float(x) for x in out], model, step, ma

    r, counts = {}, {}
    set_flags({"use_pallas_pool_bwd": True})
    try:
        for name in _lenet_optimizers():
            cpu = run(name, "cpu")[0]
            control = run(name, "cpu", scale=0.5)[0]
            reset_launch_counts()
            average = ((lambda m: ModelAverage(0.15, m.parameters(), min_average_window=4,
                                               max_average_window=8))
                       if name == "lookahead" else None)
            losses, model, step, ma = run(name, None, average=average)
            torch.cuda.synchronize()
            c = {k: v for k, v in launch_counts().items() if v}
            want = {"max_pool2d_backward": 2 * LENET_OPT_STEPS}
            if name == "lookahead":
                want["momentum_update"] = LENET_OPT_STEPS
            if c != want:
                raise AssertionError(f"LeNet {name}: {LENET_OPT_STEPS} steps launched {c}; "
                                     f"want {want}")
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
            err = float(np.abs(np.subtract(losses, cpu)).max())
            control_err = float(np.abs(np.subtract(control, cpu)).max())
            entry = {"losses": losses, "cpu_losses": cpu, "loss_err": err,
                     "control_loss_err": control_err}
            if ma is not None:
                model.eval()
                with torch.no_grad():
                    acc = float((model(held_x).argmax(1) == held_y).float().mean())
                    live = [p.detach().clone() for p in model.parameters()]
                    with ma.apply():
                        avg_acc = float((model(held_x).argmax(1) == held_y).float().mean())
                    back = all(torch.equal(p, q) for p, q in zip(model.parameters(), live))
                entry.update(held_out_acc=acc, held_out_acc_model_average=avg_acc,
                             restored=back, windows=ma.old_num_accumulates)
                if not back or not 0.0 <= avg_acc <= 1.0:
                    raise AssertionError(f"LeNet ModelAverage: {entry}")
            # then the step's device time (it trains on: the readings above come first)
            ms, host_ms = device_ms(lambda: step(*card_batches[0]), 50)
            entry.update(step_ms_host_hidden=ms, host_ms_a_call=host_ms, graphs=len(step.store))
            r[name] = entry
            log(f"LeNet {name}: {LENET_OPT_STEPS} captured steps, {ms:.4f} ms a step (device, "
                f"host hidden; {host_ms:.4f} host ms a call), graphs {entry['graphs']}; losses "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}, {err:.3g} from the CPU's (atol "
                f"{LENET_OPT_LOSS_ATOL}; half-lr control {control_err:.3g})"
                + (f"; held-out accuracy {entry['held_out_acc']:.4f}, under ModelAverage "
                   f"{entry['held_out_acc_model_average']:.4f}" if ma is not None else ""))
            if not (err <= LENET_OPT_LOSS_ATOL < control_err and entry["graphs"] == 1
                    and losses[-1] < losses[0]):
                raise AssertionError(f"LeNet {name}: {entry}")
            del model, step
    finally:
        set_flags({"use_pallas_pool_bwd": False})
    return counts, r


# -- GPT-2 small generation: the ring KV cache, the engine's graphs, continuous serving -------

GPT_SEED = 18
GPT_DEVICE = "cuda"
GPT_SLOTS, GPT_CACHE, GPT_BUCKETS = 16, 1024, (64, 128, 256, 512)
GPT_PARAMS = 124_475_904  # GPT-2 small with the 50,304-token vocabulary
GPT_PARITY_PROMPTS, GPT_NEW = (17, 100, 300, 500), 64
# cached logits against the card's full forward, and the card's full forward
# against the CPU's, relative to the largest |logit|: 12 layers of f32 sums
# in another order sit ~1e-6 apart; a TF32 forward, the control, ~1e-3
GPT_LOGITS_RTOL = 3e-5
GPT_GAP = 1e-3  # tokens are held where the reference's top-two gap is above this
GPT_WRAP_CACHE, GPT_WRAP_BUCKETS, GPT_WRAP_PROMPT, GPT_WRAP_NEW = 128, (32, 64, 128), 100, 100
GPT_EQUAL_STEPS = 3  # decode steps held captured against eager from the same state
GPT_SAMPLES, GPT_TOP_K, GPT_P_MIN = 4096, 50, 1e-3
GPT_REQUESTS, GPT_STREAMED, GPT_SOLO = 32, 4, 8
GPT_PROMPT_LENS, GPT_NEW_LENS = (16, 500), (16, 128)  # the served requests' ranges
GPT_TIMED = 10  # calls a side for each mean wall
_GPT_SRC = "paddle_tpu_torch/generation/engine.py"


def _gpt_model():
    """GPT-2 small (``GPTConfig()``) on the card from a seed, eval, its
    window the cache's."""
    import torch

    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    gen = torch.Generator(device=GPT_DEVICE).manual_seed(GPT_SEED)
    model = GPTForCausalLM(GPTConfig(attention_window=GPT_CACHE), generator=gen, device=GPT_DEVICE)
    return model.eval()


def _gpt_prompt(rng, n, vocab):
    return [int(t) for t in rng.randint(3, vocab, size=n)]


def _full_logits(model, ids, window, blind=False):
    """The card's uncached forward over ``ids``: logits ``[T, V]`` under the
    causal mask of width ``window`` (``blind``: each query also blind to its
    own position, the mask-off-by-one control)."""
    import torch

    from paddle_tpu_torch.nn.transformer import causal_mask

    t = len(ids)
    mask = causal_mask(t, window=window, device=GPT_DEVICE)
    if blind:
        mask = mask + torch.diag(torch.full((t,), -1e9, device=GPT_DEVICE))
    with torch.no_grad():
        return model(torch.tensor([ids], device=GPT_DEVICE), attention_mask=mask)[0]


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


@contextlib.contextmanager
def _tf32():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _tokens_held(tokens, full):
    """(positions held, held ones whose token is not the full forward's
    argmax): a position is held where the top-two gap is above
    ``GPT_GAP``."""
    import torch

    top2 = full.topk(2, dim=-1).values.cpu()
    held = (top2[:, 0] - top2[:, 1]) > GPT_GAP
    wrong = held & (full.argmax(-1).cpu() != torch.tensor(tokens))
    return int(held.sum()), int(wrong.sum())


def _decode_logged(eng, slots, prompts, new):
    """``prompts`` admitted into ``slots`` and decoded greedily to ``new``
    tokens each, every row of logits kept (on the host): (tokens, logits
    ``[new, V]``) by slot."""
    import torch

    toks, rows = {}, {}
    for s, p in zip(slots, prompts):
        toks[s] = [eng.admit(s, p, 0.0)]
        rows[s] = [eng.last_logits[0].to("cpu", copy=True)]
    last = np.zeros(eng.slots, np.int32)
    temps = np.zeros(eng.slots, np.float32)
    for _ in range(new - 1):
        for s in slots:
            last[s] = toks[s][-1]
        nxt = eng.step(last, temps)
        logits = eng.last_logits.to("cpu", copy=True)
        for s in slots:
            toks[s].append(int(nxt[s]))
            rows[s].append(logits[s])
    return toks, {s: torch.stack(r) for s, r in rows.items()}


def _gpt_parity(model, eng):
    """Step 1: 4 prompts decoded 64 greedy tokens through the engine against
    the card's uncached forward over each generated sequence (TF32 and
    mask-off-by-one controls), and one full forward against the CPU's."""
    import torch

    vocab = model.config.vocab_size
    rng = np.random.RandomState(GPT_SEED)
    prompts = [_gpt_prompt(rng, n, vocab) for n in GPT_PARITY_PROMPTS]
    slots = list(range(len(prompts)))
    toks, cached = _decode_logged(eng, slots, prompts, GPT_NEW)
    err = tf32 = 0.0
    held = wrong = wrong_blind = 0
    longest = None
    for s, p in zip(slots, prompts):
        seq = p + toks[s][:-1]
        full = _full_logits(model, seq, GPT_CACHE)[len(p) - 1:]
        with _tf32():
            full_tf32 = _full_logits(model, seq, GPT_CACHE)[len(p) - 1:]
        blind = _full_logits(model, seq, GPT_CACHE, blind=True)[len(p) - 1:]
        err = max(err, _rel_max(cached[s], full.cpu()))
        tf32 = max(tf32, _rel_max(cached[s], full_tf32.cpu()))
        h, w = _tokens_held(toks[s], full)
        held, wrong = held + h, wrong + w
        wrong_blind += _tokens_held(toks[s], blind)[1]
        longest = seq
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        cpu = cpu_model(torch.tensor([longest]))[0]
    card_cpu = _rel_max(_full_logits(model, longest, GPT_CACHE).cpu(), cpu)
    with _tf32():
        card_cpu_tf32 = _rel_max(_full_logits(model, longest, GPT_CACHE).cpu(), cpu)
    del cpu_model
    r = {"prompts": list(GPT_PARITY_PROMPTS), "new_tokens": GPT_NEW,
         "cached_vs_full_rel": err, "control_tf32_rel": tf32, "limit_rel": GPT_LOGITS_RTOL,
         "tokens_held": held, "tokens_compared": GPT_NEW * len(prompts),
         "tokens_differing": wrong, "control_mask_off_by_one_differing": wrong_blind,
         "card_vs_cpu_rel": card_cpu, "card_vs_cpu_control_tf32_rel": card_cpu_tf32}
    log(f"gpt parity: {r}")
    if not (err <= GPT_LOGITS_RTOL < tf32 and card_cpu <= GPT_LOGITS_RTOL < card_cpu_tf32):
        raise AssertionError(f"gpt: logits limit {GPT_LOGITS_RTOL} missed, or a TF32 control "
                             f"passed it: {r}")
    if wrong or not wrong_blind or held < GPT_NEW * len(prompts) // 2:
        raise AssertionError(f"gpt: greedy tokens part from the full forward's argmax at a "
                             f"held position, the off-by-one mask agreed, or too few held: {r}")
    return r


def _gpt_ring_wrap(model):
    """Step 2: a 100-token prompt decoded 100 tokens through a ring of 128
    (it wraps at position 128) against the full forward under a window of
    128; the window of 129 is the control."""
    from paddle_tpu_torch.generation import GenerationEngine

    eng = GenerationEngine(model, slots=1, cache_len=GPT_WRAP_CACHE,
                           prefill_buckets=GPT_WRAP_BUCKETS, seed=GPT_SEED,
                           device=GPT_DEVICE).warmup()
    prompt = _gpt_prompt(np.random.RandomState(GPT_SEED + 1), GPT_WRAP_PROMPT,
                         model.config.vocab_size)
    toks, cached = _decode_logged(eng, [0], [prompt], GPT_WRAP_NEW)
    seq = prompt + toks[0][:-1]
    full = _full_logits(model, seq, GPT_WRAP_CACHE)[len(prompt) - 1:]
    wide = _full_logits(model, seq, GPT_WRAP_CACHE + 1)[len(prompt) - 1:]
    held, wrong = _tokens_held(toks[0], full)
    r = {"cache_len": GPT_WRAP_CACHE, "positions": [len(prompt), len(seq)],
         "cached_vs_window_rel": _rel_max(cached[0], full.cpu()),
         "control_window_plus_one_rel": _rel_max(cached[0], wide.cpu()),
         "limit_rel": GPT_LOGITS_RTOL, "tokens_held": held, "tokens_differing": wrong,
         "graphs": eng.graphs(), "extra_compiles": eng.extra_compiles()}
    log(f"gpt ring wrap: {r}")
    if not (r["cached_vs_window_rel"] <= GPT_LOGITS_RTOL < r["control_window_plus_one_rel"]) \
            or wrong or r["graphs"] != len(GPT_WRAP_BUCKETS) + 1 or r["extra_compiles"]:
        raise AssertionError(f"gpt: the ring past its wrap parts from the windowed forward: {r}")
    return r


def _snapshot_kv(eng):
    return [t.clone() for t in eng.kv]


def _restore_kv(eng, snap):
    for t, s in zip(eng.kv, snap):
        t.copy_(s)


def _gpt_captured_vs_eager(eng, model):
    """Step 3 and 6: every bucket's prefill and ``GPT_EQUAL_STEPS`` decode
    steps at 16 busy slots replayed and run eagerly from the same state,
    bit for bit; TTFT per bucket and the decode step timed both ways (host
    clock, each call ending in the token's copy to the host); one profiled
    decode replay."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    vocab = model.config.vocab_size
    rng = np.random.RandomState(GPT_SEED + 2)
    r = {"ttft_ms": {}}

    def timed(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(GPT_TIMED):
            fn()
        return (time.perf_counter() - t0) * 1e3 / GPT_TIMED

    for bucket in GPT_BUCKETS:
        prompt = _gpt_prompt(rng, bucket, vocab)
        snap = _snapshot_kv(eng)
        got = (eng.admit(1, prompt), eng.last_logits.clone())
        _restore_kv(eng, snap)
        eng.jit = False
        want = (eng.admit(1, prompt), eng.last_logits.clone())
        eager_ms = timed(lambda: eng.admit(1, prompt))
        eng.jit = True
        captured_ms = timed(lambda: eng.admit(1, prompt))
        if got[0] != want[0] or not torch.equal(got[1], want[1]):
            raise AssertionError(f"gpt: the bucket {bucket} prefill replay parts from eager")
        r["ttft_ms"][bucket] = {"captured": captured_ms, "eager": eager_ms}
        log(f"gpt prefill bucket {bucket}: TTFT captured {captured_ms:.3f} ms, eager "
            f"{eager_ms:.3f} ms (host clock, token on the host); replay == eager bit for bit")
    # 16 busy slots
    last = np.zeros(eng.slots, np.int32)
    for s in range(eng.slots):
        last[s] = eng.admit(s, _gpt_prompt(rng, int(rng.randint(GPT_PROMPT_LENS[0],
                                                                GPT_PROMPT_LENS[1] + 1)), vocab))
    temps = np.zeros(eng.slots, np.float32)
    for _ in range(GPT_EQUAL_STEPS):
        snap = _snapshot_kv(eng)
        got = (eng.step(last, temps), eng.last_logits.clone())
        after = _snapshot_kv(eng)
        _restore_kv(eng, snap)
        eng.jit = False
        want = (eng.step(last, temps), eng.last_logits.clone())
        eng.jit = True
        if not (np.array_equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and all(torch.equal(a, b) for a, b in zip(after, eng.kv))):
            raise AssertionError("gpt: a decode replay parts from the eager step from the "
                                 "same state (tokens, logits or cache)")
        last = got[0]
        del snap, after
    eng.jit = False
    eager_ms = timed(lambda: eng.step(last, temps))
    eng.jit = True
    captured_ms = timed(lambda: eng.step(last, temps))
    eng.step(last, temps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(last, temps)
        wall = (time.perf_counter() - t0) * 1e3
    _, busy, events = _log_profile(prof, wall, "gpt decode replay (16 slots)")
    by_kind = _device_time_by_kind(prof)[0]
    if _profiled_launches(prof):
        raise AssertionError(f"gpt: the decode step ran a port kernel: {_profiled_launches(prof)}")
    bytes_moved = eng.param_nbytes() + eng.cache_nbytes()
    r["decode"] = {"captured_ms": captured_ms, "eager_ms": eager_ms, "profiled_wall_ms": wall,
                   "busy_ms": busy, "device_events": events, "by_kind_ms": by_kind,
                   "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
                   "bytes": bytes_moved, "tokens_per_s": eng.slots / captured_ms * 1e3}
    log(f"gpt decode step at 16 busy slots: captured {captured_ms:.3f} ms, eager "
        f"{eager_ms:.3f} ms (host clock, tokens on the host); bound {r['decode']['bound_ms']:.3f} ms "
        f"({bytes_moved} bytes: the weights and the full 16 x {GPT_CACHE} window, once); "
        f"replay == eager bit for bit over {GPT_EQUAL_STEPS} steps")
    return r


def _gpt_sampling(eng):
    """Step 4: 4,096 draws at temperature 1, top-k 50 from one position's
    logits: all inside the top 50, a chi-square test against the softmax
    (the uniform over the top 50 the control it must reject); the greedy
    rows of a mixed-temperature batch equal to pure greedy."""
    import torch
    from scipy import stats

    from paddle_tpu_torch.generation import sample_logits

    rows = eng.last_logits.clone()  # the last decode step's [16, V]
    gen = torch.Generator(device=GPT_DEVICE).manual_seed(GPT_SEED)
    draws = sample_logits(rows[0].expand(GPT_SAMPLES, -1).contiguous(), gen, 1.0,
                          top_k=GPT_TOP_K).cpu().numpy()
    top = rows[0].topk(GPT_TOP_K)
    ids = top.indices.cpu().numpy()
    z = top.values.double().cpu().numpy()
    p = np.exp(z - z.max())
    p /= p.sum()
    inside = np.isin(draws, ids)
    counts = np.array([(draws == i).sum() for i in ids], np.float64)
    pval = stats.chisquare(counts, p * counts.sum()).pvalue
    pval_uniform = stats.chisquare(counts).pvalue
    temps = torch.tensor([0.0, 1.0, 0.0, 0.7] * (rows.shape[0] // 4), device=GPT_DEVICE)
    mixed = sample_logits(rows, gen, temps, top_k=GPT_TOP_K).cpu()
    greedy = sample_logits(rows, gen, 0.0).cpu()
    g = (temps == 0).cpu()
    r = {"draws": GPT_SAMPLES, "top_k": GPT_TOP_K, "outside_top_k": int((~inside).sum()),
         "chi2_p": float(pval), "control_uniform_p": float(pval_uniform), "p_min": GPT_P_MIN,
         "greedy_rows_equal": bool(torch.equal(mixed[g], greedy[g]))}
    log(f"gpt sampling: {r}")
    if r["outside_top_k"] or not pval > GPT_P_MIN > pval_uniform or not r["greedy_rows_equal"]:
        raise AssertionError(f"gpt: sampling failed its checks: {r}")
    return r


def _stream(url, body, timeout=300):
    """POST a streamed ``/generate``: (tokens, final line, arrival times of
    the token lines)."""
    req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, times, final = [], [], None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for line in resp:
            obj = json.loads(line)
            if "token" in obj:
                toks.append(obj["token"])
                times.append(time.perf_counter())
            else:
                final = obj
    return toks, final, times


def _gpt_http(model, solo_eng):
    """Step 5: ``GenerationServer`` with 16 slots, 32 concurrent requests
    (prompts 16-500 tokens, 16-128 new, 4 streamed); 8 answers against solo
    runs; ``/statz`` with no unexpected capture; tokens/s, TTFT and the
    inter-token times."""
    import torch

    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.serving import GenerationServer

    vocab = model.config.vocab_size
    rng = np.random.RandomState(GPT_SEED + 3)
    reqs = [(_gpt_prompt(rng, int(rng.randint(GPT_PROMPT_LENS[0], GPT_PROMPT_LENS[1] + 1)),
                         vocab),
             int(rng.randint(GPT_NEW_LENS[0], GPT_NEW_LENS[1] + 1)))
            for _ in range(GPT_REQUESTS)]
    eng = GenerationEngine(model, slots=GPT_SLOTS, cache_len=GPT_CACHE,
                           prefill_buckets=GPT_BUCKETS, seed=GPT_SEED, device=GPT_DEVICE)
    srv = GenerationServer(eng, port=0, queue_capacity=2 * GPT_REQUESTS)
    t0 = time.perf_counter()
    srv.start()
    warm_s = time.perf_counter() - t0
    out = [None] * GPT_REQUESTS
    gaps = []
    try:
        if _http(srv.url + "/healthz")[0] != 200:
            raise AssertionError("gpt: /healthz not ready after warmup")

        def post(i):
            prompt, new = reqs[i]
            body = {"prompt": prompt, "max_new_tokens": new, "temperature": 0.0}
            if i < GPT_STREAMED:
                toks, final, times = _stream(srv.url, dict(body, stream=True))
                if final is None or final.get("tokens") != toks:
                    raise AssertionError(f"gpt: stream {i} ended {final}")
                gaps.extend(np.diff(times) * 1e3)
                out[i] = toks
            else:
                status, ans = _http(srv.url + "/generate", body)
                if status != 200:
                    raise AssertionError(f"gpt: request {i} answered {status}: {ans}")
                out[i] = ans["tokens"]

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(GPT_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        statz = _http(srv.url + "/statz")[1]
    finally:
        srv.stop(drain=True)
    if any(o is None for o in out):
        raise AssertionError(f"gpt: {sum(o is None for o in out)} requests got no answer")
    tokens = sum(len(o) for o in out)
    solo = [solo_eng.generate([p], max_new_tokens=n, temperature=0.0)[0]
            for p, n in reqs[:GPT_SOLO]]
    same = sum(a == b for a, b in zip(out[:GPT_SOLO], solo))
    r = {"requests": GPT_REQUESTS, "streamed": GPT_STREAMED, "warmup_s": warm_s,
         "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
         "inter_token_ms": {"p50": float(np.percentile(gaps, 50)),
                            "p99": float(np.percentile(gaps, 99)), "count": len(gaps)},
         "statz_latency": statz["latency"], "statz_compiles": statz["compiles"],
         "solo_equal": f"{same}/{GPT_SOLO}", "extra_compiles": eng.extra_compiles(),
         "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"gpt HTTP: {r}")
    if same != GPT_SOLO or statz["compiles"]["unexpected"] or eng.extra_compiles() \
            or statz["compiles"]["programs"] != len(GPT_BUCKETS) + 1:
        raise AssertionError(f"gpt: co-batched answers part from solo runs, or the requests "
                             f"captured graphs: {r}")
    return r


def serve_gpt():
    """Phase 12i. GPT-2 small at full width (``GPTConfig()``: 12 layers, 768
    wide, 12 heads, 1024 positions, a 50,304-token vocabulary; 124,475,904
    parameters from a seed, eval) through ``GenerationEngine`` (16 slots, a
    ring of 1024, prefill buckets 64-512, f32) and ``GenerationServer``.
    Returns (the port's kernel launches over the phase, which must be none:
    the path is pre-norm and cached, plain PyTorch as in the JAX package;
    readings)."""
    import torch

    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = _gpt_model()
    params = sum(p.numel() for p in model.parameters())
    if params != GPT_PARAMS:
        raise AssertionError(f"gpt: {params} parameters, GPT-2 small has {GPT_PARAMS}")
    reset_launch_counts()
    eng = GenerationEngine(model, slots=GPT_SLOTS, cache_len=GPT_CACHE,
                           prefill_buckets=GPT_BUCKETS, seed=GPT_SEED, device=GPT_DEVICE)
    t0 = time.perf_counter()
    eng.warmup()
    r = {"params": params, "param_bytes": eng.param_nbytes(), "kv_cache_bytes": eng.cache_nbytes(),
         "kv_bytes_per_token": eng.kv_bytes_per_token(), "warmup_s": time.perf_counter() - t0,
         "graphs_after_warmup": eng.graphs()}
    log(f"gpt engine warm: {r}")
    if eng.graphs() != eng.expected_compiles() or eng.compile_count() != len(GPT_BUCKETS) + 1:
        raise AssertionError(f"gpt: warmup captured {eng.graphs()} graphs for "
                             f"{len(GPT_BUCKETS)} buckets + decode")
    r["parity"] = _gpt_parity(model, eng)
    r["ring_wrap"] = _gpt_ring_wrap(model)
    r.update(_gpt_captured_vs_eager(eng, model))
    r["sampling"] = _gpt_sampling(eng)
    eng.reset()
    r["http"] = _gpt_http(model, eng)
    r["extra_compiles"] = eng.extra_compiles()
    r["graphs"] = eng.graphs()
    if r["extra_compiles"] or r["graphs"] != len(GPT_BUCKETS) + 1:
        raise AssertionError(f"gpt: the engine captured after warmup: {r['extra_compiles']}")
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"gpt: the generation path launched the port's kernels: {counts}")
    p = GPT_BUCKETS[-1]
    cfg = model.config
    h, f, layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    flops = p * (2 * layers * (4 * h * h + 2 * h * f) + 4 * GPT_CACHE * h * layers
                 + 2 * h * cfg.vocab_size)
    r["prefill_bound_ms"] = {p: max(flops / FP32_FLOPS_PER_S,
                                    eng.param_nbytes() / HBM_BYTES_PER_S) * 1e3}
    r["prefill_flops"] = {p: flops}
    r["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r["phase_s"] = time.perf_counter() - t_phase
    log(f"gpt: phase done in {r['phase_s']:.1f} s, peak {r['peak_memory_gib']:.2f} GiB; "
        f"prefill bound at {p}: {r['prefill_bound_ms'][p]:.3f} ms ({flops / 1e9:.1f} GFLOP)")
    del eng, model
    torch.cuda.empty_cache()
    return counts, r


# -- the int8 serving path and the pool backward --------------------------------

# the served program: the part of BERT-base the int8 rewrite computes in int8
# (a ``mul`` by a weight), at bert_base_config()'s widths and depth
Q_HIDDEN, Q_FFN, Q_LAYERS, Q_CLASSES = 768, 3072, 12, 2
Q_MULS = 2 * Q_LAYERS + 1
Q_BUCKETS = (8, 64, 512)
Q_CALIB_BATCHES, Q_CALIB_ROWS = 4, 64
# the stem's pool at the training batch
POOL_SHAPE, POOL_GEOM = (RN_B, 64, 112, 112), ((3, 3), (2, 2), (1, 1))


_INT8_SRC = "paddle_tpu_torch/csrc/int8_matmul.cu"
_INT8_REPLACES = "paddle_tpu/ops/pallas/int8_matmul.py:154"


def _int8_plan(m, k, n):
    """The split-K slices of ``[m, k] @ [k, n]``: the wrapper's planner,
    required equal to the plan the C side makes for itself."""
    import ctypes

    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import int8_matmul as im

    slices, per = im._split_k(m, k, n)
    fn = _build.library("int8_matmul").ptt_int8_matmul_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    c_slices, c_per = ctypes.c_int(0), ctypes.c_int(0)
    fn(m, k, n, ctypes.byref(c_slices), ctypes.byref(c_per))
    c_plan = (c_slices.value, c_per.value)
    if c_plan != (slices, per):
        raise AssertionError(f"int8 plan at {(m, k, n)}: the C side's {c_plan} is not the "
                             f"planner's {(slices, per)}")
    return slices


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
    slices = _int8_plan(m, k, n)
    splits0 = im.SPLITS
    out = im.int8_matmul(x, w)
    if im.SPLITS - splits0 != (slices > 1):
        raise AssertionError(f"int8_matmul {label}: {im.SPLITS - splits0} split-K calls counted; "
                             f"the plan has {slices} slices")
    ref = im._plain_int8_matmul(x, w)
    torch.cuda.synchronize()
    err = int((out.long() - ref.long()).abs().max())
    if out.dtype != torch.int32 or err != 0:
        raise AssertionError(f"int8_matmul {label} [{m}, {k}] @ [{k}, {n}]: differs from the "
                             f"float64 product by {err}")
    if min(int(x.min()), int(w.min())) != -128 or max(int(x.max()), int(w.max())) != 127:
        raise AssertionError("the int8 operands do not span -128..127")
    t_b, by = bound(m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_OPS_PER_S)
    entry = {"name": "int8_matmul", "route": "cuda", "source": _INT8_SRC,
             "replaces": _INT8_REPLACES, "shape": [m, k, n], "slices": slices,
             "label": label, "dtype": "int8", "max_abs_err": float(err),
             "tolerance": "bit-equal to the float64 product", "bound_ms": t_b, "bound_by": by}
    if not timed:
        log(f"int8_matmul {label} [{m}, {k}] @ [{k}, {n}]: bit-equal")
        return entry
    # device time behind a sleep kernel: at these sizes a call's Python is
    # as long as the kernel, and host-paced events would time the Python
    iters = 100
    ms, host_ms = device_ms_sets(im.int8_matmul, sets, iters)
    plain_ms, _ = device_ms_sets(im._plain_int8_matmul, sets, 20)
    lib_ms, lib_note = None, _int_mm_refusal(x, w, ref)
    if lib_note is None:
        lib_ms, lib_note = device_ms_sets(torch._int_mm, sets, iters)[0], "torch._int_mm"
    log(f"int8_matmul {label} [{m}, {k}] @ [{k}, {n}]: bit-equal, {slices} slice(s); kernel "
        f"{ms:.4f} ms device ({2 * m * k * n / ms / 1e9:.1f} TOP/s; host {host_ms:.4f} ms a "
        f"call), plain (float64) {plain_ms:.4f} ms, library "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} ({lib_note}), bound {t_b:.4f} ms "
        f"({by})")
    entry.update(ms=ms, kernel_ms=ms, host_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
                 library=lib_note, timing="device time behind a sleep kernel")
    return entry


def _int_mm_refusal(x, w, ref):
    """None when ``torch._int_mm`` takes ``x @ w`` (and gives ``ref``), else
    why it does not: the library call has shape limits of its own (M > 16,
    K and N multiples of 8)."""
    import torch

    try:
        out = torch._int_mm(x, w)
    except RuntimeError as e:
        return f"torch._int_mm refuses the shape: {str(e).splitlines()[0][:90]}"
    if not torch.equal(out, ref):
        raise AssertionError(f"torch._int_mm at {tuple(x.shape)} @ {tuple(w.shape)} differs "
                             "from the float64 product")
    return None


def _q_forward_products(bucket):
    """(M, K, N) of the int8 program's 25 products in one forward of
    ``bucket`` rows, in the order the program runs them."""
    return [(bucket, Q_HIDDEN, Q_FFN), (bucket, Q_FFN, Q_HIDDEN)] * Q_LAYERS + [
        (bucket, Q_HIDDEN, Q_CLASSES)]


def check_int8_forward(bucket):
    """Row 15b: the 25 products of one served int8 forward at ``bucket``
    rows, each bit-equal to the float64 product with its split-K calls
    counted against the plan, then the device time of the 25 kernel calls in
    a row (each product its own weight, 56.6 MB in all: past the L2, as in
    the forward) against the same products through ``torch._int_mm`` where
    it takes them."""
    import torch

    from paddle_tpu_torch.ops.cuda import int8_matmul as im

    g = torch.Generator(device="cuda").manual_seed(24)
    shapes = _q_forward_products(bucket)
    sets = [(torch.randint(-128, 128, (m, k), generator=g, device="cuda", dtype=torch.int8),
             torch.randint(-128, 128, (k, n), generator=g, device="cuda", dtype=torch.int8))
            for m, k, n in shapes]
    splits0 = im.SPLITS
    taken = []
    for (m, k, n), (x, w) in zip(shapes, sets):
        ref = im._plain_int8_matmul(x, w)
        if not torch.equal(im.int8_matmul(x, w), ref):
            raise AssertionError(f"int8_matmul [{m}, {k}] @ [{k}, {n}] at bucket {bucket} differs "
                                 "from the float64 product")
        if _int_mm_refusal(x, w, ref) is None:
            taken.append((x, w))
    splits = im.SPLITS - splits0
    want = sum(_int8_plan(*s) > 1 for s in shapes)
    if splits != want:
        raise AssertionError(f"{splits} of the {len(shapes)} int8 products took split-K; the plan "
                             f"splits {want}")
    ms, host_ms = device_ms(lambda: [im.int8_matmul(x, w) for x, w in sets], 10)
    plain = device_ms(lambda: [im._plain_int8_matmul(x, w) for x, w in sets], 3)[0]
    lib = device_ms(lambda: [torch._int_mm(x, w) for x, w in taken], 10)[0] if taken else None
    bounds = [bound(m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_OPS_PER_S) for m, k, n in shapes]
    b = sum(t for t, _ in bounds)
    by = max(("bytes", "operations"), key=lambda u: sum(t for t, w in bounds if w == u))
    lib_note = (f"torch._int_mm over the {len(taken)} of {len(shapes)} products it takes"
                + ("" if len(taken) == len(shapes) else " (it refuses the rest)"))
    log(f"int8 forward bucket {bucket}, {len(shapes)} products: bit-equal, {splits} took split-K; "
        f"device time in a row {ms:.4f} ms (host {host_ms:.4f} ms), plain {plain:.4f} ms, "
        f"library {'none' if lib is None else f'{lib:.4f} ms'} ({lib_note}), bound {b:.4f} ms")
    return {"name": "int8_matmul", "route": "cuda", "source": _INT8_SRC,
            "replaces": _INT8_REPLACES, "label": f"int8 program bucket {bucket}: the "
            f"{len(shapes)} products of a forward in a row, device time", "shape": shapes,
            "dtype": "int8", "max_abs_err": 0.0, "tolerance": "bit-equal to the float64 product",
            "splits": splits, "ms": ms, "kernel_ms": ms, "host_ms": host_ms, "plain_ms": plain,
            "library_ms": lib, "library": lib_note, "bound_ms": b, "bound_by": by}


POOL_KINDS = ("relu", "distinct", "stem layout")


def _pool_input(kind, g):
    """x for :func:`check_pool_backward`: a relu output (zeros tie all over),
    a permutation of 0 .. H*W-1 in every plane, or the stem's own layout: the
    relu'd channels-last buffer of the fused conv, viewed as NCHW."""
    import torch

    n, c, h, w = POOL_SHAPE
    if kind == "relu":
        return torch.relu(torch.randn(POOL_SHAPE, generator=g, device="cuda"))
    if kind == "distinct":
        x = torch.rand(n * c, h * w, generator=g, device="cuda").argsort(-1).float()
        return x.reshape(POOL_SHAPE)
    return torch.relu(torch.randn(n, h, w, c, generator=g, device="cuda")).permute(0, 3, 1, 2)


def check_pool_backward(kind):
    """The max-pool backward kernel at the stem's [128, 64, 112, 112], 3x3/2/1
    against its plain version, bit for bit (:func:`_pool_input` for the
    kinds). torch's own backward is the library yardstick; it keeps the first
    maximum too, and adds an element's taps in another order, so it is held
    to 4 ulps of the largest gradient entry. In the stem layout, x, y and dy
    are channels-last as the step gives them, dx must come back
    channels-last, and the whole autograd backward of the pool is timed with
    ``FLAGS_use_pallas_pool_bwd`` on and off, alone and followed by the fused
    conv's move of its dy to NHWC (``.contiguous()``, a copy unless dx is
    channels-last already)."""
    import torch

    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.ops.cuda import pool_backward as pb

    g = torch.Generator(device="cuda").manual_seed(22)
    ks, st, pad = POOL_GEOM
    stem = kind == "stem layout"
    x = _pool_input(kind, g)
    xr = x.detach().requires_grad_()
    y = PF.max_pool2d(xr, ks, st, pad)
    dy = torch.randn(y.shape, generator=g, device="cuda")
    if stem:  # the gradient from layer1's convs comes back channels-last
        dy = dy.contiguous(memory_format=torch.channels_last)
    yd = y.detach()
    layouts = [pb.memory_layout(t) for t in (x, yd, dy)]
    if layouts != ["nhwc" if stem else "nchw"] * 3:
        raise AssertionError(f"max_pool2d_backward ({kind}): x, y, dy lie as {layouts}")
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
    if pb.memory_layout(dx) != layouts[0]:
        raise AssertionError(f"max_pool2d_backward ({kind}): dx lies as "
                             f"{pb.memory_layout(dx)}, x as {layouts[0]}")
    if lib_err > 4 * ulp:
        raise AssertionError(f"max_pool2d_backward ({kind}): {lib_err} from torch's backward, "
                             f"beyond 4 ulps ({4 * ulp}): another tie rule?")
    t_b, by = bound(4 * (2 * x.numel() + 2 * yd.numel()), 9 * x.numel())
    args = [(x, yd, dy, ks, st, pad)]
    ms, host_ms = device_ms_sets(pb.max_pool2d_backward, args, 20)
    plain_ms = device_ms_sets(pb._plain_max_pool2d_backward, args, 5)[0]
    lib_ms = device_ms(lambda: torch.autograd.grad(y, xr, dy, retain_graph=True), 20)[0]
    entry = {"name": "max_pool2d_backward", "route": "cuda",
             "source": "paddle_tpu_torch/csrc/pool_backward.cu",
             "replaces": "paddle_tpu/ops/pallas/pool_backward.py:244", "shape": list(POOL_SHAPE),
             "geometry": "3x3 stride 2 padding 1", "input": kind, "layout": layouts[0],
             "dtype": "float32", "max_abs_err": err, "tolerance": "bit-equal to the plain version",
             "library_max_abs_err": lib_err, "ms": ms, "kernel_ms": ms, "host_ms": host_ms,
             "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by, "library_ms": lib_ms,
             "library": "torch's max_pool2d backward (autograd.grad) at the same layout",
             "timing": "device time behind a sleep kernel"}
    note = ""
    if stem:
        whole = {}
        try:
            for on in (True, False, False, True):  # in turns
                set_flags({"use_pallas_pool_bwd": on})
                xs = x.detach().requires_grad_()
                ys = PF.max_pool2d(xs, ks, st, pad)
                launches0 = pb.LAUNCHES
                (gx,) = torch.autograd.grad(ys, xs, dy, retain_graph=True)
                if (pb.LAUNCHES - launches0 != int(on) or not torch.equal(gx, dx if on else lib)
                        or (on and pb.memory_layout(gx) != "nhwc")):
                    raise AssertionError(f"the stem pool's autograd backward, flag {on}: "
                                         f"{pb.LAUNCHES - launches0} launches, layout "
                                         f"{pb.memory_layout(gx)}, or another gradient")
                alone = device_ms(lambda: torch.autograd.grad(ys, xs, dy, retain_graph=True),
                                  20)[0]
                conv = device_ms(lambda: torch.autograd.grad(ys, xs, dy, retain_graph=True)[0]
                                 .permute(0, 2, 3, 1).contiguous(), 20)[0]
                whole.setdefault(on, []).append((alone, conv))
        finally:
            set_flags({"use_pallas_pool_bwd": False})
        for on in (True, False):
            alone, conv = (float(np.mean([r[i] for r in whole[on]])) for i in (0, 1))
            entry[f"autograd_flag_{'on' if on else 'off'}_ms"] = alone
            entry[f"autograd_and_conv_dy_flag_{'on' if on else 'off'}_ms"] = conv
        note = (f"; autograd backward flag on {entry['autograd_flag_on_ms']:.4f} ms, off "
                f"{entry['autograd_flag_off_ms']:.4f} ms; with the conv's dy to NHWC on "
                f"{entry['autograd_and_conv_dy_flag_on_ms']:.4f}, off "
                f"{entry['autograd_and_conv_dy_flag_off_ms']:.4f} ms")
    log(f"max_pool2d_backward {list(POOL_SHAPE)} 3x3/2/1, {kind} input ({layouts[0]})"
        f"{f' ({zeros:.0%} of x is 0)' if kind != 'distinct' else ''}: "
        f"bit-equal to the plain version; {lib_err:.3g} from torch's backward (4 ulps = "
        f"{4 * ulp:.3g}: the same first-maximum rule, another order of adding); kernel "
        f"{ms:.4f} ms device (host {host_ms:.4f} ms a call), plain {plain_ms:.4f} ms, library "
        f"(torch's backward) {lib_ms:.4f} ms, bound {t_b:.4f} ms ({by}){note}")
    return entry


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
        check_int8_matmul(300, 129, 257, "ragged", timed=False),
        check_int8_matmul(100, 1000, 70, "ragged, split-K", timed=False),
        check_int8_matmul(Q_BUCKETS[0], Q_FFN, Q_CLASSES, "split-K, N = 2", timed=False)]
    mm["also_checked"] += [check_int8_forward(b) for b in Q_BUCKETS]
    pool = check_pool_backward(POOL_KINDS[0])
    pool["also_checked"] = ([check_pool_backward(kind) for kind in POOL_KINDS[1:]]
                            + [check_pool_backward_lenet(shape) for shape in LENET_POOLS])
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
    """Time of one forward per bucket, the rows already on the card: CUDA
    events around 20 forwards enqueued back to back. Each forward is a
    replay of the executor's graph for the bucket (the first call of a
    bucket captures it) and a copy of the fetches on the card, so the card
    no longer waits on the executor's Python between ops as it did when
    the executor interpreted each forward; where the host enqueues a replay
    faster than the card runs it, this is the card's time. Returns
    ``{bucket: ms}``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(23)
    out = {}
    for bucket in Q_BUCKETS:
        x = torch.randn(bucket, Q_HIDDEN, generator=g, device="cuda")
        out[bucket] = time_ms(lambda x: exe.run(program, feed={"x": x}, fetch_list=fetch_names,
                                                scope=scope, return_numpy=False), [(x,)], 20)
    log(f"{label} forward, replayed, ms a bucket: "
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
    directory alone. Returns (kernel launches per name on the serving run,
    readings)."""
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

    answers, counts, forwards, readings = _serve(pred, Q_BUCKETS, reqs, "int8 program")
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

    readings["weight_replaced"] = _replace_weight(pred, reqs[0]["x"].astype(np.float32))
    int8_ms = _forward_ms(pred._exe, pred._program, pred._scope, [fetch], "int8 program")
    log("forward ms, replayed, int8 beside f32: "
        + ", ".join(f"bucket {b}: {int8_ms[b]:.3f} / {f32_ms[b]:.3f}" for b in Q_BUCKETS))
    feeds = {b: _q_feed(b, 32 + b) for b in Q_BUCKETS}
    readings["by_bucket"] = _captured_vs_eager(pred, feeds, _eager_program_run(pred),
                                               "int8 program")
    readings["concurrent"] = _concurrent_replays(pred, _q_feed, 64, 100, "int8 program")
    return counts, readings


def _q_feed(bucket, seed):
    return [np.random.RandomState(seed).randn(bucket, Q_HIDDEN).astype(np.float32)]


def _eager_program_run(pred):
    """``pred.run``'s eager counterpart: the executor's interpreter on the
    host feeds moved to the card, the fetches copied to the host."""
    import torch

    block = pred._program.global_block()

    def run(feed):
        with torch.no_grad():
            env = {n: torch.from_numpy(a).cuda() for n, a in zip(pred.get_input_names(), feed)}
            out = pred._exe._interpret(block, env, pred._scope, pred.get_output_names())
        return [t.cpu().numpy() for t in out]

    return run


def _replace_weight(pred, a):
    """Add 1 to the last product's bias through ``Scope.set``: the next
    answer must follow it (the scope's new generation keys a new graph, so
    the old graph, which reads the old tensor, does not replay), and setting
    the old tensor back must bring the old answer back. Returns the
    readings."""
    ops = pred._program.global_block().ops
    name = next(op.inputs["X"][1] for op in reversed(ops) if op.type == "elementwise_add")
    old = pred._scope.get(name)
    misses0 = pred.store.misses
    before = pred.run([a])[0]
    pred._scope.set(name, old + 1.0)
    try:
        after = pred.run([a])[0]
    finally:
        pred._scope.set(name, old)
    pred.run([a])  # the capture; then a replay, as ``before`` was
    back = pred.run([a])[0]
    err = float(np.abs(after - (before + 1.0)).max())
    r = {"bias": name, "max_err_vs_old_plus_1": err, "restored_bit_equal": bool(
        np.array_equal(back, before)), "captures": pred.store.misses - misses0}
    log(f"int8 program: a weight replaced through Scope.set: {r}")
    if err > 1e-4 or not r["restored_bit_equal"] or r["captures"] != 2:
        raise AssertionError(f"int8 program: the replaced weight did not show: {r}")
    return r


# the sources rewritten last, whose registers and spills the run logs
PTXAS_SOURCES = ("flash_attention", "flash_attention_bwd", "flash_attention_bf16",
                 "flash_attention_bwd_bf16", "layernorm_residual", "layernorm_residual_bwd",
                 "optimizer_update",
                 "conv_bn_relu_mm", "conv_bn_relu_mm_bf16", "conv_bn_relu_bn", "int8_matmul",
                 "pool_backward")
# of those, the sources whose kernels must not spill
NO_SPILL_SOURCES = ("conv_bn_relu_mm", "conv_bn_relu_mm_bf16", "conv_bn_relu_bn", "int8_matmul",
                    "pool_backward")


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
            if name in NO_SPILL_SOURCES and (info.get("spill_stores") or info.get("spill_loads")):
                raise AssertionError(f"{name}.cu {kname} spills: {info}")
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
    # the wgmma kernels, and the LayerNorm forward's warp-a-row instances
    for src in ("flash_attention_bf16", "flash_attention_bwd_bf16", "conv_bn_relu_mm_bf16",
                "layernorm_residual"):
        for kname, info in registers[src].items():
            print(f"ptxas {src}.cu {kname}: {json.dumps(info)}")

    kernels = (check_kernels() + check_amp_kernels() + check_resnet_kernels() + check_new_kernels()
               + check_resnet_kernels_bf16())
    for name, entry in check_layernorm_h512().items():  # new shapes of rows 1, 1b, 2, 2b
        next(k for k in kernels if k["name"] == name).setdefault("also_checked", []).append(entry)
    served, serving = {}, {}
    served["bert"], serving["bert"] = serve_bert()
    trained = train_bert()
    torch.cuda.empty_cache()
    amp_trained, amp = train_bert_amp()
    torch.cuda.empty_cache()
    served["resnet"], serving["resnet"] = serve_resnet()
    served["int8"], serving["int8"] = serve_int8()
    torch.cuda.empty_cache()
    rn_trained = train_resnet()
    torch.cuda.empty_cache()
    rn_amp_trained, rn_amp = train_resnet_amp()
    torch.cuda.empty_cache()
    rn_amp_served, rn_amp["eval"] = eval_resnet_amp()
    torch.cuda.empty_cache()
    compiled_counts, compiled = compiled_steps()
    s2s_counts, s2s = train_seq2seq_and_ernie()
    torch.cuda.empty_cache()
    lenet_counts, lenet = train_lenet_static()
    torch.cuda.empty_cache()
    lamb_counts, lamb = train_bert_lamb(compiled["bert_amp"]["captured"]["step_ms_median"])
    lenet_opt_counts, lenet_opt = train_lenet_optimizers()
    gpt_counts, gpt = serve_gpt()
    for k in kernels:
        name = k["name"]
        k["launches_serving"] = (sum(c[name] for c in served.values()) + rn_amp_served[name]
                                 + s2s_counts["serving"].get(name, 0))
        k["launches_training"] = (trained[name] + amp_trained[name] + rn_trained[name]
                                  + rn_amp_trained[name] + s2s_counts["training"].get(name, 0))
        # replayed in CUDA graphs (BERT under Lamb, LeNet under the other optimizers too)
        k["launches_compiled"] = (compiled_counts[name] + s2s_counts["compiled"].get(name, 0)
                                  + lamb_counts.get(name, 0) + lenet_opt_counts.get(name, 0))
        # the LeNet program's steps, replayed from the static executor's graph
        k["launches_static"] = lenet_counts.get(name, 0)
        # GPT-2 small's generation (pre-norm, cached attention): none, checked
        k["launches_generation"] = gpt_counts.get(name, 0)
        k["launches"] = (k["launches_serving"] + k["launches_training"] + k["launches_compiled"]
                         + k["launches_static"] + k["launches_generation"])
        src = k["source"].rsplit("/", 1)[-1][:-len(".cu")]
        if src in registers:
            k["ptxas"] = registers[src]
    print(card)
    print(json.dumps({"kernels": kernels, "amp_bert_training": amp, "amp_resnet": rn_amp,
                      "compiled": compiled, "serving": serving, "seq2seq_ernie": s2s,
                      "lenet_static": lenet, "bert_lamb": lamb, "lenet_optimizers": lenet_opt,
                      "gpt_generation": gpt}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
