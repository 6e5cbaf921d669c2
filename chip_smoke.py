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
   dK/dV kernels must equal the plain version's bit for bit;
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
7. print the card line, then one JSON line with every kernel's numbers;
8. print ``{"ok": true, "device": {...}}`` as the last line.

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


def check_layernorm_bwd(dtype_name):
    """The backward kernel at the training path's [16384, 768] against the
    plain version on the same inputs and saved statistics (the forward's
    statistics at this shape are checked by ``check_layernorm``)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import layernorm_residual as lnr

    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(3)
    dev, rows, h, eps = "cuda", TRAIN_ROWS, LN_H, 1e-5
    w = torch.randn(h, generator=g, device=dev)
    b = torch.randn(h, generator=g, device=dev)
    sets = []
    for _ in range(3):
        x, r, dy = (torch.randn(rows, h, generator=g, device=dev).to(dtype) for _ in range(3))
        _, mean, rstd = lnr.layernorm_residual_fwd(x, r, w, b, eps)
        sets.append((x, r, w, mean, rstd, dy))
    x, r, _, mean, rstd, dy = sets[0]
    da, dwp, dbp = lnr.layernorm_residual_bwd(*sets[0])
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
    if not ok:
        raise AssertionError(f"layernorm_residual_bwd {dtype_name}: da err {err}, dw {dw_err}, "
                             f"db {db_err} beyond {tol}")
    in_bytes = x.element_size()
    # x, res, dy read and da written; mean, rstd, w read; dw, db written (the
    # function's outputs: the kernel's per-block partials are its own choice)
    t_b, by = bound(rows * h * 4 * in_bytes + 8 * rows + 4 * h + 8 * h, 12 * rows * h)
    ms = time_ms(lnr.layernorm_residual_bwd, sets, 100)
    plain_ms = time_ms(lnr._reference_bwd, sets, 100)
    graphs = []
    for x_, r_, w_, _, _, dy_ in sets:
        ins = [t.detach().requires_grad_() for t in (x_, r_, w_, b)]
        y = F.layer_norm(ins[0] + ins[1], (h,), ins[2].to(dtype), ins[3].to(dtype), eps)
        graphs.append((y, ins, dy_))
    lib_ms = time_ms(lambda y, ins, dy_: torch.autograd.grad(y, ins, dy_, retain_graph=True),
                     graphs, 100)
    log(f"layernorm_residual_bwd {dtype_name} [{rows}, {h}]: da err {err:.3g}, dw {dw_err:.3g}, "
        f"db {db_err:.3g} ({tol}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{lib_ms:.4f} ms, bound {t_b:.4f} ms ({by})")
    return {"name": "layernorm_residual_bwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/layernorm_residual_bwd.cu",
            "replaces": "paddle_tpu/ops/pallas/layernorm_residual.py:219",
            "shape": [rows, h], "dtype": dtype_name, "max_abs_err": err,
            "dw_rel_err": dw_err, "db_rel_err": db_err, "tolerance": tol, "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": t_b, "bound_by": by,
            "library_ms": lib_ms}


def _pad_bias(g, batch, seq):
    """BERT's additive mask: -1e4 on trailing pad keys, one length per row."""
    import torch

    lens = torch.randint(seq // 2, seq + 1, (batch,), generator=g, device="cuda")
    keep = torch.arange(seq, device="cuda")[None, :] < lens[:, None]
    return ((1.0 - keep.float()) * -1e4)[:, None, None, :]


def check_flash_bwd(batch, seq, rate, causal, replaces):
    """The dQ and dK/dV kernels at [batch, 12, seq, 64] with a pad bias
    against autograd through the plain version with the same dropout seed.
    Returns the two kernels' entries."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(4)
    shape = (batch, FLASH_H, seq, FLASH_D)
    scale = FLASH_D ** -0.5

    def make():
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda") for _ in range(4))
        bias = _pad_bias(g, batch, seq)
        seed = fa._draw_seed(g, "cuda") if rate else None
        out, lse = fa.flash_attention_fwd(q, k, v, bias, causal, scale, rate, seed)
        delta = (do * out).sum(-1).reshape(-1, seq)
        return q, k, v, bias, lse, delta, do, causal, scale, rate, seed, out

    sets = [make() for _ in range(3)]
    args = sets[0][:-1]
    q, k, v, bias, lse, delta, do = args[:7]
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    pq, pk, pv = fa._plain_bwd(q, k, v, bias, sets[0][-1], lse, do, causal, scale, rate,
                               args[-1])
    torch.cuda.synchronize()
    errs = [float((a - b_).abs().max()) for a, b_ in zip((dq, dk, dv), (pq, pk, pv))]
    label = f"flash backward {list(shape)} rate {rate}{' causal' if causal else ''}"
    if max(errs) > FLASH_ATOL:
        raise AssertionError(f"{label}: dq/dk/dv err {errs} beyond atol {FLASH_ATOL}")
    # query-key pairs the function needs: all, or the causal triangle
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    bhld = batch * FLASH_H * pairs * FLASH_D
    stats = 8 * batch * FLASH_H * seq + 4 * batch * seq  # lse, delta, the [B,1,1,L] bias
    t_dq, by_dq = bound(4 * 5 * q.numel() + stats, 6 * bhld)      # q k v dO read, dQ written
    t_dkv, by_dkv = bound(4 * 6 * q.numel() + stats, 8 * bhld)    # ... dK dV written
    t_all, _ = bound(4 * 8 * q.numel() + stats, 10 * bhld)
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
            mask = bias_ + torch.full((seq, seq), -1e30, device="cuda").triu(1)
        o = F.scaled_dot_product_attention(*ins, attn_mask=mask)
        graphs.append((o, ins, _rest[2]))
    lib_ms = time_ms(lambda o, ins, do_: torch.autograd.grad(o, ins, do_, retain_graph=True),
                     graphs, 10)
    log(f"{label}: err dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} (atol {FLASH_ATOL}); "
        f"dQ {ms_dq:.4f} ms (bound {t_dq:.4f}, {by_dq}), dK/dV {ms_dkv:.4f} ms (bound "
        f"{t_dkv:.4f}, {by_dkv}), whole backward {whole_ms:.4f} ms (bound {t_all:.4f}), plain "
        f"{plain_ms:.4f} ms, library (SDPA backward, no dropout) {lib_ms:.4f} ms")
    common = {"route": "cuda", "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
              "shape": list(shape), "dtype": "float32", "dropout_rate": rate,
              "causal": causal, "tolerance": f"atol {FLASH_ATOL}",
              "plain_ms": plain_ms, "library_ms": None,
              "backward_total": {"ms": whole_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                 "library": "scaled_dot_product_attention backward, no dropout",
                                 "bound_ms": t_all}}
    dq_entry = {"name": "flash_attention_bwd_dq", "replaces": replaces[0],
                "max_abs_err": errs[0], "ms": ms_dq, "kernel_ms": ms_dq, "bound_ms": t_dq,
                "bound_by": by_dq, **common}
    dkv_entry = {"name": "flash_attention_bwd_dkv", "replaces": replaces[1],
                 "max_abs_err": max(errs[1:]), "ms": ms_dkv, "kernel_ms": ms_dkv,
                 "bound_ms": t_dkv, "bound_by": by_dkv, **common}
    return dq_entry, dkv_entry


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
    t_b, by = bound(4 * (4 * q.numel() + TRAIN_B * TRAIN_SEQ + TRAIN_B * FLASH_H * TRAIN_SEQ),
                    4 * TRAIN_B * FLASH_H * TRAIN_SEQ * TRAIN_SEQ * FLASH_D)
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
        f"{lib_ms:.4f} ms, bound {t_b:.4f} ms ({by})")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:548", "shape": list(shape),
            "dtype": "float32", "dropout_rate": ATTN_DROPOUT, "max_abs_err": err,
            "tolerance": f"atol {FLASH_ATOL}", "ms": ms, "kernel_ms": ms,
            "kernel_ms_without_dropout": ms_nodrop, "plain_ms": plain_ms, "bound_ms": t_b,
            "bound_by": by, "library_ms": lib_ms,
            "library": f"scaled_dot_product_attention, dropout_p {ATTN_DROPOUT}, its own mask"}


def check_kernels():
    """One entry per kernel of the serving and training paths. The
    LayerNorm kernels and the attention backward stand at the shape and
    dtype the training path gives them (f32, batch 32 x L=512), the
    attention forward at the serving shape, as before. The other shapes and
    options checked ride along under ``also_checked``, without launch
    counts: the LayerNorm forward at the serving shape and in bf16, the
    attention forward at the training shape with dropout and at L=128
    (where the TPU took its small variant), the dropout masks, and the
    attention backward at rate 0 and causal at L=128."""
    ln = check_layernorm("float32", TRAIN_ROWS)
    ln["also_checked"] = [check_layernorm("float32", LN_ROWS),
                          check_layernorm("bfloat16", LN_ROWS)]
    ln_bwd = check_layernorm_bwd("float32")
    ln_bwd["also_checked"] = [check_layernorm_bwd("bfloat16")]
    fa = check_flash(SEQ_LEN, "paddle_tpu/ops/pallas/flash_attention.py:548")
    fa["also_checked"] = [check_flash(128, "paddle_tpu/ops/pallas/flash_attention.py:370"),
                          check_flash_dropout_fwd(), {"dropout_masks": check_dropout_masks()}]
    tiled = ("paddle_tpu/ops/pallas/flash_attention.py:765",
             "paddle_tpu/ops/pallas/flash_attention.py:815")
    small = ("paddle_tpu/ops/pallas/flash_attention.py:433",) * 2
    dq, dkv = check_flash_bwd(TRAIN_B, TRAIN_SEQ, ATTN_DROPOUT, False, tiled)
    for extra in (check_flash_bwd(TRAIN_B, TRAIN_SEQ, 0.0, False, tiled),
                  check_flash_bwd(FLASH_B, 128, ATTN_DROPOUT, True, small)):
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
                 "layernorm_residual_fwd", "layernorm_residual_bwd")


def _kernel_kind(name):
    n = name.lower()
    for kind in _KERNEL_KINDS:
        if f"{kind}_kernel" in n:
            return kind
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    if "gemm" in n or "cutlass" in n or "xmma" in n:
        return "matmul"
    return "other"


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
        by_kind, events = _device_time_by_kind(prof)
        busy = sum(by_kind.values())
        log(f"Predictor.run bucket {bucket}: {wall_ms:.3f} ms wall, device busy {busy:.3f} ms "
            f"({busy / wall_ms:.1%}) in {events} device events; by kind (ms): "
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


def train_bert():
    """Phase 6. Returns kernel launches per name over the timed steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import bert_base_config
    from paddle_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    train_parity()
    cfg = bert_base_config()  # hidden and attention dropout 0.1
    cfg.use_flash_attention = True
    model, loss_fn = _pretraining(cfg, seed=1)
    step = _step_of(model, loss_fn)
    batch = [torch.from_numpy(a).cuda() for a in
             pretraining_batch(cfg, TRAIN_B, TRAIN_SEQ, TRAIN_PRED, np.random.RandomState(9))]
    losses = [step(*batch)["loss"]]  # warm-up: cuBLAS handles, the allocator's pool
    torch.cuda.synchronize()
    reset_launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        losses.append(step(*batch)["loss"])
        events[i + 1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    counts = launch_counts()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(TRAIN_STEPS)]
    losses = [float(x) for x in losses]
    layers = cfg.num_hidden_layers
    want = {"layernorm_residual_fwd": 2 * layers, "layernorm_residual_bwd": 2 * layers,
            "flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers}
    want = {k: n * TRAIN_STEPS for k, n in want.items()}
    if counts != want:
        raise AssertionError(f"{TRAIN_STEPS} steps launched {counts}; want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    tokens = TRAIN_B * TRAIN_SEQ
    mean_ms = float(np.mean(step_ms))
    log(f"{TRAIN_STEPS} steps at batch {TRAIN_B} x L={TRAIN_SEQ}, {TRAIN_PRED} masked a row, "
        f"dropout {cfg.hidden_dropout_prob}: losses {', '.join(f'{x:.6f}' for x in losses)}")
    log(f"step {mean_ms:.2f} ms (min {min(step_ms):.2f}, max {max(step_ms):.2f}; host clock "
        f"{wall_ms:.2f}), {tokens / mean_ms * 1e3:.0f} tokens/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {counts}: "
        f"{2 * layers} + {2 * layers} LayerNorm, {layers} attention forward, {layers} dQ, "
        f"{layers} dK/dV a step")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kind, events = _device_time_by_kind(prof)
    busy = sum(by_kind.values())
    log(f"train step profiled: {wall:.3f} ms wall, device busy {busy:.3f} ms "
        f"({busy / wall:.1%}) in {events} device events; by kind (ms): "
        + ", ".join(f"{k} {v:.3f} ({v / busy:.1%})" for k, v in
                    sorted(by_kind.items(), key=lambda kv: -kv[1])))
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
    served = serve_bert()
    trained = train_bert()
    for k in kernels:
        k["launches"] = served[k["name"]] + trained[k["name"]]
        k["launches_serving"], k["launches_training"] = served[k["name"]], trained[k["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
