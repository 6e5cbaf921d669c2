#!/usr/bin/env python3
"""Hold this tree's bf16 wgmma kernels bit for bit against another tree's.

    python3 tools/bf16_bits_ab.py DIR

``DIR`` holds another checkout's ``paddle_tpu_torch/csrc`` (for example
``git archive <commit> paddle_tpu_torch/csrc | tar -x -C build/parent``, in
a directory ``.gitignore`` lists). On a card with ``nvcc``, this builds the
bf16 sources that include ``csrc/wgmma_attention.cuh`` (the attention
forward and backward, the 16-bit conv GEMM), the residual LayerNorm
sources, the batch-norm passes and the max-pool backward from both trees
with the flags of ``ops/cuda/_build.py``, runs each tree's libraries
through this tree's wrappers on the same seeded inputs (the attention with
dropout and a pad bias, causal with ragged rows, the LayerNorm forward in
bf16 and in its mixed instance and its backward, ``mm_stats`` and
``mm_affine_relu`` with and without split-K, the four batch-norm passes,
the pool backward channels-last), and prints one JSON line: whether every
output is bit-equal. Exits 1 when one is not.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from paddle_tpu_torch.ops.cuda import _build  # noqa: E402
from paddle_tpu_torch.ops.cuda import conv_bn_relu as cbr  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops.cuda import layernorm_residual as lnr  # noqa: E402
from paddle_tpu_torch.ops.cuda import pool_backward as pb  # noqa: E402

SOURCES = ("flash_attention_bf16", "flash_attention_bwd_bf16", "conv_bn_relu_mm_bf16",
           "layernorm_residual", "layernorm_residual_bwd", "conv_bn_relu_bn", "pool_backward")


def build(trees, out_dir):
    """One nvcc a source and tree, all at once; {tree: {source: CDLL}}."""
    procs = []
    for tag, csrc in trees.items():
        for name in SOURCES:
            so = os.path.join(out_dir, f"{tag}_{name}.so")
            procs.append((tag, name, so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so,
                 os.path.join(csrc, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {tag: {} for tag in trees}
    for tag, name, so, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag} {name}.cu:\n{text}")
        libs[tag][name] = ctypes.CDLL(os.path.abspath(so))
    return libs


def outputs():
    """Every output of the bf16 entries on inputs from one seed."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn(8, 12, 512, 64, generator=g, device=dev).bfloat16()
                   for _ in range(4))
    seed = fa._draw_seed(g, dev)
    bias = torch.randn(8, 1, 1, 512, generator=g, device=dev)
    o, lse, keep = fa.flash_attention_fwd(q, k, v, bias, False, 0.125, 0.1, seed)
    grads = fa.flash_attention_bwd(q, k, v, bias, o, lse, do, False, 0.125, 0.1, keep)
    qc, dc = q[:, :, :300].contiguous(), do[:, :, :300].contiguous()
    oc, lc = fa.flash_attention_fwd(qc, k, v, None, True, 0.125)
    gc = fa.flash_attention_bwd(qc, k, v, None, oc, lc, dc, True, 0.125)
    x, r, dy = (torch.randn(4096, 768, generator=g, device=dev).bfloat16() for _ in range(3))
    w = torch.randn(768, generator=g, device=dev)
    y, mean, rstd = lnr.layernorm_residual_fwd(x, r, w, w)
    ym = lnr.layernorm_residual_fwd(x, r.float(), w, w)[0]
    ln_bwd = lnr.layernorm_residual_bwd(x, r, w, mean, rstd, dy)
    p2 = torch.randn(12544, 576, generator=g, device=dev).bfloat16()
    w2 = torch.randn(576, 64, generator=g, device=dev).bfloat16()
    co, part = cbr.mm_stats(p2, w2)
    one, zero = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    yy = cbr.mm_affine_relu(p2, w2, one, zero)
    # layer4's 3x3 conv at batch 1: the planner splits K
    p2k = torch.randn(49, 4608, generator=g, device=dev).bfloat16()
    w2k = torch.randn(4608, 512, generator=g, device=dev).bfloat16()
    ys = cbr.mm_affine_relu(p2k, w2k, torch.ones(512, device=dev), torch.zeros(512, device=dev))
    gy = torch.randn(12544, 64, generator=g, device=dev).bfloat16()
    vec = torch.randn(64, generator=g, device=dev)
    bn = {"bn_sumsq": cbr.centered_sumsq(co, vec), "bn_y": cbr.bn_relu(co, one, vec),
          "bn_partials": torch.cat(cbr.bn_bwd_partials(co, gy, one, vec)),
          "bn_dco": cbr.bn_bwd_dco(co, gy, one, vec, vec * 1e-3, vec * 1e-3)}
    x4 = torch.relu(torch.randn(8, 32, 32, 64, generator=g, device=dev)).bfloat16()
    x4 = x4.permute(0, 3, 1, 2)
    y4 = torch.nn.functional.max_pool2d(x4, 3, 2, 1).contiguous(memory_format=torch.channels_last)
    dy4 = torch.randn(y4.shape, generator=g, device=dev).bfloat16().contiguous(
        memory_format=torch.channels_last)
    pool = pb.max_pool2d_backward(x4, y4, dy4, (3, 3), (2, 2), (1, 1))
    torch.cuda.synchronize()
    return {"attention_out": o, "attention_lse": lse, "attention_mask": keep,
            "attention_dq": grads[0], "attention_dk": grads[1], "attention_dv": grads[2],
            "causal_out": oc, "causal_lse": lc, "causal_dq": gc[0], "causal_dk": gc[1],
            "causal_dv": gc[2], "layernorm_y": y, "layernorm_mean": mean, "layernorm_rstd": rstd,
            "layernorm_mixed_y": ym, "layernorm_da": ln_bwd[0], "layernorm_dw": ln_bwd[1],
            "layernorm_db": ln_bwd[2], "conv_co": co, "conv_sums": part, "conv_y": yy,
            "conv_y_split": ys, **bn, "pool_dx": pool}


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.join(sys.argv[1], "paddle_tpu_torch", "csrc")
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "bits_ab")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    libs = build({"this": _build.CSRC_DIR, "other": other}, out_dir)
    built_s = time.perf_counter() - t0
    got = {}
    for tag in ("this", "other"):
        _build._libs.update(libs[tag])
        got[tag] = outputs()
    equal = {n: bool(torch.equal(got["this"][n], got["other"][n])) for n in got["this"]}
    print(json.dumps({"bit_equal": all(equal.values()), "outputs": equal,
                      "card": torch.cuda.get_device_name(0), "built_s": built_s}))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
