#!/usr/bin/env python3
"""Where the conv GEMM's time goes, on one NVIDIA card (H100).

    python3 tools/conv_mm_ablation.py

Builds ``paddle_tpu_torch/csrc/conv_bn_relu_mm.cu`` as it is and in three
ablated variants, each a text edit of the source that drops one cost and
so computes a wrong answer:

- ``no_copies``: the ring is filled once and never refilled (no device
  memory traffic past the first slabs);
- ``two_passes``: the hi*lo pass of the three 3xTF32 tensor-core passes is
  left out;
- ``no_splits``: operands enter the tensor cores unsplit (hi = the f32
  bits, lo = 0), so the splitting arithmetic is gone; the three passes stay.

Times each variant's eval and training entries at layer1's 3x3 conv and
the stem at batch 128 and layer4's 3x3 conv (K = 4608), beside
``torch.matmul`` on the same inputs (CUDA events, two input sets cycled
past the L2), and prints the card's ``name, power.limit`` and one JSON
line. An edit that no longer matches the source fails the run: update it
with the kernel.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((401408, 576, 64, "layer1 3x3, batch 128"), (1605632, 147, 64, "stem, batch 128"),
          (6272, 4608, 512, "layer4 3x3, batch 128"))

_LOAD = """    if (next < slabs)
      load_slab<ALIGNED>(smem + next % kStages * kStageFloats"""
_SPLIT_B = """        split(bp[b_ph0], bh[j][0], bl[j][0]);
        split(bp[kSB + b_ph1], bh[j][1], bl[j][1]);"""
_SPLIT_A = """        split4(av, ah, al);"""
_UNSPLIT_A = """        for (int e = 0; e < 4; ++e) ah[e] = __float_as_uint(av[e]), al[e] = 0u;"""
VARIANTS = {
    "kernel": [],
    "no_copies": [(_LOAD, _LOAD.replace("if (next < slabs)", "if (next < slabs && s < 0)"))],
    "two_passes": [("""#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(part[i][j], ah, bl[j][0], bl[j][1]);
""", "")],
    "no_splits": [(_SPLIT_B, """        bh[j][0] = __float_as_uint(bp[b_ph0]), bl[j][0] = 0u;
        bh[j][1] = __float_as_uint(bp[kSB + b_ph1]), bl[j][1] = 0u;"""),
                  (_SPLIT_A, _UNSPLIT_A)],
}


def build(tmp):
    """One shared library per variant, compiled at once: {name: CDLL}."""
    from paddle_tpu_torch.ops.cuda import _build

    src = open(os.path.join(_build.CSRC_DIR, "conv_bn_relu_mm.cu")).read()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the edit no longer matches conv_bn_relu_mm.cu")
            text = text.replace(old, new)
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR, "-o",
             os.path.join(tmp, f"{name}.so"), path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out.decode(errors='replace')}")
        lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.ptt_conv_mm_affine_relu.argtypes = [vp] * 5 + [i64, i32, i32, vp]
        lib.ptt_conv_mm_stats.argtypes = [vp] * 4 + [i64, i32, i32, vp]
        libs[name] = lib
    return libs


def check(err):
    if err != 0:
        raise RuntimeError(f"conv GEMM launch failed: CUDA error {err}")


def time_ms(fn, sets, iters):
    import torch

    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this script runs only on the card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        rows = []
        for m, k, n, label in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(21)
            sets = [(torch.randn(m, k, generator=g, device="cuda"),
                     torch.randn(k, n, generator=g, device="cuda") * (2.0 / k) ** 0.5,
                     torch.rand(n, generator=g, device="cuda") + 0.5,
                     torch.randn(n, generator=g, device="cuda") * 0.5) for _ in range(2)]
            y = torch.empty(m, n, device="cuda")
            part = torch.empty(-(-m // 128), n, device="cuda")
            iters = max(5, min(40, int(1.5e11 / (m * k * n))))
            stream = torch.cuda.current_stream().cuda_stream
            row = {"shape": [m, k, n], "label": label,
                   "torch_matmul_ms": time_ms(lambda p, w, a, b: torch.matmul(p, w), sets, iters)}
            for name, lib in libs.items():
                def eval_(p, w, a, b, lib=lib):
                    check(lib.ptt_conv_mm_affine_relu(p.data_ptr(), w.data_ptr(), a.data_ptr(),
                                                      b.data_ptr(), y.data_ptr(), m, k, n,
                                                      stream))

                def train(p, w, a, b, lib=lib):
                    check(lib.ptt_conv_mm_stats(p.data_ptr(), w.data_ptr(), y.data_ptr(),
                                                part.data_ptr(), m, k, n, stream))

                row[name] = {"eval_ms": time_ms(eval_, sets, iters),
                             "train_ms": time_ms(train, sets, iters)}
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
            del sets
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "conv_mm_ablation": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
