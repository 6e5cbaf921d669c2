#!/usr/bin/env python3
"""Where the int8 matmul's time goes, on one NVIDIA card (H100).

    python3 tools/int8_mm_ablation.py

Builds ``paddle_tpu_torch/csrc/int8_matmul.cu`` as it is and in ablated
variants, each a text edit of the source that drops one cost and so
computes a wrong answer (only the built kernel is checked):

- ``no_products``: the tensor-core products are left out (the fragments
  are still read and packed);
- ``no_fragments``: the fragment reads, the byte transposes and the
  products are left out: only the ``cp.async`` ring and the epilogue stay;
- ``no_fragments_no_stores``: that, and the epilogue's stores and atomic
  adds as well: what streaming the operands through the ring costs;
- ``no_zeroing``: split-K's zeroing of the output is left out.

Times each at the int8 program's shapes (M = 8, 512 and 4096) and the 25
products of a bucket-512 forward in device time behind a sleep kernel
(``chip_smoke.device_ms``, operand sets cycled past the L2), the variants
in turns, and prints the card's ``name, power.limit`` and one JSON line,
also written to ``chiprun_out/int8_mm_ablation.json``. An edit that no
longer matches the source fails the run: update it with the kernel.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SHAPES = [(8, 3072, 768), (512, 768, 3072), (512, 3072, 768), (4096, 768, 3072),
          (4096, 3072, 768)]

_MMA = "for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);"
_STEPS = "for (int kk = 0; kk < kBK; kk += 32) {"
_STORE = "*reinterpret_cast<int4*>(dst) = v;"
_RED = "if (c < cols) red_add("
_ZERO = "cudaMemsetAsync(op, 0, (size_t)m * n * sizeof(int32_t), s);"
VARIANTS = {
    "kernel": [],
    "no_products": [(_MMA, "for (int j = 0; j < 4; ++j) acc[i][j][0] += a[i][0] ^ b[j][0];")],
    "no_fragments": [(_STEPS, "for (int kk = 0; kk < 0; kk += 32) {")],
    "no_fragments_no_stores": [(_STEPS, "for (int kk = 0; kk < 0; kk += 32) {"),
                               (_STORE, "if (v.x == 0x7fffffff) " + _STORE),
                               (_RED, "if (c < cols && m < 0) red_add(")],
    "no_zeroing": [(_ZERO, "cudaSuccess;")],
}


def build(tmp):
    """One shared library per variant, compiled at once: {name: CDLL}."""
    from paddle_tpu_torch.ops.cuda import _build

    src = open(os.path.join(_build.CSRC_DIR, "int8_matmul.cu")).read()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the edit no longer matches int8_matmul.cu: {old}")
            text = text.replace(old, new)
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", os.path.join(tmp, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out.decode(errors='replace')}")
        lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        lib.ptt_int8_matmul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def main():
    import torch

    from paddle_tpu_torch.device import card_identity

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script runs only on the card")
    card = card_identity()
    libs = build(tempfile.mkdtemp(prefix="ptt_int8_abl_"))
    g = torch.Generator(device="cuda").manual_seed(43)

    def call(lib, x, w):
        out = torch.empty(x.shape[0], w.shape[1], dtype=torch.int32, device="cuda")
        err = lib.ptt_int8_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0],
                                  x.shape[1], w.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"int8_matmul: CUDA error {err}")
        return out

    def operands(m, k, n, count):
        return [(torch.randint(-128, 128, (m, k), generator=g, device="cuda", dtype=torch.int8),
                 torch.randint(-128, 128, (k, n), generator=g, device="cuda", dtype=torch.int8))
                for _ in range(count)]

    def turns(fns, iters):
        got = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            got[name].append(cs.device_ms(fns[name], iters)[0])
        return {name: sum(v) / len(v) for name, v in got.items()}

    report = {"card": card, "shapes": []}
    for m, k, n in SHAPES:
        sets = operands(m, k, n, max(2, min(64, -(-60 * 2**20 // (m * k + k * n)))))
        x, w = sets[0]
        if not torch.equal(call(libs["kernel"], x, w), (x.double() @ w.double()).to(torch.int32)):
            raise AssertionError(f"int8_matmul [{m}, {k}] @ [{k}, {n}] differs from float64")
        fns = {}
        for name, lib in libs.items():
            it = iter(range(10 ** 9))
            fns[name] = (lambda lib=lib, it=it: call(lib, *sets[next(it) % len(sets)]))
        row = {"shape": [m, k, n], **turns(fns, 50)}
        cs.log(f"int8 ablation {row}")
        report["shapes"].append(row)
    sets = [operands(*s, 1)[0] for s in cs._q_forward_products(cs.Q_BUCKETS[-1])]
    fns = {name: (lambda lib=lib: [call(lib, x, w) for x, w in sets]) for name, lib in libs.items()}
    report["forward_bucket_512"] = turns(fns, 10)
    cs.log(f"int8 ablation, bucket-512 forward's 25 products: {report['forward_bucket_512']}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "int8_mm_ablation.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
