#!/usr/bin/env python3
"""The int8 matmul and the max-pool backward against an earlier version of
their sources, on one NVIDIA card (H100), in one run.

    python3 tools/int8_pool_ab.py PARENT_CSRC_DIR

``PARENT_CSRC_DIR`` holds the earlier ``int8_matmul.cu`` and
``pool_backward.cu`` (for instance ``git show <commit>:paddle_tpu_torch/
csrc/int8_matmul.cu``), whose C entries take the arguments they took before
the channels-last pool (``ptt_int8_matmul(x, w, out, m, k, n, stream)``;
``ptt_max_pool2d_backward(x, y, dy, dx, planes, h, w, oh, ow, kh, kw, sh,
sw, ph, pw, stream)``, NCHW only). They are built with ``nvcc`` beside
this tree's, which run through their wrappers (``paddle_tpu_torch.ops.cuda``).

Every time is device time behind a sleep kernel (``chip_smoke.device_ms``),
taken in turns (earlier, this tree, this tree, earlier) and averaged per
version; every output of either version is held bit-equal to the float64
product or to the plain version. Measured:

- the int8 product at the int8 program's shapes (M = 8, 64, 512 and 4096
  rows; 768 -> 3072, 3072 -> 768 and the 768 -> 2 classifier), operands
  cycled past the 50 MB L2, beside ``torch._int_mm`` where it takes the
  shape;
- the 25 products of one served forward at buckets 8, 64 and 512 in a row,
  beside ``torch._int_mm`` over the products it takes;
- the pool backward at ResNet-50's stem ([128, 64, 112, 112], 3x3/2/1, a
  relu'd input) in NCHW, and in the stem's channels-last layout: this tree's
  kernel on the channels-last tensors; the earlier route, which copied x, y
  and dy to NCHW and the gradient back to NHWC for the conv (and the earlier
  kernel alone on NCHW copies); torch's backward at that layout.

Prints the card's ``name, power.limit`` and one JSON line, which it also
writes to ``chiprun_out/int8_pool_ab.json``.
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

INT8_SHAPES = [(m, k, n) for m in (8, 64, 512, 4096)
               for k, n in ((cs.Q_HIDDEN, cs.Q_FFN), (cs.Q_FFN, cs.Q_HIDDEN))] + [
    (m, cs.Q_HIDDEN, cs.Q_CLASSES) for m in cs.Q_BUCKETS]
RAGGED = [(37, 70, 130), (300, 129, 257), (100, 1000, 70), (8, 3072, 2)]


def build_parent(src_dir, tmp):
    """The earlier sources as shared libraries, compiled at once."""
    from paddle_tpu_torch.ops.cuda import _build

    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", os.path.join(tmp, f"{name}.so"),
         os.path.join(src_dir, f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for name in ("int8_matmul", "pool_backward")}
    _build.build_all(("int8_matmul", "pool_backward"))
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the earlier {name}.cu:\n{out.decode()}")
        libs[name] = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    libs["int8_matmul"].ptt_int8_matmul.argtypes = [vp] * 3 + [i32] * 3 + [vp]
    libs["pool_backward"].ptt_max_pool2d_backward.argtypes = (
        [vp] * 4 + [ctypes.c_int64] + [i32] * 10 + [vp])
    return libs


def turns(fns, iters):
    """{name: mean device ms} of ``fns`` ({name: fn()}), timed in turns:
    each name once forwards, once backwards."""
    order = list(fns) + list(fns)[::-1]
    got = {name: [] for name in fns}
    for name in order:
        got[name].append(cs.device_ms(fns[name], iters)[0])
    return {name: sum(v) / len(v) for name, v in got.items()}


def main(parent_dir):
    import torch

    from paddle_tpu_torch.device import card_identity
    from paddle_tpu_torch.ops.cuda import int8_matmul as im
    from paddle_tpu_torch.ops.cuda import pool_backward as pb

    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script runs only on the card")
    card = card_identity()
    tmp = tempfile.mkdtemp(prefix="ptt_ab_")
    libs = build_parent(parent_dir, tmp)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def old_mm(x, w):
        out = torch.empty(x.shape[0], w.shape[1], dtype=torch.int32, device="cuda")
        err = libs["int8_matmul"].ptt_int8_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                                  *x.shape, w.shape[1], stream())
        if err:
            raise RuntimeError(f"earlier int8_matmul: CUDA error {err}")
        return out

    g = torch.Generator(device="cuda").manual_seed(41)

    def operands(m, k, n, count):
        return [(torch.randint(-128, 128, (m, k), generator=g, device="cuda", dtype=torch.int8),
                 torch.randint(-128, 128, (k, n), generator=g, device="cuda", dtype=torch.int8))
                for _ in range(count)]

    report = {"card": card, "int8": [], "int8_forward": [], "pool": []}
    for m, k, n in RAGGED + INT8_SHAPES:
        timed = (m, k, n) in INT8_SHAPES
        sets = operands(m, k, n, max(2, min(64, -(-60 * 2**20 // (m * k + k * n)))) if timed
                        else 1)
        x, w = sets[0]
        ref = im._plain_int8_matmul(x, w)
        if not (torch.equal(im.int8_matmul(x, w), ref) and torch.equal(old_mm(x, w), ref)):
            raise AssertionError(f"int8 [{m}, {k}] @ [{k}, {n}]: a version differs from float64")
        if not timed:
            continue
        it = {"new": iter(range(10 ** 9)), "old": iter(range(10 ** 9))}
        fns = {"earlier": lambda: old_mm(*sets[next(it["old"]) % len(sets)]),
               "this": lambda: im.int8_matmul(*sets[next(it["new"]) % len(sets)])}
        row = {"shape": [m, k, n], "slices": im._split_k(m, k, n)[0], **turns(fns, 50)}
        if cs._int_mm_refusal(x, w, ref) is None:
            lib_it = iter(range(10 ** 9))
            row["torch._int_mm"] = cs.device_ms(
                lambda: torch._int_mm(*sets[next(lib_it) % len(sets)]), 50)[0]
        row["bound_ms"] = cs.bound(m * k + k * n + 4 * m * n, 2 * m * k * n, cs.INT8_OPS_PER_S)[0]
        cs.log(f"int8 {row}")
        report["int8"].append(row)

    for bucket in cs.Q_BUCKETS:
        shapes = cs._q_forward_products(bucket)
        sets = [operands(*s, 1)[0] for s in shapes]
        taken = [(x, w) for x, w in sets if cs._int_mm_refusal(x, w, im._plain_int8_matmul(x, w))
                 is None]
        fns = {"earlier": lambda: [old_mm(x, w) for x, w in sets],
               "this": lambda: [im.int8_matmul(x, w) for x, w in sets]}
        row = {"bucket": bucket, "products": len(shapes), **turns(fns, 10),
               "torch._int_mm": cs.device_ms(lambda: [torch._int_mm(x, w) for x, w in taken],
                                             10)[0], "torch._int_mm_products": len(taken)}
        cs.log(f"int8 forward {row}")
        report["int8_forward"].append(row)
    del sets, taken
    torch.cuda.empty_cache()

    ks, st, pad = cs.POOL_GEOM

    def old_pool(x, y, dy):
        dx = torch.empty_like(x)
        n, c, h, w = x.shape
        err = libs["pool_backward"].ptt_max_pool2d_backward(
            x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr(), n * c, h, w, *y.shape[2:],
            *ks, *st, *pad, stream())
        if err:
            raise RuntimeError(f"earlier max_pool2d_backward: CUDA error {err}")
        return dx

    for kind in ("relu", "stem layout"):
        x = cs._pool_input(kind, g)
        xr = x.detach().requires_grad_()
        y = torch.nn.functional.max_pool2d(xr, ks, st, pad)
        dy = torch.randn(y.shape, generator=g, device="cuda")
        if kind == "stem layout":
            dy = dy.contiguous(memory_format=torch.channels_last)
        yd = y.detach()
        ref = pb._plain_max_pool2d_backward(x, yd, dy, ks, st, pad)
        new = pb.max_pool2d_backward(x, yd, dy, ks, st, pad)
        xc, yc, dyc = x.contiguous(), yd.contiguous(), dy.contiguous()
        if not (torch.equal(new, ref) and torch.equal(old_pool(xc, yc, dyc), ref)):
            raise AssertionError(f"pool backward ({kind}): a version differs from the plain one")
        fns = {"earlier kernel": lambda: old_pool(xc, yc, dyc),
               "this": lambda: pb.max_pool2d_backward(x, yd, dy, ks, st, pad)}
        if kind == "stem layout":
            fns["earlier route"] = lambda: old_pool(x.contiguous(), yd.contiguous(),
                                                    dy.contiguous()).permute(0, 2, 3,
                                                                             1).contiguous()
        row = {"input": kind, "layout": pb.memory_layout(x), **turns(fns, 20),
               "torch backward": cs.device_ms(
                   lambda: torch.autograd.grad(y, xr, dy, retain_graph=True), 20)[0],
               "bound_ms": cs.bound(4 * (2 * x.numel() + 2 * yd.numel()), 9 * x.numel())[0]}
        cs.log(f"pool {row}")
        report["pool"].append(row)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "int8_pool_ab.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    print(json.dumps(report))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
