#!/usr/bin/env python3
"""The residual LayerNorm forward against an earlier version of its source,
on one NVIDIA card (H100), in one run.

    python3 tools/layernorm_ab.py EARLIER_CSRC_DIR

``EARLIER_CSRC_DIR`` holds an earlier ``layernorm_residual.cu`` (for
instance ``git show <commit>:paddle_tpu_torch/csrc/layernorm_residual.cu``)
whose C entry takes the arguments this tree's takes
(``ptt_layernorm_residual_fwd(x, res, w, b, y, mean, rstd, rows, h, eps,
dtype, stream)``, dtype 0 float32 and 1 bf16). It is built with ``nvcc``
beside this tree's, and both run through this tree's wrapper
(``paddle_tpu_torch.ops.cuda.layernorm_residual``), the library swapped.

At BERT's [16384, 768], in device time behind a sleep kernel
(``chip_smoke.device_ms_sets``, six input sets cycled past the 50 MB L2),
taken in turns (earlier, this tree, this tree, earlier) and the best of
each version's two readings kept: float32, bf16, and the mixed case (a
bf16 x on an f32 residual: this tree's mixed instance; for the earlier
source the route it had, x cast to f32, the f32 kernel, y cast back to
bf16), beside ``F.layer_norm(x + res)`` and against the bound. Each output
is held to its plain version first (f32 atol 1e-5; bf16 and mixed within 1
bf16 ulp of the largest output). Then the same kernels timed the way
``chip_smoke.time_ms`` times them (CUDA events around a loop of host
calls), which the wrapper's host work paces at these sizes. One line per
case on stdout.
"""
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops.cuda import _build  # noqa: E402
from paddle_tpu_torch.ops.cuda import layernorm_residual as lnr  # noqa: E402

ROWS, H = 16384, 768


def _earlier_library(csrc_dir):
    out = os.path.join(tempfile.mkdtemp(prefix="ln_ab_"), "earlier.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                    os.path.join(csrc_dir, "layernorm_residual.cu")], check=True)
    return ctypes.CDLL(out)


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available: this script runs only on the card", file=sys.stderr)
        return 2
    libs = {"this tree": _build.library("layernorm_residual"),
            "earlier": _earlier_library(argv[1])}
    g = torch.Generator(device="cuda").manual_seed(1)
    w, b = (torch.randn(H, generator=g, device="cuda") for _ in range(2))
    cases = {"float32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
             "mixed": (torch.bfloat16, torch.float32)}
    for case, (xd, rd) in cases.items():
        sets = [(torch.randn(ROWS, H, generator=g, device="cuda").to(xd),
                 torch.randn(ROWS, H, generator=g, device="cuda").to(rd)) for _ in range(6)]

        def run(x, r, earlier):
            if earlier and xd != rd:  # the earlier route: casts around the f32 kernel
                return lnr.layernorm_residual_fwd(x.float(), r, w, b)[0].to(xd)
            return lnr.layernorm_residual_fwd(x, r, w, b)[0]

        x, r = sets[0]
        want = lnr._reference(x, r, w, b, 1e-5)[0]
        tol = 1e-5 if xd == torch.float32 else float(cs.bf16_ulp(want.float().abs().max()))
        readings = {}
        for name in ("earlier", "this tree", "this tree", "earlier"):
            _build._libs["layernorm_residual"] = libs[name]
            earlier = name == "earlier"
            err = float((run(x, r, earlier).float() - want.float()).abs().max())
            if err > tol:
                raise AssertionError(f"{case} {name}: {err} beyond {tol}")
            dev = cs.device_ms_sets(lambda x_, r_: run(x_, r_, earlier), sets, 50)[0]
            host = cs.time_ms(lambda x_, r_: run(x_, r_, earlier), sets, 200)
            old = readings.get(name, (float("inf"), float("inf")))
            readings[name] = (min(old[0], dev), min(old[1], host))
        _build._libs["layernorm_residual"] = libs["this tree"]
        lib = cs.device_ms_sets(lambda x_, r_: F.layer_norm(
            x_ + r_, (H,), w.to(r_.dtype), b.to(r_.dtype), 1e-5).to(xd), sets, 50)[0]
        t_b = cs.bound(ROWS * H * (2 * x.element_size() + r.element_size()) + 8 * ROWS + 8 * H,
                       9 * ROWS * H)[0]
        print(f"LN {case} [{ROWS}, {H}]: device ms earlier {readings['earlier'][0]:.4f}, this "
              f"tree {readings['this tree'][0]:.4f}; F.layer_norm {lib:.4f}; bound {t_b:.4f}; "
              f"host-paced (time_ms) earlier {readings['earlier'][1]:.4f}, this tree "
              f"{readings['this tree'][1]:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
