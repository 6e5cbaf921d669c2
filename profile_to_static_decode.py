"""Profile the phase-12o(b) decode of ``chip_smoke.py`` on the card.

The decode is ``chip_smoke.paddle_greedy_decode``: Transformer-base (the
smoke's seq2seq configuration: d_model 512, 6 + 6 layers, vocabulary
37,000, f32, seed weights) decoded greedily by a ``paddle.jit.to_static``
loop over a fixed ``[64, 64]`` token buffer, 64 sources of 64 tokens. Its
loop reads the host, so every call runs uncaptured. The script builds the
LayerNorm kernel, decodes once to warm up, then

- times ``--runs`` whole decodes on the host clock (each ended by a
  synchronize) and by CUDA events, and divides by the steps decoded;
- profiles one more decode with ``torch.profiler`` (CPU and CUDA): the
  device's busy time (the sum of the kernels' and copies' own times), its
  idle share of the decode's wall time, the host's synchronizes, host reads
  and clones, and the host operations that take the most time;

and prints one JSON line. ``--tree DIR`` takes ``chip_smoke`` and
``paddle_tpu_torch`` from another checkout (an unpacked parent commit), so
that two versions are compared in one call, each in its own process:

    python profile_to_static_decode.py [--tree DIR] [--runs N]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout whose chip_smoke.py and paddle_tpu_torch run")
    ap.add_argument("--runs", type=int, default=5, help="decodes timed")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this script runs only on the card", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops.cuda import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all(("layernorm_residual",))
    built_s = time.perf_counter() - t0

    model = smoke._seq2seq(seed=2, dropout=0.0, device="cuda").eval()
    src = paddle.to_tensor(smoke.s2s_batch(smoke.S2S_B, np.random.RandomState(27))[0])
    decode = smoke.paddle_greedy_decode(paddle, model, smoke.S2S_TGT)
    eos = paddle.to_tensor(np.asarray(model.eos_id, np.int64))
    _, n = decode(src, eos)  # warm: the kernels, cuBLAS's plans, the allocator
    steps = int(n) - 1
    torch.cuda.synchronize()

    host_ms, event_ms = [], []
    for _ in range(args.runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        decode(src, eos)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t) * 1e3)
        event_ms.append(start.elapsed_time(end))

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        decode(src, eos)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t) * 1e3
    avg = prof.key_averages()
    device_ms = sum(_device_us(e) for e in avg) / 1e3
    by_name = {e.key: e for e in avg}

    def calls(*names):
        return sum(by_name[k].count for k in names if k in by_name)

    top = sorted(avg, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    r = {
        "tree": tree,
        "card": card_line(),
        "built_s": built_s,
        "steps": steps,
        "host_ms_per_step": [v / steps for v in host_ms],
        "host_ms_per_step_median": statistics.median(host_ms) / steps,
        "event_ms_per_step_median": statistics.median(event_ms) / steps,
        "profiled": {
            "wall_ms_per_step": profiled_ms / steps,
            "device_busy_ms_per_step": device_ms / steps,
            "device_idle_share": max(0.0, 1.0 - device_ms / profiled_ms),
            "synchronizes": calls("cudaDeviceSynchronize", "cudaStreamSynchronize"),
            "host_reads": calls("aten::_local_scalar_dense"),
            "clones": calls("aten::clone"),
            "top_host_ops_self_ms_per_step": {e.key: e.self_cpu_time_total / 1e3 / steps
                                              for e in top},
        },
        "store": {"misses": decode.store.misses, "uncaptured": decode.store.uncaptured,
                  "captured": len(decode.store)},
    }
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
