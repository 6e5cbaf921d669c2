#!/usr/bin/env python3
"""Why ``chip_smoke`` phase 12h's Adadelta run can part from the CPU's.

Phase 12h trains the dygraph LeNet (batch 64, synthetic MNIST, the pool
kernel on) for 20 captured Adadelta steps and holds the losses to the
CPU's same 20 steps within ``LENET_OPT_LOSS_ATOL``. This tool finds the
inputs of LeNet's four ReLUs that the CPU's run brings within 1e-6 of zero
(the kinks: a rounding difference can put such an input on the other side,
which switches that unit's gradient on or off) and follows them:

    python3 tools/lenet_repeat.py cpu [RUNS] [NOISE]   # any machine
    python3 tools/lenet_repeat.py card [RUNS]          # a machine with the card

``cpu``: RUNS runs (default 30) on the CPU whose parameter gradients are
each multiplied by ``1 + NOISE * N(0, 1)`` (default 1e-6, the size of a
summation-order difference), every run from the same weights and batches.
``card``: RUNS fresh processes for each of two arms, in turns: the captured
step with cuDNN's default convolution algorithms (``step.deterministic =
False``) and with its deterministic ones (the step's default); then the
forward and backward of every distinct convolution of LeNet (batch 64) and
ResNet-50 (batch 32) under both settings (CUDA events). Each run prints a
JSON line: its losses, its largest difference from the CPU's, and the value
of every kink input at its step. The last line is the summary: for each arm
the runs over the limit, the distinct loss sequences, and how many runs put
a kink input on the other side of zero from the CPU's, against how many
failed. ``--out PATH`` also writes the summary there.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import chip_smoke as c  # noqa: E402
from paddle_tpu_torch.flags import set_flags  # noqa: E402
from paddle_tpu_torch.framework.jit import train_step  # noqa: E402
from paddle_tpu_torch.models import LeNet  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402
from paddle_tpu_torch.vision.datasets import MNIST  # noqa: E402

RELUS = ("features.1", "features.4", "fc.2", "fc.4")  # LeNet's ReLU layers
NEAR = 1e-6  # a ReLU input this close to zero is a kink
ARMS = ("default", "deterministic")


def _batches():
    train = MNIST(mode="train")
    b = c.LENET_B
    return [(train.images[i * b:(i + 1) * b], train.labels[i * b:(i + 1) * b].astype(np.int64))
            for i in range(c.LENET_OPT_STEPS)]


def _init():
    return LeNet(generator=torch.Generator().manual_seed(c.LENET_SEED)).state_dict()


def _train(device, batches, init, tap=None, deterministic=True, noise=0.0, seed=0):
    """The 20 captured Adadelta steps from ``init``; ``tap`` (a
    :class:`_KinkTap`) is installed first and read after each step.
    Returns (losses, the step)."""
    model = LeNet()
    model.load_state_dict(init)
    if noise:
        gen = torch.Generator().manual_seed(seed)
        for p in model.parameters():
            p.register_hook(lambda g: g * (1 + noise * torch.randn(g.shape, generator=gen)))
    if tap is not None:
        tap.install(model)
    opt = c._lenet_optimizers()["adadelta"](model.parameters())
    step = train_step(model, opt, lambda m, x, y: F.cross_entropy(m(x), y), jit=True,
                      device=device)
    step.deterministic = deterministic
    if device != "cpu":
        batches = [[torch.from_numpy(a).to(device) for a in b] for b in batches]
    losses = []
    for b in batches:
        losses.append(float(step(*b)["loss"]))
        if tap is not None:
            tap.after_step()
    return losses, step


def _find_kinks(batches, init):
    """The CPU's run: its losses and every ReLU input within NEAR of zero
    as (layer, step, index, value)."""
    kinks, calls = [], {}

    def install(model):
        for name in RELUS:
            def hook(mod, inp, out, name=name):
                k = calls[name] = calls.get(name, 0) + 1
                z = inp[0].detach()
                for idx in (z.abs() < NEAR).nonzero().tolist():
                    kinks.append({"layer": name, "step": k, "index": idx,
                                  "value": float(z[tuple(idx)])})
            model.get_submodule(name).register_forward_hook(hook)

    losses, _ = _train("cpu", batches, init, SimpleNamespace(install=install,
                                                             after_step=lambda: None))
    return losses, kinks


class _KinkTap:
    """Copies each kink input into a buffer at every call of its layer
    (inside the captured graph on the card), read after each step;
    :meth:`seen` gives the value each held at its kink's step."""

    def __init__(self, kinks, device):
        self.kinks = kinks
        self.buf = torch.zeros(max(len(kinks), 1), device=device)
        self.rows = []

    def install(self, model):
        for name in RELUS:
            mine = [(j, tuple(k["index"])) for j, k in enumerate(self.kinks)
                    if k["layer"] == name]
            if mine:
                def hook(mod, inp, out, mine=mine):
                    for j, idx in mine:
                        self.buf[j].copy_(inp[0].detach()[idx])
                model.get_submodule(name).register_forward_hook(hook)

    def after_step(self):
        self.rows.append(self.buf.cpu().numpy().copy())

    def seen(self):
        return [float(self.rows[k["step"] - 1][j]) for j, k in enumerate(self.kinks)]


def _run_on_card(arm, ref):
    """One run in this process: the captured steps with the kinks tapped,
    then the step's device ms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_flags({"use_pallas_pool_bwd": True})
    batches = _batches()
    tap = _KinkTap(ref["kinks"], "cuda")
    losses, step = _train("cuda", batches, _init(), tap, deterministic=arm == "deterministic")
    first = [torch.from_numpy(a).cuda() for a in batches[0]]
    ms, _ = c.device_ms(lambda: step(*first), 50)
    return losses, tap.seen(), ms


def _judge(losses, seen, ref):
    diff = np.abs(np.subtract(losses, ref["losses"]))
    off = np.nonzero(diff > c.LENET_OPT_LOSS_ATOL)[0]
    flipped = [j for j, (v, k) in enumerate(zip(seen, ref["kinks"]))
               if (v > 0) != (k["value"] > 0)]
    return {"max_abs_diff": float(diff.max()),
            "first_step_over": int(off[0]) + 1 if len(off) else None,
            "flipped": [f"{ref['kinks'][j]['layer']}@{ref['kinks'][j]['step']}" for j in flipped],
            "first_flip_step": min((ref["kinks"][j]["step"] for j in flipped), default=None)}


def _fisher_two_sided(a, b, c_, d):
    """Fisher's exact test of the 2x2 table [[a, b], [c_, d]]."""
    n, r1, k1 = a + b + c_ + d, a + b, a + c_

    def p(x):
        return math.comb(k1, x) * math.comb(n - k1, r1 - x) / math.comb(n, r1)

    obs = p(a)
    lo, hi = max(0, r1 + k1 - n), min(r1, k1)
    return float(sum(p(x) for x in range(lo, hi + 1) if p(x) <= obs * (1 + 1e-9)))


def _summary(runs, ref):
    """For each arm: the runs over the limit, the distinct loss sequences,
    each kink's flips (and how many of those runs went over the limit), and
    the runs over the limit with no kink flipped before they parted."""
    out = {"limit": c.LENET_OPT_LOSS_ATOL, "cpu_losses": ref["losses"], "kinks": ref["kinks"],
           "arms": {}}
    names = [f"{k['layer']}@{k['step']}" for k in ref["kinks"]]
    for arm in sorted({r["arm"] for r in runs}):
        rs = [r for r in runs if r["arm"] == arm]
        fail = [r for r in rs if r["first_step_over"] is not None]
        by_kink = {}
        for j, name in enumerate(names):
            flip = [r for r in rs if (r["kink_values"][j] > 0) != (ref["kinks"][j]["value"] > 0)]
            by_kink[f"{name}#{j}"] = {"flipped": len(flip), "flipped_and_over_limit":
                                      sum(r["first_step_over"] is not None for r in flip)}
        unexplained = [r for r in fail if r["first_flip_step"] is None
                       or r["first_flip_step"] >= r["first_step_over"]]
        out["arms"][arm] = {
            "runs": len(rs), "over_limit": len(fail),
            "over_limit_diffs": sorted({round(r["max_abs_diff"], 6) for r in fail}),
            "first_steps_over": sorted({r["first_step_over"] for r in fail}),
            "max_abs_diff_within_limit": max((r["max_abs_diff"] for r in rs
                                              if r["first_step_over"] is None), default=None),
            "distinct_loss_sequences": len({tuple(r["losses"]) for r in rs}),
            "by_kink": by_kink, "over_limit_without_an_earlier_flip": len(unexplained),
            "step_ms_median": (float(np.median([r["step_ms"] for r in rs]))
                               if all("step_ms" in r for r in rs) else None)}
    if len(out["arms"]) == 2:
        a, b = (out["arms"][k] for k in sorted(out["arms"]))
        out["fisher_p_over_limit"] = _fisher_two_sided(a["over_limit"], a["runs"] - a["over_limit"],
                                                       b["over_limit"], b["runs"] - b["over_limit"])
    return out


# ResNet-50 v1.5's distinct convolutions (in, out, kernel, stride, input extent, how many)
RESNET50_CONVS = [(3, 64, 7, 2, 224, 1), (64, 64, 1, 1, 56, 1), (64, 64, 3, 1, 56, 3),
                  (64, 256, 1, 1, 56, 4), (256, 64, 1, 1, 56, 2), (256, 128, 1, 1, 56, 1),
                  (128, 128, 3, 2, 56, 1), (128, 512, 1, 1, 28, 4), (256, 512, 1, 2, 56, 1),
                  (512, 128, 1, 1, 28, 3), (128, 128, 3, 1, 28, 3), (512, 256, 1, 1, 28, 1),
                  (256, 256, 3, 2, 28, 1), (256, 1024, 1, 1, 14, 6), (512, 1024, 1, 2, 28, 1),
                  (1024, 256, 1, 1, 14, 5), (256, 256, 3, 1, 14, 5), (1024, 512, 1, 1, 14, 1),
                  (512, 512, 3, 2, 14, 1), (512, 2048, 1, 1, 7, 3), (1024, 2048, 1, 2, 14, 1),
                  (2048, 512, 1, 1, 7, 2), (512, 512, 3, 1, 7, 2)]
LENET_CONVS = [(1, 6, 3, 1, 28, 1), (6, 16, 5, 1, 14, 1)]


def _conv_cost(iters=20):
    """ms of one forward + backward (data and weight gradients) of each
    convolution, float32 without TF32, with cuDNN's default algorithms and
    with its deterministic ones, the two timed in turns."""
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for net, batch, convs in (("lenet", c.LENET_B, LENET_CONVS),
                              ("resnet50", 32, RESNET50_CONVS)):
        for cin, cout, k, s, hw, count in convs:
            x = torch.randn(batch, cin, hw, hw, device="cuda", generator=gen, requires_grad=True)
            w = torch.randn(cout, cin, k, k, device="cuda", generator=gen, requires_grad=True)
            pad = (k - 1) // 2 if net == "resnet50" or k == 3 else 0

            def once():
                y = torch.nn.functional.conv2d(x, w, stride=s, padding=pad)
                gx, gw = torch.autograd.grad(y, (x, w), torch.ones_like(y))
                return gx, gw

            ms = {}
            for rep in range(2):
                for det in (False, True):
                    torch.backends.cudnn.deterministic = det
                    once()
                    torch.cuda.synchronize()
                    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    e0.record()
                    for _ in range(iters):
                        once()
                    e1.record()
                    e1.synchronize()
                    ms.setdefault(det, []).append(e0.elapsed_time(e1) / iters)
            torch.backends.cudnn.deterministic = False
            rows.append({"net": net, "conv": [cin, cout, k, s, hw], "count": count,
                         "default_ms": min(ms[False]), "deterministic_ms": min(ms[True])})
    total = {net: {"default_ms": sum(r["default_ms"] * r["count"] for r in rows if r["net"] == net),
                   "deterministic_ms": sum(r["deterministic_ms"] * r["count"] for r in rows
                                           if r["net"] == net)}
             for net in ("lenet", "resnet50")}
    return {"convs": rows, "totals": total}


def main(argv):
    out_path = None
    if "--out" in argv:
        i = argv.index("--out")
        out_path, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    mode = argv[0] if argv else "cpu"
    if mode == "child":  # one card run, in a process of its own
        ref = json.load(open(argv[2]))
        losses, seen, ms = _run_on_card(argv[1], ref)
        rec = {"arm": argv[1], "losses": losses, "kink_values": seen, "step_ms": ms}
        rec.update(_judge(losses, seen, ref))
        print(json.dumps(rec), flush=True)
        return 0
    runs_n = int(argv[1]) if len(argv) > 1 else 30
    set_flags({"use_pallas_pool_bwd": True})
    batches, init = _batches(), _init()
    losses, kinks = _find_kinks(batches, init)
    ref = {"losses": losses, "kinks": kinks}
    print(json.dumps({"cpu_losses": losses, "kinks": kinks}), flush=True)
    runs = []
    if mode == "cpu":
        noise = float(argv[2]) if len(argv) > 2 else 1e-6
        for seed in range(1, runs_n + 1):
            tap = _KinkTap(kinks, "cpu")
            got, _ = _train("cpu", batches, init, tap, noise=noise, seed=seed)
            rec = {"arm": f"cpu_noise_{noise:g}", "losses": got, "kink_values": tap.seen()}
            rec.update(_judge(got, rec["kink_values"], ref))
            runs.append(rec)
            print(json.dumps(rec), flush=True)
        summary = _summary(runs, ref)
    else:
        from paddle_tpu_torch.device import card_identity
        from paddle_tpu_torch.ops.cuda import _build

        print(card_identity(), flush=True)
        _build.build_all(("pool_backward", "optimizer_update"))
        fd, ref_path = tempfile.mkstemp(suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(ref, f)
        t0 = time.perf_counter()
        for k in range(runs_n):
            for arm in (ARMS if k % 2 == 0 else ARMS[::-1]):
                p = subprocess.run([sys.executable, os.path.abspath(__file__), "child", arm,
                                    ref_path], capture_output=True, text=True, timeout=600)
                if p.returncode != 0:
                    sys.stderr.write(p.stderr[-4000:])
                    raise SystemExit(f"child {arm} run {k} exited {p.returncode}")
                rec = json.loads(p.stdout.strip().splitlines()[-1])
                runs.append(rec)
                print(json.dumps(rec), flush=True)
        os.unlink(ref_path)
        summary = _summary(runs, ref)
        summary["runs_seconds"] = time.perf_counter() - t0
        summary["card"] = card_identity()
        summary["conv_cost"] = _conv_cost()
    print(json.dumps(summary), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"summary": summary, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
