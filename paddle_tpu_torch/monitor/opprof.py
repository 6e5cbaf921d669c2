"""Per-op device-time attribution (``/profilez``): stamped scopes, trace
folding and the replay profiler (``paddle_tpu/monitor/opprof.py``).

Three legs, as in the JAX package:

1. **Attribution stamping.** While a profiler is recording, the static
   executor's interpreter (``static/executor.py`` ``_BlockRunner``) runs
   each op inside ``torch.profiler.record_function(op.type#<block>/<index>)``
   (:func:`op_scope_name`); with no profiler on, it formats no stamp. A
   captured replay runs no Python per op, so stamps exist only in an
   interpreted run. :func:`attribute_trace` folds a ``torch.profiler``
   chrome trace back onto the stamped ops: a device kernel goes to the
   stamp whose range on the launching thread holds its launch (the
   trace's ``correlation`` ids pair a kernel with its launch call; a
   ``ctypes`` launch of a hand-written kernel folds the same way, since
   it happens inside its op's range on that thread), and the coverage
   ratio is the stamped device time over all device time. A trace without
   device kernels (the CPU) folds its stamped host ranges as the JAX
   package folds its stamped timelines.

2. **Replay profiler.** :func:`profile_program` re-runs a program op by
   op through the registry kernels, each op timed in isolation (warmup,
   then best-of-N: CUDA events on the card, the host clock on the CPU),
   with its FLOPs and bytes counted by ``cost_model.count_work``. Yields
   us, share, achieved FLOP/s, per-op MFU and roofline class, and the
   time-accuracy closure against a per-process calibrated machine model
   (:func:`calibration`).

3. **Surfaces.** :func:`profilez_payload` backs ``/profilez`` (the debug
   server and both serving server kinds), :func:`top_ops` the top-K
   table, the ``opprof/op_time_ms`` histogram family ``/metrics``, and
   :func:`chrome_events` a per-op track in ``export_merged_chrome_trace``.

Replay timings are per-op latencies in isolation (no fusion across ops,
no overlap); trace attribution measures ops inside the real run and is as
complete as its coverage.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import math
import os
import re
import tempfile
import threading
import time

import torch

__all__ = [
    "TIME_ACCURACY_ENVELOPE",
    "op_scope_name",
    "parse_op_scope",
    "load_trace_events",
    "attribute_trace",
    "calibration",
    "predict_op_us",
    "profile_program",
    "record_profile",
    "profiles",
    "latest_profile",
    "reset_profiles",
    "top_ops",
    "opprof_stats",
    "profilez_payload",
    "chrome_events",
]

# Program-level predicted-vs-measured envelope: the calibrated roofline
# prediction should land within this factor of the measured replay total,
# either direction. Wide on purpose: small ops sit near the launch floor.
TIME_ACCURACY_ENVELOPE = 10.0


# ---------------------------------------------------------------------------
# Leg 1a: the stamp grammar (shared with static/executor.py)
# ---------------------------------------------------------------------------

# stamp = <op.type>#<block>/<index>. The op type charset matches the
# registry's names (incl. "grad::mul" colons); '#' and '/' never appear
# in an op type, so the grammar is unambiguous inside longer names.
_STAMP_RE = re.compile(r"(?P<type>[A-Za-z0-9_.:\-]+)#(?P<block>\d+)/(?P<index>\d+)")


def op_scope_name(op_type, block_idx, op_index) -> str:
    """The stable per-op scope identity: ``op.type#<block>/<index>``."""
    return f"{op_type}#{int(block_idx)}/{int(op_index)}"


def parse_op_scope(name):
    """Extract ``(op_type, block_idx, op_index)`` from a scope/event name
    carrying a stamp anywhere inside it, or None."""
    m = _STAMP_RE.search(str(name))
    if m is None:
        return None
    return m.group("type"), int(m.group("block")), int(m.group("index"))


# ---------------------------------------------------------------------------
# Leg 1b: trace parsing + attribution folding
# ---------------------------------------------------------------------------


def load_trace_events(trace_dir):
    """All chrome traceEvents under ``trace_dir`` (recursive,
    ``*.trace.json[.gz]``) as ``(events, files_ok, files_skipped)``.

    A truncated/corrupt file (the profiler died mid-write) is counted in
    ``files_skipped`` and never raises.
    """
    events, ok, skipped = [], 0, 0
    if not trace_dir or not os.path.isdir(trace_dir):
        return events, ok, skipped
    names = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                  recursive=True)
        + glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                    recursive=True))
    for fn in names:
        try:
            if fn.endswith(".gz"):
                with gzip.open(fn, "rt") as f:
                    trace = json.load(f)
            else:
                with open(fn) as f:
                    trace = json.load(f)
            evs = trace.get("traceEvents", []) if isinstance(trace, dict) \
                else []
        except (OSError, ValueError, EOFError):
            skipped += 1
            continue
        ok += 1
        if isinstance(evs, list):
            events.extend(e for e in evs if isinstance(e, dict))
    return events, ok, skipped


def _union_us(intervals) -> float:
    """Total covered span of ``[(ts, dur), ...]`` with overlaps/nesting
    folded (a stamped scope containing a stamped sub-scope must not count
    its device time twice)."""
    total, end = 0.0, None
    for ts, dur in sorted(intervals):
        s, e = ts, ts + dur
        if end is None or s >= end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def attribute_trace(trace_dir) -> dict:
    """Fold a profiler trace directory into a per-op attribution table.

    With device kernels in the trace (``cat`` ``kernel``, ``gpu_memcpy``,
    ``gpu_memset``: a ``torch.profiler`` trace of the card), each kernel
    goes to the innermost stamped range, on the thread that launched it,
    that holds its launch (paired by ``args.correlation``); coverage is
    the stamped kernel time over all kernel time, each union-folded per
    device lane. Without device kernels, only timelines (pid, tid) that
    carry at least one stamped event are scored, time interval-folded so
    nested scopes never double count; events with no stamp on a scored
    timeline count against coverage.

    Returns ``{"status", "coverage", "total_us", "stamped_us",
    "unattributed_us", "files", "files_skipped", "timelines", "ops"}``
    where ``ops`` rows carry ``scope/op_type/block/index/time_us/share/
    events``. An empty or missing dir is ``status="no-data"``.
    """
    events, ok, skipped = load_trace_events(trace_dir)
    if any(ev.get("cat") in _DEVICE_CATS for ev in events):
        return _attribute_device(events, ok, skipped)
    return _attribute_lanes(events, ok, skipped)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _span(ev):
    """``(ts, dur)`` of a complete event, or None."""
    if ev.get("ph") != "X":
        return None
    try:
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
    except (KeyError, TypeError, ValueError):
        return None
    return (ts, dur) if dur > 0.0 else None


def _report(lanes, ok, skipped):
    """The attribution payload of scored lanes (``{"all", "stamped",
    "per_op"}`` interval lists)."""
    total = sum(_union_us(v["all"]) for v in lanes.values())
    stamped = sum(_union_us(v["stamped"]) for v in lanes.values())
    per_op, n_events = {}, {}
    for lane in lanes.values():
        for stamp, ivals in lane["per_op"].items():
            per_op[stamp] = per_op.get(stamp, 0.0) + _union_us(ivals)
            n_events[stamp] = n_events.get(stamp, 0) + len(ivals)
    ops = []
    for stamp, us in sorted(per_op.items(), key=lambda kv: -kv[1]):
        op_type, blk, idx = parse_op_scope(stamp)
        ops.append({
            "scope": stamp, "op_type": op_type, "block": blk, "index": idx,
            "time_us": round(us, 3),
            "share": round(us / total, 4) if total else 0.0,
            "events": n_events[stamp],
        })
    if not lanes:
        return {"status": "no-data", "coverage": None, "total_us": 0.0,
                "stamped_us": 0.0, "unattributed_us": 0.0, "files": ok,
                "files_skipped": skipped, "timelines": 0, "ops": []}
    return {
        "status": "ok",
        "coverage": round(stamped / total, 4) if total else None,
        "total_us": round(total, 3),
        "stamped_us": round(stamped, 3),
        "unattributed_us": round(max(total - stamped, 0.0), 3),
        "files": ok,
        "files_skipped": skipped,
        "timelines": len(lanes),
        "ops": ops,
    }


def _attribute_device(events, ok, skipped):
    """Device kernels folded onto the stamped ranges that hold their
    launches (see :func:`attribute_trace`)."""
    ranges = {}  # (pid, tid) -> [(ts, end, stamp)] of stamped host ranges
    launches = {}  # correlation id -> (pid, tid, ts) of the launch call
    kernels = []
    for ev in events:
        span = _span(ev)
        if span is None:
            continue
        cat = ev.get("cat")
        args = ev.get("args") or {}
        if cat in _DEVICE_CATS:
            kernels.append((ev, span))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (ev.get("pid"), ev.get("tid"), span[0])
        elif cat not in ("gpu_user_annotation",):
            parsed = parse_op_scope(str(ev.get("name", "")))
            if parsed is not None:
                ranges.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                    (span[0], span[0] + span[1], op_scope_name(*parsed)))

    def owner(corr):
        launch = launches.get(corr)
        if launch is None:
            return None
        pid, tid, t = launch
        best = None
        for ts, end, stamp in ranges.get((pid, tid), ()):
            if ts <= t <= end and (best is None or ts >= best[0]):
                best = (ts, stamp)  # the innermost range that holds the launch
        return None if best is None else best[1]

    lanes = {}
    for ev, span in kernels:
        lane = lanes.setdefault((ev.get("pid"), ev.get("tid")), {
            "all": [], "stamped": [], "per_op": {}})
        lane["all"].append(span)
        stamp = owner((ev.get("args") or {}).get("correlation"))
        if stamp is not None:
            lane["stamped"].append(span)
            lane["per_op"].setdefault(stamp, []).append(span)
    return _report(lanes, ok, skipped)


def _attribute_lanes(events, ok, skipped):
    """Stamped timelines folded as the JAX package folds them (see
    :func:`attribute_trace`)."""
    # (pid, tid) -> {"all": [(ts, dur)], "stamped": [...],
    #                "per_op": {stamp: [...]}}
    lanes = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = str(ev.get("name", ""))
        if name.startswith("$"):
            continue  # python-tracer host row
        try:
            ts = float(ev["ts"])
            dur = float(ev.get("dur", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        if dur <= 0.0:
            continue
        lane = lanes.setdefault((ev.get("pid"), ev.get("tid")), {
            "all": [], "stamped": [], "per_op": {}})
        lane["all"].append((ts, dur))
        parsed = parse_op_scope(name)
        if parsed is not None:
            stamp = op_scope_name(*parsed)
            lane["stamped"].append((ts, dur))
            lane["per_op"].setdefault(stamp, []).append((ts, dur))
    scored = {k: v for k, v in lanes.items() if v["stamped"]}
    return _report(scored, ok, skipped)


# ---------------------------------------------------------------------------
# Leg 2a: the calibrated machine model (time prediction)
# ---------------------------------------------------------------------------

_CALIB: dict = {}
_calib_lock = threading.Lock()


def _device_of(device):
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _best_of_us(fn, device, warmup=1, repeats=5) -> float:
    """The best of ``repeats`` timed calls of ``fn()`` after ``warmup``
    untimed ones: CUDA events around each call on the card, the host
    clock on the CPU."""
    for _ in range(max(warmup, 0)):
        fn()
    best = math.inf
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        for _ in range(max(repeats, 1)):
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) * 1e3)
        return best
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def calibration(refresh=False, device=None) -> dict:
    """The per-process calibrated machine model behind :func:`predict_op_us`:
    the per-call floor (a tiny elementwise op), the effective FLOP/s of a
    256³ matmul and of a small convolution, and the effective bandwidth of
    a 16 MiB elementwise op, each timed as :func:`profile_program` times an
    op. Predicted time is ``floor + max(flops/eff_flops, bytes/eff_bw)``.
    Cached per process."""
    with _calib_lock:
        if _CALIB and not refresh:
            return dict(_CALIB)
    dev = _device_of(device)
    tiny = torch.ones(8, device=dev)
    floor_us = _best_of_us(lambda: tiny + 1.0, dev, warmup=2, repeats=3)
    many = [tiny] * 8

    def _sum8():
        y = many[0]
        for x in many[1:]:
            y = y + x
        return y

    sum8_us = _best_of_us(_sum8, dev, warmup=2, repeats=3)
    per_arg_us = max((sum8_us - floor_us) / 7.0, 0.0)
    n = 256
    a = torch.ones(n, n, device=dev)
    mm_us = _best_of_us(lambda: a @ a, dev)
    eff_flops = 2.0 * n * n * n / max((mm_us - floor_us) * 1e-6, 1e-9)
    img = torch.ones(4, 8, 16, 16, device=dev)
    ker = torch.ones(8, 8, 3, 3, device=dev)
    conv_us = _best_of_us(lambda: torch.nn.functional.conv2d(img, ker), dev)
    conv_flops = 2.0 * 4 * 8 * 14 * 14 * 8 * 3 * 3
    eff_conv = conv_flops / max((conv_us - floor_us) * 1e-6, 1e-9)
    big = torch.ones(4 << 20, device=dev)  # 16 MiB
    bw_us = _best_of_us(lambda: big * 1.5 + 2.0, dev)
    eff_bw = 2.0 * big.numel() * 4 / max((bw_us - floor_us) * 1e-6, 1e-9)
    calib = {
        "dispatch_floor_us": round(floor_us, 3),
        "per_arg_us": round(per_arg_us, 3),
        "eff_flops_per_s": float(eff_flops),
        "eff_conv_flops_per_s": float(eff_conv),
        "eff_bytes_per_s": float(eff_bw),
    }
    with _calib_lock:
        _CALIB.clear()
        _CALIB.update(calib)
    return dict(calib)


def predict_op_us(flops, bytes_accessed, op_type=None, n_args=1) -> float:
    """Calibrated-roofline predicted kernel time in µs (conv-family ops
    use the conv FLOP/s ceiling; extra arguments pay the per-arg
    dispatch charge)."""
    c = calibration()
    ceiling = c["eff_conv_flops_per_s"] if "conv" in str(op_type or "") \
        else c["eff_flops_per_s"]
    roof_s = max(
        (float(flops) / ceiling) if flops else 0.0,
        (float(bytes_accessed) / c["eff_bytes_per_s"]) if bytes_accessed
        else 0.0)
    return (c["dispatch_floor_us"]
            + c.get("per_arg_us", 0.0) * max(int(n_args) - 1, 0)
            + roof_s * 1e6)


def _symmetric_ratio(predicted, measured):
    """time_accuracy: predicted/measured (1.0 = perfect), None if either
    side is missing — the plan_accuracy convention."""
    if not predicted or not measured:
        return None
    return float(predicted) / float(measured)


# ---------------------------------------------------------------------------
# Leg 2b: the replay profiler
# ---------------------------------------------------------------------------


def _flag_int(name, fallback):
    from ..flags import flag

    try:
        return int(str(flag(name)).strip() or fallback)
    except (KeyError, ValueError):
        return fallback


def _write_trace(session, trace_dir):
    out = os.path.join(trace_dir, "plugins", "profile", "opprof")
    os.makedirs(out, exist_ok=True)
    session.export_chrome_trace(os.path.join(out, "replay.trace.json.gz"))


def profile_program(program, feed=None, fetch_list=None, *, scope=None,
                    name=None, warmup=None, repeats=None, with_trace=True,
                    record=True, device=None) -> dict:
    """Replay ``program``'s top block op by op through the registry
    kernels and measure each op in isolation on ``device`` (default: the
    card, else the CPU).

    Each op runs once untimed, its FLOPs and bytes counted
    (``cost_model.count_work``: a hand-written kernel by its wrapper's
    formula), then warmup + best-of-N timed. Inputs come from ``feed``
    plus the scope's values: run the program through the Executor once
    first so parameters and constants exist. With ``with_trace`` the
    timed pass runs under ``torch.profiler``, each op inside its stamp's
    ``record_function``, and the payload's ``attribution`` folds that
    trace (:func:`attribute_trace`).

    Control-flow (``cond``/``scan``/``while``) and ``grad::`` ops are not
    replayable in isolation; they are reported with ``replayed: False``,
    and so are ops whose inputs they would have made.

    Returns the profile dict (also stored for ``/profilez`` under
    ``name``). With ``record`` the time-accuracy closure lands on the
    latest ``executor`` CostRecord."""
    from ..analysis.verifier import op_in_names, op_out_names
    from ..framework import random as _random
    from ..ops.registry import has_op, kernel
    from ..static import executor as _exec
    from . import cost_model as _cost
    from . import registry as _registry

    dev = _device_of(device)
    scope = scope or _exec.global_scope()
    warmup = _flag_int("opprof_warmup", 1) if warmup is None else int(warmup)
    repeats = _flag_int("opprof_repeats", 3) if repeats is None \
        else int(repeats)
    block = program.global_block()
    name = name or f"program{getattr(program, '_identity_token', id(program))}"

    env = {n: scope.on(n, dev) for n in scope.var_names()}
    for k, v in (feed or {}).items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        if block.has_var(k):
            from ..framework.dtype import torch_dtype

            t = t.to(dtype=torch_dtype(block.var(k).dtype))
        env[k] = t.to(dev)

    peaks = _cost.device_peaks(device=dev)
    rows, runnable = [], []
    with torch.no_grad():
        for i, op in enumerate(block.ops):
            stamp = op_scope_name(op.type, block.idx, i)
            row = {"scope": stamp, "op_type": op.type, "block": block.idx,
                   "index": i, "replayed": False, "time_us": None}
            rows.append(row)
            if op.type in _exec._BLOCK_OPS or op.type.startswith("grad::"):
                row["reason"] = "control-flow/grad op (not replayable)"
                continue
            if not has_op(op.type):
                row["reason"] = "no registry kernel"
                continue
            in_names = op_in_names(op)
            missing = [n for n in in_names if n not in env]
            if missing:
                row["reason"] = f"missing inputs {missing[:3]}"
                continue
            attrs = {k: v for k, v in op.attrs.items() if not k.startswith("__")}
            if op.attrs.get("__rng__"):
                attrs["generator"] = _random.default_generator(dev)
            arrays = [env[n] for n in in_names]

            def _call(_fn=kernel(op.type), _arrays=arrays, _attrs=attrs):
                return _fn(*_arrays, **_attrs)

            try:
                with _cost.count_work() as work:
                    out = _call()
            except Exception as e:  # keep profiling the rest of the program
                row["reason"] = f"run failed: {type(e).__name__}: {e}"
                continue
            results = list(out) if isinstance(out, (tuple, list)) else [out]
            for out_name, value in zip(op_out_names(op), results):
                if out_name and value is not None:
                    env[out_name] = value
            row["flops"], row["bytes"] = int(work.flops), int(work.bytes_accessed)
            row["n_args"] = len(arrays)
            runnable.append((row, stamp, _call))

        # the timed pass, optionally under torch.profiler so one profiling
        # run also yields the attribution table from real trace events
        trace_dir = tempfile.mkdtemp(prefix="opprof_trace_") if with_trace else None
        session = None
        if with_trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            session = torch.profiler.profile(activities=acts)
        with session if session is not None else contextlib.nullcontext():
            for row, stamp, call in runnable:
                def _stamped(_call=call, _stamp=stamp):
                    with torch.profiler.record_function(_stamp):
                        return _call()

                row["time_us"] = round(_best_of_us(_stamped, dev, warmup=warmup,
                                                   repeats=repeats), 3)
                row["replayed"] = True
        if session is not None:
            _write_trace(session, trace_dir)

    total_us = sum(r["time_us"] for r in rows if r["replayed"])
    pred_total = 0.0
    hist = _registry.histogram(
        "opprof/op_time_ms",
        buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                 50.0, 100.0, 500.0),
        help="replay-measured per-op device time (opprof)")
    calibration(device=dev)
    for row in rows:
        if not row["replayed"]:
            continue
        us = row["time_us"]
        row["share"] = round(us / total_us, 4) if total_us else 0.0
        secs = max(us * 1e-6, 1e-12)
        row["flops_per_s"] = row["flops"] / secs
        row["mfu"] = round(_cost.mfu(row["flops_per_s"], peaks), 6)
        row["roofline"] = _cost.roofline_class(row["flops"], row["bytes"],
                                               peaks)
        row["predicted_us"] = round(
            predict_op_us(row["flops"], row["bytes"], row["op_type"],
                          n_args=row.get("n_args", 1)), 3)
        pred_total += row["predicted_us"]
        row["time_accuracy"] = ta = _symmetric_ratio(row["predicted_us"], us)
        if ta is not None:
            row["time_accuracy"] = round(ta, 4)
        hist.labels(op_type=row["op_type"]).observe(us / 1e3)

    attribution = attribute_trace(trace_dir) if trace_dir else {
        "status": "no-data", "coverage": None, "ops": []}
    accuracy = _symmetric_ratio(pred_total, total_us)
    profile = {
        "name": name,
        "n_ops": len(rows),
        "replayed_ops": sum(1 for r in rows if r["replayed"]),
        "total_us": round(total_us, 3),
        "predicted_total_us": round(pred_total, 3),
        "time_accuracy": round(accuracy, 4) if accuracy else None,
        "coverage": attribution.get("coverage"),
        "warmup": warmup,
        "repeats": repeats,
        "ops": rows,
        "attribution": attribution,
        "calibration": calibration(),
        "created_t": time.time(),
    }
    record_profile(profile)
    if record:
        # the /costz closure: predicted vs measured per-op time on the
        # program's CostRecord
        rec = _cost.latest_record("executor")
        if rec is not None and accuracy is not None:
            rec.predicted_op_us = round(pred_total, 3)
            rec.measured_op_us = round(total_us, 3)
            rec.time_accuracy = round(accuracy, 4)
    return profile


# ---------------------------------------------------------------------------
# the profile store (+ /statz /profilez /metrics chrome surfaces)
# ---------------------------------------------------------------------------

_PROFILES: dict = {}  # name -> profile, insertion-ordered
_profiles_lock = threading.Lock()
_STORE_CAP = 16


def record_profile(profile):
    with _profiles_lock:
        _PROFILES.pop(profile["name"], None)
        _PROFILES[profile["name"]] = profile
        while len(_PROFILES) > _STORE_CAP:
            _PROFILES.pop(next(iter(_PROFILES)))


def profiles() -> list:
    with _profiles_lock:
        return list(_PROFILES)


def latest_profile(name=None):
    with _profiles_lock:
        if name is not None:
            return _PROFILES.get(name)
        return next(reversed(_PROFILES.values()), None) if _PROFILES \
            else None


def reset_profiles():
    with _profiles_lock:
        _PROFILES.clear()


def top_ops(k=None) -> list:
    """Top-K replayed ops by measured device time from the most recent
    profile — the /statz table."""
    k = _flag_int("opprof_topk", 10) if k is None else int(k)
    prof = latest_profile()
    if prof is None:
        return []
    rows = sorted((r for r in prof["ops"] if r.get("replayed")),
                  key=lambda r: -(r["time_us"] or 0.0))
    return [{"scope": r["scope"], "op_type": r["op_type"],
             "time_us": r["time_us"], "share": r.get("share", 0.0),
             "mfu": r.get("mfu"), "roofline": r.get("roofline")}
            for r in rows[:max(k, 0)]]


def opprof_stats() -> dict:
    """The /statz opprof block: stored programs + top-K op table."""
    prof = latest_profile()
    return {
        "programs": profiles(),
        "latest": None if prof is None else {
            "name": prof["name"], "total_us": prof["total_us"],
            "time_accuracy": prof["time_accuracy"],
            "coverage": prof["coverage"],
        },
        "top_ops": top_ops(),
    }


def profilez_payload(query=None):
    """``(status, payload)`` for GET /profilez.

    ``?program=<name>`` selects a stored profile (404 when unknown),
    ``?topk=N`` trims the op table. With nothing profiled yet the
    payload is a clean ``status="no-data"`` hint, not an error.
    """
    query = query or {}
    with _profiles_lock:
        names = list(_PROFILES)
    if not names:
        return 200, {
            "status": "no-data", "programs": [],
            "hint": "run paddle_tpu_torch.monitor.opprof.profile_program(...) "
                    "to populate"}
    want = query.get("program")
    if want is not None and latest_profile(want) is None:
        return 404, {"status": "unknown-program", "program": want,
                     "programs": names}
    prof = latest_profile(want)
    try:
        topk = int(query.get("topk", _flag_int("opprof_topk", 10)))
    except (TypeError, ValueError):
        topk = _flag_int("opprof_topk", 10)
    ops = sorted((r for r in prof["ops"] if r.get("replayed")),
                 key=lambda r: -(r["time_us"] or 0.0))[:max(topk, 0)]
    skipped = [{"scope": r["scope"], "reason": r.get("reason", "")}
               for r in prof["ops"] if not r.get("replayed")]
    attribution = dict(prof["attribution"])
    attribution["ops"] = attribution.get("ops", [])[:max(topk, 0)]
    return 200, {
        "status": "ok",
        "programs": names,
        "program": prof["name"],
        "summary": {
            "n_ops": prof["n_ops"],
            "replayed_ops": prof["replayed_ops"],
            "total_us": prof["total_us"],
            "predicted_total_us": prof["predicted_total_us"],
            "time_accuracy": prof["time_accuracy"],
            "time_accuracy_envelope": TIME_ACCURACY_ENVELOPE,
            "coverage": prof["coverage"],
            "warmup": prof["warmup"],
            "repeats": prof["repeats"],
        },
        "ops": ops,
        "skipped": skipped,
        "attribution": attribution,
        "calibration": prof["calibration"],
    }


def chrome_events() -> list:
    """Per-op replay tracks for ``export_merged_chrome_trace``: one
    synthetic thread per stored profile, ops laid end-to-end at their
    measured durations (relative layout — replay times ops in isolation,
    so only durations, shares and order are meaningful)."""
    with _profiles_lock:
        profs = list(_PROFILES.values())
    if not profs:
        return []
    pid = os.getpid()
    events = []
    for ti, prof in enumerate(profs):
        tid = f"opprof:{prof['name']}"
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid,
                       "args": {"name": f"opprof replay [{prof['name']}]"}})
        t = 0.0
        for row in prof["ops"]:
            if not row.get("replayed"):
                continue
            events.append({
                "name": row["scope"], "ph": "X", "pid": pid, "tid": tid,
                "ts": t, "dur": row["time_us"], "cat": "opprof",
                "args": {"mfu": row.get("mfu"),
                         "roofline": row.get("roofline"),
                         "predicted_us": row.get("predicted_us")},
            })
            t += row["time_us"]
    return events
