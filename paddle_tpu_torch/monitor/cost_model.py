"""Hardware-utilization accounting: counted work and device peak tables (``paddle_tpu/monitor/cost_model.py``).

Tokens a second cannot say how fast the card could be: a step's time is
normalized by what the step *should* cost. This module owns both halves of
that ratio, as the JAX package's does:

- **What a step costs.** The JAX package reads XLA's ``cost_analysis()``
  of each compiled program. The port has no compiler to ask, so it counts
  the work of one eager run of the step (:func:`count_work`), once per
  signature: on the card the first run before a graph is captured, on the
  CPU a signature's first call. The count has two parts:

  - each hand-written kernel's wrapper (``ops/cuda``) reports the FLOPs
    and bytes of the function it computes, by ``PERF.md``'s bound
    formulas (a 3xTF32 product counts its product once, a stored dropout
    mask is left out), and the aten ops it runs meanwhile are not
    counted again; a wrapper counts the same on a CPU tensor (its plain
    version) as on the card;
  - every other aten op counts its FLOPs by ``torch.utils.flop_counter``'s
    formulas (products, convolutions, attention; elementwise ops count
    none) and its bytes as each input tensor read once and each output
    written once (a broadcast operand by the elements it holds; views
    move nothing).

  Operands are counted once per op, so reuse through the L2 cache is not
  credited: the bytes are the traffic of an unfused schedule.
  :func:`capture` keeps the count as a :class:`CostRecord` under the
  step's cache key; each replay adds it to the executed-work ledger
  (:func:`note_run`).
- **What the hardware offers.** A peak table per device kind (FLOP/s,
  HBM bytes/s, interconnect bytes/s, memory bytes) with rows for the
  H100, overridable through ``FLAGS_device_peaks``.

Dividing the two gives MFU, HBM bandwidth utilization and a roofline class
for a window of steps: the TrainingMonitor line, the Prometheus dump and
``/costz``.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..flags import flag
from . import registry as _reg

__all__ = [
    "CostRecord", "WorkCount", "count_work",
    "capture", "note_run",
    "cost_records", "latest_record", "reset_cost_records",
    "device_peaks", "peaks_override", "mfu", "hbm_bw_util", "roofline_class",
    "costz_payload",
]

# ---------------------------------------------------------------------------
# counting the work of one run
# ---------------------------------------------------------------------------

# ops that move no bytes of their own: allocation, aliasing, bookkeeping
_FREE_OPS = frozenset((
    "empty", "empty_like", "empty_strided", "detach", "lift_fresh", "alias",
    "resize_", "set_", "record_stream", "_local_scalar_dense", "_unsafe_view",
))
# in-place ops that write their first operand without reading it
_WRITE_ONLY = frozenset((
    "copy_", "fill_", "zero_", "normal_", "uniform_", "bernoulli_", "random_",
    "exponential_",
))


def _tensor_bytes(t) -> int:
    """The bytes a tensor holds: its elements, a broadcast (stride-0)
    dimension counted once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def _flop_formulas():
    from torch.utils.flop_counter import flop_registry

    return flop_registry


class WorkCount(TorchDispatchMode):
    """A dispatch mode that counts the FLOPs and bytes of what runs under
    it (:func:`count_work`): the aten ops, and the hand-written kernels
    through their wrappers (``ops/cuda/_tally.py`` :func:`counted`), which
    find the mode by ``counts_work``. ``kernels`` and ``ops`` break the
    totals down by name: ``{name: [calls, flops, bytes]}``."""

    counts_work = True

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.kernels: dict = {}
        self.ops: dict = {}
        self._local = threading.local()  # inside a wrapper: its aten ops are its own
        self._lock = threading.Lock()  # the backward runs on the autograd engine's thread
        self._formulas = _flop_formulas()

    def _add(self, table, name, flops, nbytes):
        with self._lock:
            self.flops += flops
            self.bytes_accessed += nbytes
            row = table.setdefault(name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes

    def kernel(self, name, flops, nbytes, fn, args, kwargs):
        """Count one kernel wrapper's call and run it; a wrapper called
        inside another counts nothing of its own."""
        if getattr(self._local, "depth", 0):
            return fn(*args, **kwargs)
        self._add(self.kernels, name, float(flops), float(nbytes))
        self._local.depth = 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._local.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if getattr(self._local, "depth", 0) or func.is_view or name in _FREE_OPS:
            return out
        formula = self._formulas.get(func._overloadpacket)
        flops = float(formula(*args, **kwargs, out_val=out)) if formula else 0.0
        reads = tree_leaves((args[1:], kwargs) if name in _WRITE_ONLY else (args, kwargs))
        nbytes = 0
        for side in (reads, tree_leaves(out)):
            seen = set()  # a tensor passed twice moves once; one written in place is also written
            for t in side:
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    nbytes += _tensor_bytes(t)
        self._add(self.ops, f"aten.{name}", flops, nbytes)
        return out


@contextlib.contextmanager
def count_work():
    """Count the work of the block (a step's eager run): yields the
    :class:`WorkCount`, whose totals are final when the block ends."""
    from ..ops.cuda import _tally

    mode = WorkCount()
    _tally.work_counters_active(1)
    try:
        with mode:
            yield mode
    finally:
        _tally.work_counters_active(-1)


# ---------------------------------------------------------------------------
# CostRecord registry
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_records: dict = {}          # key -> CostRecord (insertion-ordered, LRU-ish)
_RECORDS_LIMIT = 256         # long-lived processes fed many programs


class CostRecord:
    """One step's static cost sheet (one training step = one record).

    ``cost``: ``{"flops", "bytes accessed"}`` (a :class:`WorkCount`'s
    totals); ``mem``: ``argument_size_in_bytes`` (the step's inputs) and
    ``output_size_in_bytes`` (the XLA buffer-assignment keys; the port
    measures no ``temp_size_in_bytes``).
    ``runs`` counts executions (:func:`note_run`), so ``flops * runs`` is
    the executed-work ledger the MFU window reads."""

    __slots__ = ("key", "label", "flops", "bytes_accessed",
                 "argument_bytes", "output_bytes", "temp_bytes",
                 "alias_bytes", "peak_hbm_bytes", "partial", "meta",
                 "runs", "created_t", "predicted_peak_bytes",
                 "plan_accuracy", "predicted_op_us", "measured_op_us",
                 "time_accuracy")

    def __init__(self, key, label, cost, mem, meta):
        self.key = key
        self.label = label
        self.flops = float((cost or {}).get("flops", 0.0) or 0.0)
        self.bytes_accessed = float(
            (cost or {}).get("bytes accessed", 0.0) or 0.0)
        mem = mem or {}
        self.argument_bytes = int(mem.get("argument_size_in_bytes", 0))
        self.output_bytes = int(mem.get("output_size_in_bytes", 0))
        self.temp_bytes = int(mem.get("temp_size_in_bytes", 0))
        self.alias_bytes = int(mem.get("alias_size_in_bytes", 0))
        self.peak_hbm_bytes = (self.argument_bytes + self.output_bytes
                               + self.temp_bytes)
        self.partial = cost is None or mem is None
        self.meta = dict(meta)
        self.runs = 0
        self.created_t = time.time()
        # closed by monitor.opprof.profile_program: the calibrated roofline's
        # per-op us against the replay-measured total
        self.predicted_peak_bytes = None
        self.plan_accuracy = None
        self.predicted_op_us = None
        self.measured_op_us = None
        self.time_accuracy = None

    def to_dict(self) -> dict:
        return {
            "key": str(self.key), "label": self.label,
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "predicted_peak_bytes": self.predicted_peak_bytes,
            "plan_accuracy": (round(self.plan_accuracy, 4)
                              if self.plan_accuracy is not None else None),
            "predicted_op_us": self.predicted_op_us,
            "measured_op_us": self.measured_op_us,
            "time_accuracy": (round(self.time_accuracy, 4)
                              if self.time_accuracy is not None else None),
            "arithmetic_intensity": (
                self.flops / self.bytes_accessed
                if self.bytes_accessed else 0.0),
            "roofline": roofline_class(self.flops, self.bytes_accessed),
            "partial": self.partial, "runs": self.runs,
            "meta": self.meta,
        }


def _as_cost(cost):
    if isinstance(cost, WorkCount):
        return {"flops": cost.flops, "bytes accessed": cost.bytes_accessed}
    return cost


def capture(label, cost=None, mem=None, key=None, **meta):
    """Record one step's cost sheet under ``key`` (default ``label``),
    replacing an earlier one. ``cost`` is a :class:`WorkCount` or a
    ``{"flops", "bytes accessed"}`` dict; without it the record is
    ``partial`` with zero FLOPs, so ``/costz`` still lists the step.

    Per-label gauges (``cost/<label>/flops`` etc.) land in the registry."""
    if key is None:
        key = label
    rec = CostRecord(key, label, _as_cost(cost), mem, meta)
    with _lock:
        _records.pop(key, None)
        _records[key] = rec
        while len(_records) > _RECORDS_LIMIT:
            _records.pop(next(iter(_records)))
    for field in ("flops", "bytes_accessed", "peak_hbm_bytes"):
        _reg.gauge(f"cost/{label}/{field}").set(getattr(rec, field))
    from . import flight_recorder as _flight

    _flight.record_event(
        "cost_capture", label=label, flops=rec.flops,
        bytes_accessed=rec.bytes_accessed,
        peak_hbm_bytes=rec.peak_hbm_bytes, partial=rec.partial,
        **{k: str(v)[:120] for k, v in meta.items()})
    return rec


def note_run(record, n=1):
    """Account ``n`` executions of a recorded step into the executed-work
    ledger (``cost/executed_flops``, ``cost/executed_bytes``) the
    TrainingMonitor's MFU window differences. Two counter adds; a ``None``
    record is free."""
    if record is None:
        return
    record.runs += n
    if record.flops:
        _reg.counter("cost/executed_flops").inc(record.flops * n)
    if record.bytes_accessed:
        _reg.counter("cost/executed_bytes").inc(record.bytes_accessed * n)


def cost_records() -> dict:
    """Live CostRecords by key (insertion order)."""
    with _lock:
        return dict(_records)


def latest_record(label=None):
    """Most recently captured record (optionally filtered by label)."""
    with _lock:
        for rec in reversed(list(_records.values())):
            if label is None or rec.label == label:
                return rec
    return None


def reset_cost_records():
    with _lock:
        _records.clear()


# ---------------------------------------------------------------------------
# Device peak table
# ---------------------------------------------------------------------------

# (device-name substring, most specific first) -> dense bf16 tensor-core
# FLOP/s, HBM bytes/s, NVLink bytes/s a direction and memory bytes: NVIDIA's
# data sheet figures for the H100 PCIe and SXM parts at their full power
# limits. On a present card hbm_bytes is the card's own total
# (torch.cuda.mem_get_info), the static memory planner's budget.
_PEAKS_TABLE = (
    ("h100 pcie", {"flops": 756e12, "hbm_bw": 2.0e12, "ici_bw": 300e9,
                   "hbm_bytes": 80e9}),
    ("h100", {"flops": 989.4e12, "hbm_bw": 3.35e12, "ici_bw": 450e9,
              "hbm_bytes": 80e9}),
)

# CPU / unknown devices get NOMINAL peaks (order-of-magnitude host numbers)
# so the utilization plumbing works everywhere; the payload says
# "nominal": true
_NOMINAL_PEAKS = {"flops": 1e11, "hbm_bw": 5e10, "ici_bw": 1e10,
                  "hbm_bytes": 8e9}

_PEAK_KEYS = ("flops", "hbm_bw", "ici_bw", "hbm_bytes")
_card_bytes: dict = {}  # CUDA device index -> its memory, read once
_parse_memo = [None, {}]  # [last raw flag string, its parsed overrides]


def _device_kind(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def _parse_peaks_flag(raw: str) -> dict:
    """``FLAGS_device_peaks``: comma-separated ``k=v`` floats over
    {flops, hbm_bw, ici_bw, hbm_bytes} (FLOP/s, B/s, B/s, B). Unknown keys
    and unparseable entries do not override."""
    out = {}
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        k, _, v = part.partition("=")
        k = k.strip().lower()
        if k not in _PEAK_KEYS:
            continue
        try:
            out[k] = float(v)
        except ValueError:
            continue
    return out


def peaks_override() -> dict:
    """The entries ``FLAGS_device_peaks`` sets (parsed once per value)."""
    raw = str(flag("device_peaks"))
    if raw != _parse_memo[0]:
        _parse_memo[0], _parse_memo[1] = raw, _parse_peaks_flag(raw)
    return _parse_memo[1]


def _default_device():
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def device_peaks(kind=None, device=None) -> dict:
    """Peak sheet of the given device kind, else of ``device`` (default:
    the current card, or the CPU): ``{"kind", "flops", "hbm_bw",
    "ici_bw", "hbm_bytes", "nominal"}``. On a card ``hbm_bytes`` is its
    memory. ``FLAGS_device_peaks`` overrides any subset, and an override
    clears ``nominal``."""
    if kind is None:
        device = torch.device(device) if device is not None else _default_device()
        kind = _device_kind(device)
    else:
        device = None
    lowered = kind.lower()
    peaks, nominal = None, True
    for sub, vals in _PEAKS_TABLE:
        if sub in lowered:
            peaks, nominal = dict(vals), False
            break
    if peaks is None:
        peaks = dict(_NOMINAL_PEAKS)
    if device is not None and device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        total = _card_bytes.get(index)
        if total is None:
            total = _card_bytes[index] = int(torch.cuda.mem_get_info(index)[1])
        peaks["hbm_bytes"] = total
    override = peaks_override()
    if override:
        peaks.update(override)
        nominal = False
    peaks["kind"] = kind
    peaks["nominal"] = nominal
    return peaks


# ---------------------------------------------------------------------------
# Utilization math
# ---------------------------------------------------------------------------


def mfu(flops_per_s, peaks=None) -> float:
    """Model FLOPs utilization: achieved FLOP/s over the device's peak."""
    peaks = peaks or device_peaks()
    return float(flops_per_s) / peaks["flops"] if peaks["flops"] else 0.0


def hbm_bw_util(bytes_per_s, peaks=None) -> float:
    """Achieved memory traffic over the device's peak memory bandwidth."""
    peaks = peaks or device_peaks()
    return float(bytes_per_s) / peaks["hbm_bw"] if peaks["hbm_bw"] else 0.0


def roofline_class(flops, bytes_accessed, peaks=None) -> str:
    """``compute-bound`` when the arithmetic intensity (FLOPs per byte)
    reaches the ridge point (peak FLOP/s over peak bytes/s), else
    ``memory-bound``; ``unknown`` without both counts."""
    if not flops or not bytes_accessed:
        return "unknown"
    peaks = peaks or device_peaks()
    if not peaks["hbm_bw"] or not peaks["flops"]:
        return "unknown"
    ridge = peaks["flops"] / peaks["hbm_bw"]
    return ("compute-bound" if (flops / bytes_accessed) >= ridge
            else "memory-bound")


def costz_payload() -> dict:
    """The ``/costz`` body: the device peaks, every recorded step's cost
    sheet and the executed-work ledger."""
    return {
        "device_peaks": device_peaks(),
        "executed_flops": _reg.counter("cost/executed_flops").value,
        "executed_bytes": _reg.counter("cost/executed_bytes").value,
        "records": [rec.to_dict() for rec in cost_records().values()],
    }
