"""Static liveness and peak-memory planning over the Program IR (``paddle_tpu/analysis/memory.py``).

The footprint of a run is a static property of the IR, computed before the
executor interprets or captures the program:

- **Liveness intervals.** One forward walk over ``Program``/``Block``/
  ``OpDesc`` (recursing through while/cond/scan sub-blocks with
  max-over-branches semantics) gives every value a ``[def, last_use]``
  interval. Shapes come from the VarDescs, refined by running the registry
  kernels on ``meta`` tensors of the resolved operand specs
  (``ops/registry.py`` ``eval_meta``; the fused ops' shape rules), so ``-1``
  batch dims concretize from the run's feed shapes.
- **Peak accounting.** Baseline bytes (feeds, referenced persistables and
  captured constants, resident for the whole run) plus the live
  intermediates per op give the predicted peak, the high-water op, a per-op
  resident curve and the top-K largest live tensors at the peak. An
  ``__inplace__`` update aliases its output onto the input's buffer and is
  never counted twice. The executor frees each value of the global block
  after its last read (``static/executor.py`` ``_last_reads``), which is the
  interval this plan assumes.
- **Donation safety.** An input declared ``__inplace__`` whose buffer is
  consumed into a differently-named output must be dead afterwards: a later
  read (or fetch) of it is a use-after-donation (:class:`DonationError`).
  The port's in-place writes are these ``__inplace__`` outputs and the
  persistables the executor copies back into the scope (``_write_back``).
  The advisor flags inputs that die at an op with an alias-compatible
  output but no declaration.

``Executor.run`` drives :func:`check_memory_budget` behind
``FLAGS_memory_budget_check`` (off | warn | strict): the predicted peak is
compared against :func:`hbm_budget_bytes` (the card's memory, or
``FLAGS_device_peaks`` ``hbm_bytes=``) before anything runs. A budget of 0
(the CPU) is inconclusive and never blocks. Verdicts cache per program
version, so a replay pays a dictionary lookup.

After a signature's first run on the card the executor closes the plan
against the measurement: :func:`note_actual` compares the predicted peak
with the bytes the run allocated above its starting level at its high-water
mark (``torch.cuda.max_memory_allocated`` after a peak reset) plus the
plan's baseline, into a ``plan_accuracy`` ratio, the
``memplan/plan_accuracy`` gauge and :func:`accuracy_records`. What the plan
cannot see: a kernel wrapper's own temporaries (the conv GEMM's patch
matrix, ``ops/cuda/conv_bn_relu.py`` ``_as_matmul``) and the allocator's
rounding.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..errors import EnforceNotMet
from .verifier import all_in_names, all_out_names, op_in_names
from ..profiler import bump_counter

__all__ = [
    "MemoryFinding", "MemoryPlan", "MemoryBudgetError", "DonationError",
    "plan_memory", "check_memory_budget", "hbm_budget_bytes",
    "note_actual", "accuracy_records", "reset_accuracy_records",
    "MeasuredRun", "measured_peak",
]

_BLOCK_OPS = ("while", "cond", "scan")

_DYN = 83  # op_append.py's dynamic-dim placeholder


# ---------------------------------------------------------------------------
# findings / plan / errors
# ---------------------------------------------------------------------------


@dataclass
class MemoryFinding:
    """One planner diagnosis, anchored to (block, op index, var).

    ``severity``: ``"error"`` (donation-unsafe: rejected under the
    budget gate), ``"warning"`` (inconclusive shape: the var was
    excluded from byte counts), or ``"advice"`` (donation-eligible but
    undeclared — the advisor side, never fatal).
    """

    severity: str
    kind: str
    message: str
    block_idx: int = 0
    op_index: Optional[int] = None
    op_type: Optional[str] = None
    var: Optional[str] = None

    def __str__(self):
        loc = f"block {self.block_idx}"
        if self.op_index is not None:
            loc += f" op #{self.op_index}"
        if self.op_type:
            loc += f" <{self.op_type}>"
        var = f" var {self.var!r}" if self.var else ""
        return f"[{self.kind}] {loc}{var}: {self.message}"


class MemoryBudgetError(EnforceNotMet):
    """Predicted peak memory exceeds the device budget: raised before the
    program runs under ``FLAGS_memory_budget_check=strict``, naming the
    high-water op and the top live tensors; the generation engine raises
    it for a geometry that does not fit (with no plan)."""

    code = "MEMORY_BUDGET"

    def __init__(self, message, plan=None, budget_bytes=None):
        self.plan = plan
        self.budget_bytes = budget_bytes
        self.peak_bytes = plan.peak_bytes if plan is not None else None
        self.op_index = plan.peak_op_index if plan is not None else None
        self.op_type = plan.peak_op_type if plan is not None else None
        super().__init__(message)


class DonationError(EnforceNotMet):
    """Liveness-unsafe donation: a declared ``__inplace__``/donated
    buffer is read after it was consumed."""

    code = "DONATION_SAFETY"

    def __init__(self, message, finding: MemoryFinding = None):
        self.finding = finding
        self.op_index = finding.op_index if finding else None
        self.op_type = finding.op_type if finding else None
        self.var = finding.var if finding else None
        super().__init__(message)


class MemoryPlan:
    """Predicted device-memory footprint of one (program, feeds, fetches) run.

    - ``peak_bytes`` — predicted peak resident bytes (baseline + live
      intermediates at the high-water op, sub-block peaks included);
    - ``peak_op_index``/``peak_op_type`` — the high-water op in the
      global block (``None`` for an op-less program: peak == baseline);
    - ``baseline_bytes`` — feeds + referenced persistables + captured
      constants (resident for the whole dispatch);
    - ``resident_bytes`` — the per-op resident curve (global block);
    - ``top_tensors`` — ``[(name, bytes, source), ...]`` largest live
      values at the high-water op, largest first;
    - ``findings`` — donation-safety errors, shape warnings, and
      donation advisories (:class:`MemoryFinding`);
    - ``unresolved`` — var names whose shapes could not be concretized
      (excluded from byte counts, surfaced as warnings).
    """

    __slots__ = ("peak_bytes", "peak_op_index", "peak_op_type",
                 "baseline_bytes", "resident_bytes", "top_tensors",
                 "findings", "unresolved", "op_count")

    def __init__(self, peak_bytes, peak_op_index, peak_op_type,
                 baseline_bytes, resident_bytes, top_tensors, findings,
                 unresolved):
        self.peak_bytes = int(peak_bytes)
        self.peak_op_index = peak_op_index
        self.peak_op_type = peak_op_type
        self.baseline_bytes = int(baseline_bytes)
        self.resident_bytes = list(resident_bytes)
        self.top_tensors = list(top_tensors)
        self.findings = list(findings)
        self.unresolved = sorted(unresolved)
        self.op_count = len(self.resident_bytes)

    @property
    def errors(self) -> List[MemoryFinding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def advisories(self) -> List[MemoryFinding]:
        return [f for f in self.findings if f.severity == "advice"]

    @property
    def warnings(self) -> List[MemoryFinding]:
        return [f for f in self.findings if f.severity == "warning"]

    def top_summary(self, k=3) -> str:
        return ", ".join(f"{n} ({_fmt_bytes(b)}, {src})"
                         for n, b, src in self.top_tensors[:k])

    def raise_if_unsafe(self):
        """Raise :class:`DonationError` on the first donation-safety
        error (use-after-donation); a safe plan returns itself."""
        errs = self.errors
        if errs:
            first = errs[0]
            more = (f" (+{len(errs) - 1} more)" if len(errs) > 1 else "")
            raise DonationError(
                f"donation-safety analysis failed: {first}{more}",
                finding=first)
        return self

    def to_dict(self) -> dict:
        return {
            "peak_bytes": self.peak_bytes,
            "peak_op_index": self.peak_op_index,
            "peak_op_type": self.peak_op_type,
            "baseline_bytes": self.baseline_bytes,
            "op_count": self.op_count,
            "top_tensors": [
                {"name": n, "bytes": b, "source": s}
                for n, b, s in self.top_tensors],
            "errors": [str(f) for f in self.errors],
            "advisories": [str(f) for f in self.advisories],
            "unresolved": list(self.unresolved),
        }

    def __repr__(self):
        where = (f"op #{self.peak_op_index} <{self.peak_op_type}>"
                 if self.peak_op_index is not None else "baseline")
        return (f"MemoryPlan(peak={_fmt_bytes(self.peak_bytes)} @ {where}, "
                f"baseline={_fmt_bytes(self.baseline_bytes)}, "
                f"ops={self.op_count}, errors={len(self.errors)})")


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0


# ---------------------------------------------------------------------------
# shape/spec resolution
# ---------------------------------------------------------------------------


def _itemsize(dtype) -> int:
    from ..framework.dtype import torch_dtype

    return torch.empty((), dtype=torch_dtype(str(dtype)), device="meta").element_size()


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * _itemsize(dtype) \
        if shape is not None else _itemsize(dtype)


def _declared_spec(block, name, batch_hint):
    """(shape tuple, dtype) from the VarDesc, resolving ``-1`` dims with
    the run's batch hint; None when unresolvable."""
    try:
        var = block.var(name)
    except KeyError:
        return None
    shape = var.shape
    dtype = var.dtype
    if shape is None:
        return ((), dtype)  # scalar by convention
    out = []
    for d in shape:
        if d in (-1, None):
            if batch_hint is None:
                return None
            d = batch_hint
        out.append(int(d))
    return (tuple(out), dtype)


def _infer_out_specs(program, block, op, env, batch_hint, unresolved):
    """Resolved (shape, dtype) per output slot of ``op`` (None entries
    for outputs whose shape stays unknown). Resolution order: registry
    kernel run on ``meta`` tensors of the resolved operand specs (exact,
    and the only way ``-1`` dims concretize through the graph), grad-op
    positional mirroring, then the declared VarDesc."""
    out_names = all_out_names(op)

    if op.type in _BLOCK_OPS:
        specs = []
        if op.type == "while":
            n_loop = op.attrs.get("__n_loop__", 0)
            ins = op_in_names(op)[:n_loop]
            for i, name in enumerate(out_names):
                src = env.get(ins[i]) if i < len(ins) else None
                specs.append(src or _declared_spec(block, name, batch_hint))
        elif op.type == "scan":
            n_c = op.attrs.get("__n_carry__", 0)
            ins = op_in_names(op)[:n_c]
            for i, name in enumerate(out_names):
                if i < n_c and i < len(ins) and env.get(ins[i]) is not None:
                    specs.append(env[ins[i]])
                else:
                    specs.append(_declared_spec(block, name, batch_hint))
        else:  # cond
            specs = [_declared_spec(block, n, batch_hint)
                     for n in out_names]
        return specs

    if op.type.startswith("grad::"):
        # grads mirror the forward inputs positionally (backward.py)
        n_in = op.attrs.get("__n_fwd_in__", 0)
        fwd = all_in_names(op)[:n_in]
        specs = []
        for i, name in enumerate(out_names):
            src = env.get(fwd[i]) if i < len(fwd) else None
            specs.append(src or _declared_spec(block, name, batch_hint))
        return specs

    # registry kernel: abstract-eval with the resolved operand specs
    specs = _eval_shape_specs(op, block, env, batch_hint)
    if specs is not None:
        return specs
    out = []
    for name in out_names:
        s = _declared_spec(block, name, batch_hint)
        if s is None and name:
            unresolved.add(name)
        out.append(s)
    return out


def _eval_shape_specs(op, block, env, batch_hint):
    from ..framework.dtype import torch_dtype
    from ..ops.registry import _REGISTRY, eval_meta

    if op.type not in _REGISTRY:
        return None
    metas = []
    for n in op_in_names(op):
        s = env.get(n) if n else None
        if s is None and n:
            s = _declared_spec(block, n, batch_hint)
        if s is None:
            return None
        metas.append(torch.empty(tuple(s[0]), dtype=torch_dtype(s[1]), device="meta"))
    attrs = {k: v for k, v in op.attrs.items() if not k.startswith("__")}
    try:
        out = eval_meta(op.type, metas, attrs)
    except Exception:
        return None
    out_specs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [(tuple(int(d) for d in s.shape), _np_name(s.dtype)) for s in out_specs]


def _np_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def plan_memory(program, feed_names=(), fetch_names=(), feed_shapes=None,
                top_k=8) -> MemoryPlan:
    """Interval-based liveness analysis of ``program``'s global block.

    ``feed_shapes`` (``{name: shape tuple}``) concretizes ``-1`` batch
    dims; without it, unresolvable vars are excluded from byte counts
    and reported in ``plan.unresolved``. Returns the
    :class:`MemoryPlan`; donation-safety violations are findings on the
    plan (``plan.raise_if_unsafe()`` / the executor gate reject them).
    """
    feed_names = tuple(feed_names or ())
    fetch_names = tuple(
        v if isinstance(v, str) else v.name for v in (fetch_names or ()))
    feed_shapes = dict(feed_shapes or {})
    findings: List[MemoryFinding] = []
    unresolved: set = set()

    if not program.blocks:
        return MemoryPlan(0, None, None, 0, [], [], findings, unresolved)
    root = program.blocks[0]

    persistables, data_vars = set(), set()
    for blk in program.blocks:
        for name, var in blk.vars.items():
            if getattr(var, "persistable", False):
                persistables.add(name)
            if getattr(var, "is_data", False):
                data_vars.add(name)
    constants = dict(getattr(program, "_constants", {}) or {})

    # batch hint: the first feed that concretizes a declared -1 dim
    batch_hint = None
    for n in feed_names:
        shape = feed_shapes.get(n)
        decl = None
        try:
            decl = root.var(n).shape
        except KeyError:
            pass
        if shape is not None and decl:
            for d_decl, d_real in zip(decl, shape):
                if d_decl in (-1, None):
                    batch_hint = int(d_real)
                    break
        if batch_hint is not None:
            break

    # resolved spec env, seeded with everything statically defined
    env: Dict[str, Tuple[tuple, str]] = {}
    for n in feed_names:
        if n in feed_shapes:
            dt = "float32"
            try:
                dt = root.var(n).dtype
            except KeyError:
                pass
            env[n] = (tuple(int(d) for d in feed_shapes[n]), dt)
        else:
            s = _declared_spec(root, n, batch_hint)
            if s is not None:
                env[n] = s
            else:
                unresolved.add(n)
    for n in sorted(persistables | data_vars):
        if n in env:
            continue
        s = _declared_spec(root, n, batch_hint)
        if s is not None:
            env[n] = s
        elif n in persistables:
            unresolved.add(n)
    for n, arr in constants.items():
        a = np.asarray(arr)
        env[n] = (tuple(a.shape), str(a.dtype))

    # referenced names across ALL blocks (baseline counts only the
    # persistables/constants the executor actually threads in)
    referenced: set = set()
    for blk in program.blocks:
        for op in blk.ops:
            referenced.update(n for n in all_in_names(op) if n)
            referenced.update(n for n in all_out_names(op) if n)
    referenced.update(fetch_names)

    baseline_names = set(feed_names)
    baseline_names |= {n for n in persistables if n in referenced}
    baseline_names |= {n for n in constants if n in referenced}
    baseline = 0
    for n in sorted(baseline_names):
        s = env.get(n)
        if s is None:
            continue
        baseline += _nbytes(*s)

    ops = list(root.ops)
    n_ops = len(ops)
    def_idx: Dict[str, int] = {}
    last_use: Dict[str, int] = {}
    sub_extra = [0] * n_ops
    alias_discount = [0] * n_ops
    baseline_adjust = [0] * (n_ops + 1)  # donated baseline buffers die
    consumed_at: Dict[str, int] = {}    # var -> op index that donated it

    for i, op in enumerate(ops):
        ins = [n for n in all_in_names(op) if n]
        for n in ins:
            donor_op = consumed_at.get(n)
            if donor_op is not None and donor_op < i:
                findings.append(MemoryFinding(
                    "error", "donated-then-read",
                    f"input {n!r} was donated by op #{donor_op} "
                    f"<{ops[donor_op].type}> (declared __inplace__ into a "
                    "differently-named output); its buffer is consumed — "
                    "reading it here is a use-after-donation",
                    block_idx=0, op_index=i, op_type=op.type, var=n))
            last_use[n] = i

        outs = all_out_names(op)
        out_specs = _infer_out_specs(program, root, op, env, batch_hint,
                                     unresolved)
        outs_set = set(n for n in outs if n)
        for name, spec in zip(outs, out_specs):
            if not name:
                continue
            if spec is not None:
                env[name] = spec
            else:
                unresolved.add(name)
            def_idx.setdefault(name, i)

        # grad:: ops carry the FORWARD op's attrs verbatim (backward.py)
        # including its __inplace__ — the vjp replay aliases nothing, so
        # the inherited declaration must not read as a donation here
        declared = (() if op.type.startswith("grad::")
                    else tuple(op.attrs.get("__inplace__") or ()))
        for v in declared:
            if v not in ins:
                findings.append(MemoryFinding(
                    "error", "inplace-not-an-input",
                    f"__inplace__ declares {v!r} which the op does not "
                    "read; an aliasing declaration must name an input "
                    "whose buffer the op consumes",
                    block_idx=0, op_index=i, op_type=op.type, var=v))
                continue
            if v in outs_set:
                continue  # same-name state chain: one buffer, one name
            # consumed into a differently-named output: the donor's
            # buffer is reused, so donor+recipient count once at op i
            # and the donor is dead afterwards
            consumed_at[v] = i
            s = env.get(v)
            if s is not None:
                alias_discount[i] += _nbytes(*s)
                if v in baseline_names:
                    baseline_adjust[i + 1] -= _nbytes(*s)
                else:
                    last_use[v] = i

        # donation advisor: an intermediate input that dies HERE while an
        # alias-compatible output exists could have donated its buffer
        if len(findings) < 256:
            for v in ins:
                if (v in declared or v in baseline_names
                        or v in fetch_names or v in outs_set):
                    continue
                sv = env.get(v)
                if sv is None:
                    continue
                for w, sw in zip(outs, out_specs):
                    if (w and w != v and sw is not None
                            and sw == sv and w not in declared):
                        # only an advisory if v is genuinely dead after i
                        # — patched below once last uses are final
                        findings.append(MemoryFinding(
                            "advice", "donation-eligible",
                            f"input {v!r} could donate its buffer to "
                            f"output {w!r} (same shape/dtype) via the "
                            "__inplace__ attr if this is its last read",
                            block_idx=0, op_index=i, op_type=op.type,
                            var=v))
                        break

        if op.type in _BLOCK_OPS:
            sub_extra[i] = _subblock_peak(
                program, op, env, batch_hint, unresolved, findings,
                frozenset({0}))

    # fetches stay live to the end of the block
    for n in fetch_names:
        if n in def_idx or n in env:
            last_use[n] = n_ops
        donor_op = consumed_at.get(n)
        if donor_op is not None:
            findings.append(MemoryFinding(
                "error", "donated-then-read",
                f"fetch target {n!r} was donated by op #{donor_op} "
                f"<{ops[donor_op].type}>; fetching a consumed buffer is "
                "a use-after-donation",
                block_idx=0, op_index=donor_op,
                op_type=ops[donor_op].type, var=n))

    # drop advisories whose var turned out to live on past the op
    findings = [
        f for f in findings
        if not (f.kind == "donation-eligible"
                and last_use.get(f.var, -1) != f.op_index)]

    # intermediates: defined by ops, not part of the baseline
    intervals = []
    for name, d in def_idx.items():
        if name in baseline_names:
            continue
        s = env.get(name)
        if s is None:
            continue
        intervals.append((name, d, last_use.get(name, d), _nbytes(*s)))

    resident = []
    peak, peak_i = baseline, None
    base_i = baseline
    for i in range(n_ops):
        base_i += baseline_adjust[i]
        live = base_i - alias_discount[i] + sub_extra[i]
        live += sum(b for (_n, d, lu, b) in intervals if d <= i <= lu)
        resident.append(int(live))
        if live > peak:
            peak, peak_i = live, i

    # top-K live tensors at the high-water op (peak_i None: the peak IS
    # the baseline — weights/feeds that don't fit still get named)
    top = []
    if peak_i is not None:
        for (name, d, lu, b) in intervals:
            if d <= peak_i <= lu:
                top.append((name, b, "intermediate"))
        if sub_extra[peak_i]:
            top.append((f"<{ops[peak_i].type} sub-block peak>",
                        sub_extra[peak_i], "sub-block"))
    for n in sorted(baseline_names):
        s = env.get(n)
        if s is None:
            continue
        src = ("feed" if n in feed_names else
               "constant" if n in constants else "persistable")
        top.append((n, _nbytes(*s), src))
    top.sort(key=lambda t: (-t[1], t[0]))
    top = top[:int(top_k)]

    for n in sorted(unresolved):
        findings.append(MemoryFinding(
            "warning", "unresolved-shape",
            f"shape of {n!r} could not be concretized; it is excluded "
            "from the byte counts (pass feed_shapes= to resolve -1 dims)",
            var=n))

    return MemoryPlan(
        peak, peak_i, ops[peak_i].type if peak_i is not None else None,
        baseline, resident, top, findings, unresolved)


def _subblock_peak(program, op, parent_env, batch_hint, unresolved,
                   findings, visiting):
    """Peak of the EXTRA bytes a control-flow op's sub-block(s) hold
    while the op runs: intermediates defined inside the block (formals
    alias the parent's carry buffers and are not re-counted), recursing
    into nested control flow; ``cond`` takes the max over its branches
    (max-over-branches semantics), ``while`` the max of cond/body."""
    from .passes import _SUBBLOCK_SPEC

    peaks = [0]
    for bkey, fkeys in _SUBBLOCK_SPEC.get(op.type, ()):
        bidx = op.attrs.get(bkey)
        if (not isinstance(bidx, int)
                or not (0 < bidx < len(program.blocks))
                or bidx in visiting):
            continue
        blk = program.blocks[bidx]
        env = dict(parent_env)
        # formals take the specs of the matching carry/seq inputs
        formals = [f for k in fkeys for f in op.attrs.get(k, ())]
        carry_ins = op_in_names(op)
        for j, f in enumerate(formals):
            src = (parent_env.get(carry_ins[j])
                   if j < len(carry_ins) else None)
            if src is None:
                src = _declared_spec(blk, f, batch_hint)
            if src is not None:
                if (op.attrs.get("__seq_formals__")
                        and f in op.attrs["__seq_formals__"]
                        and len(src[0]) > 0):
                    src = (tuple(src[0][1:]), src[1])  # per-step slice
                env[f] = src
        formal_set = set(formals)

        def_i, last_u = {}, {}
        sub_ops = list(blk.ops)
        sub_sub = [0] * len(sub_ops)
        for i, sop in enumerate(sub_ops):
            for n in all_in_names(sop):
                if n:
                    last_u[n] = i
            out_specs = _infer_out_specs(program, blk, sop, env,
                                         batch_hint, unresolved)
            for name, spec in zip(all_out_names(sop), out_specs):
                if not name:
                    continue
                if spec is not None:
                    env[name] = spec
                else:
                    unresolved.add(name)
                def_i.setdefault(name, i)
            if sop.type in _BLOCK_OPS:
                sub_sub[i] = _subblock_peak(
                    program, sop, env, batch_hint, unresolved, findings,
                    visiting | {bidx})
        # block outputs live to the end of the block
        for key in ("__body_outs__", "__carry_outs__", "__y_outs__",
                    "__true_outs__", "__false_outs__"):
            for n in op.attrs.get(key, ()):
                if n in def_i:
                    last_u[n] = len(sub_ops)
        if op.attrs.get("__cond_out__") in def_i:
            last_u[op.attrs["__cond_out__"]] = len(sub_ops)

        intervals = []
        for name, d in def_i.items():
            if name in formal_set or name in parent_env:
                continue  # aliases a buffer the parent already counts
            s = env.get(name)
            if s is None:
                continue
            intervals.append((d, last_u.get(name, d), _nbytes(*s)))
        blk_peak = 0
        for i in range(len(sub_ops)):
            live = sub_sub[i] + sum(
                b for (d, lu, b) in intervals if d <= i <= lu)
            blk_peak = max(blk_peak, live)
        peaks.append(blk_peak)
    return max(peaks)


# ---------------------------------------------------------------------------
# budget gate (the executor's admission)
# ---------------------------------------------------------------------------


def hbm_budget_bytes(device=None) -> int:
    """The memory budget of ``device`` from the cost model's peak sheet
    (``monitor.cost_model.device_peaks``): ``FLAGS_device_peaks``
    ``hbm_bytes=`` when it is set (the knob the strict-rejection tests and
    derated deployments use), else the card's memory
    (``torch.cuda.mem_get_info``); 0, unknown, on the CPU. ``device=None``
    means the current CUDA device where there is one."""
    from ..monitor import cost_model as _cost

    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is None or torch.device(device).type != "cuda":
        return int(_cost.peaks_override().get("hbm_bytes", 0))
    return int(_cost.device_peaks(device=device)["hbm_bytes"])


_CACHE_LIMIT = 64


def check_memory_budget(program, feed_names=(), fetch_names=(),
                        feed_shapes=None, level="warn",
                        budget_bytes=None):
    """Plan ``program``'s footprint and enforce the memory budget
    (``budget_bytes``, default :func:`hbm_budget_bytes`).

    The verdict caches on the program per (version, feeds, fetches,
    shapes, level, budget) with the verifier cache's LRU discipline, so
    ``Executor.run``'s steady state pays one dict lookup. ``strict`` raises
    :class:`MemoryBudgetError` (over budget) or :class:`DonationError`
    (use-after-donation); ``warn`` warns with the same verdicts and
    admits. Planner-internal failures never block execution: they cache an
    inconclusive verdict.

    Returns the :class:`MemoryPlan` (or ``None`` when inconclusive).
    """
    fetch_names = tuple(
        v if isinstance(v, str) else v.name for v in (fetch_names or ()))
    feeds = tuple(sorted(feed_names or ()))
    shapes_sig = tuple(sorted(
        (n, tuple(int(d) for d in s))
        for n, s in (feed_shapes or {}).items()))
    budget = int(budget_bytes if budget_bytes is not None
                 else hbm_budget_bytes())
    n_vars = sum(len(b.vars) for b in program.blocks)
    key = (program._version, n_vars, feeds, fetch_names, shapes_sig,
           str(level), budget)
    cache = program.__dict__.setdefault("_memplan_cache", {})
    hit = cache.get(key)
    if hit is not None:
        cache.pop(key, None)
        cache[key] = hit  # LRU refresh
        bump_counter("memplan::cache_hit")
        if isinstance(hit, Exception):
            raise hit.with_traceback(None)
        return None if hit is _INCONCLUSIVE else hit
    bump_counter("memplan::cache_miss")

    try:
        plan = plan_memory(program, feeds, fetch_names, feed_shapes)
    except Exception as e:  # the planner must never take execution down
        _record_verdict(program, "inconclusive",
                        error=f"{type(e).__name__}: {e}")
        _cache_put(cache, key, _INCONCLUSIVE)
        return None

    verdict, exc = "ok", None
    errs = plan.errors
    if errs:
        verdict = "donation_unsafe"
        if str(level) == "strict":
            try:
                plan.raise_if_unsafe()
            except DonationError as e:
                exc = e
    if exc is None and budget > 0 and plan.peak_bytes > budget:
        verdict = "over_budget"
        where = (f"high-water op #{plan.peak_op_index} "
                 f"<{plan.peak_op_type}>" if plan.peak_op_index is not None
                 else "baseline: the feeds/persistables alone don't fit")
        msg = (
            f"predicted peak HBM {_fmt_bytes(plan.peak_bytes)} exceeds "
            f"the device budget {_fmt_bytes(budget)} "
            f"({where}; top live tensors: "
            f"{plan.top_summary()}). Shrink the program, or override "
            "the budget via FLAGS_device_peaks hbm_bytes=...")
        if str(level) == "strict":
            exc = MemoryBudgetError(msg, plan=plan, budget_bytes=budget)

    _record_verdict(program, verdict, plan=plan, budget=budget)
    if exc is not None:
        _cache_put(cache, key, exc)
        raise exc
    if verdict != "ok":
        import warnings

        first = errs[0] if errs else None
        where = (f"at op #{plan.peak_op_index} <{plan.peak_op_type}>"
                 if plan.peak_op_index is not None else "at the baseline")
        warnings.warn(
            f"memory_budget_check={level}: {verdict} — "
            + (str(first) if first is not None else
               f"predicted peak {_fmt_bytes(plan.peak_bytes)} > budget "
               f"{_fmt_bytes(budget)} {where}"),
            RuntimeWarning, stacklevel=3)
    _cache_put(cache, key, plan)
    return plan


_INCONCLUSIVE = object()


def _cache_put(cache, key, value):
    cache[key] = value
    while len(cache) > _CACHE_LIMIT:
        try:
            cache.pop(next(iter(cache)), None)
        except (StopIteration, RuntimeError):
            break


def _record_verdict(program, verdict, plan=None, budget=None, error=None):
    """Count the verdict by kind and record it as a ``memory_budget``
    flight event: the peak, its op and the top tensors a post-mortem needs
    even when the run dies."""
    from ..monitor import flight_recorder as _flight

    bump_counter(f"memplan::verdict::{verdict}")
    fields = dict(program=f"{getattr(program, '_identity_token', id(program))}"
                          f"@v{program._version}", verdict=verdict)
    if plan is not None:
        fields.update(peak_bytes=plan.peak_bytes, baseline_bytes=plan.baseline_bytes,
                      peak_op_index=plan.peak_op_index, peak_op_type=plan.peak_op_type,
                      top=plan.top_summary(3), donation_errors=len(plan.errors))
    if budget is not None:
        fields["budget_bytes"] = int(budget)
    if error is not None:
        fields["error"] = str(error)[:300]
    _flight.record_event("memory_budget", **fields)


# ---------------------------------------------------------------------------
# accuracy closure (predicted vs measured on the card)
# ---------------------------------------------------------------------------

_acc_lock = threading.Lock()
_accuracy: dict = {}  # cache_key -> record dict (insertion-ordered)
_ACC_LIMIT = 128


class MeasuredRun(NamedTuple):
    """One measured run: ``key`` names it (the executor's capture
    signature), ``actual_bytes`` is its measured peak resident bytes
    (:func:`measured_peak`), ``transient_bytes`` the part of it allocated
    during the run."""
    key: object
    label: str
    actual_bytes: int
    transient_bytes: int


def measured_peak(allocated_before, max_allocated, plan) -> MeasuredRun:
    """``(actual_bytes, transient_bytes)``, the measured counterpart of
    ``plan.peak_bytes``: the bytes a run allocated above its starting level
    at its high-water mark (``max_memory_allocated`` after a peak reset,
    minus ``memory_allocated`` before) is the transient part; the actual
    peak adds the plan's baseline, which was resident before the run
    began."""
    transient = max(0, int(max_allocated) - int(allocated_before))
    return transient + int(plan.baseline_bytes), transient


def note_actual(record, plan) -> Optional[float]:
    """Close the loop on one run: compare the plan's predicted peak with
    ``record.actual_bytes`` (a :class:`MeasuredRun`) into a
    ``plan_accuracy`` ratio, onto the ``memplan/plan_accuracy`` gauge and
    the bounded :func:`accuracy_records` table. Returns the ratio, or
    ``None`` when either side is unavailable."""
    if record is None or plan is None:
        return None
    actual = int(record.actual_bytes)
    if actual <= 0 or plan.peak_bytes <= 0:
        return None
    ratio = plan.peak_bytes / actual
    entry = {
        "cache_key": str(record.key), "label": record.label,
        "predicted_bytes": int(plan.peak_bytes),
        "actual_bytes": actual,
        "predicted_transient_bytes": int(plan.peak_bytes - plan.baseline_bytes),
        "actual_transient_bytes": int(record.transient_bytes),
        "baseline_bytes": int(plan.baseline_bytes),
        "plan_accuracy": ratio,
    }
    with _acc_lock:
        _accuracy.pop(entry["cache_key"], None)
        _accuracy[entry["cache_key"]] = entry
        while len(_accuracy) > _ACC_LIMIT:
            _accuracy.pop(next(iter(_accuracy)))
    from ..monitor import flight_recorder as _flight
    from ..monitor import registry as _reg

    _reg.gauge("memplan/plan_accuracy").set(ratio)
    _flight.record_event("plan_accuracy", cache_key=str(record.key),
                         predicted_bytes=int(plan.peak_bytes), actual_bytes=actual,
                         ratio=round(ratio, 4))
    return ratio


def accuracy_records() -> List[dict]:
    """Predicted-vs-actual entries, oldest first (bounded)."""
    with _acc_lock:
        return [dict(v) for v in _accuracy.values()]


def reset_accuracy_records():
    with _acc_lock:
        _accuracy.clear()
