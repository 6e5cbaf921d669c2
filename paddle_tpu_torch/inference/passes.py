"""Load-time passes over an inference program (``paddle_tpu/inference/passes.py``).

Constant folding and dead-op elimination, written directly over the
program's global block (the JAX package delegates to its program-IR
optimizer, which is not ported), with the same stats dictionary
``Predictor.pass_stats`` shows: ``{ops_before, folded, dce_removed,
ops_after}``.
"""
from __future__ import annotations

from ..errors import NotFoundError
from ..ops.registry import kernel

__all__ = ["IrPassManager", "constant_folding_pass", "dead_op_elimination_pass"]

_BLOCK_OPS = ("while", "cond", "scan")


def constant_folding_pass(program, scope, feed_names, fetch_names, device=None):
    """Precompute every op not reachable from a feed.

    An op whose inputs are all load-time constants (parameters in the scope,
    captured constants, outputs of already-folded ops) runs once with the
    real kernels, on ``device`` when one is given; its outputs become
    scope-resident persistable vars and the op leaves the block. A
    ``dequantize_static`` of an int8 weight folds this way. Returns the
    number of ops folded.
    """
    block = program.global_block()
    for cname, cval in program._constants.items():
        if not scope.has(cname):
            scope.set(cname, cval)
    available = set(scope.var_names())
    feeds = set(feed_names)
    folded = 0
    keep = []
    for op in block.ops:
        ins = op.input_names()
        outs = op.output_names()
        foldable = (op.type not in _BLOCK_OPS + ("feed", "fetch")
                    and not op.type.startswith("grad::") and not op.attrs.get("__rng__")
                    and all(n in available and n not in feeds for n in ins) and any(outs))
        if not foldable:
            keep.append(op)
            continue
        attrs = {k: v for k, v in op.attrs.items() if not k.startswith("__")}
        args = [scope.get(n) if device is None else scope.on(n, device) for n in ins]
        out = kernel(op.type)(*args, **attrs)
        results = list(out) if isinstance(out, (tuple, list)) else [out]
        for name, value in zip(op.outputs.get("Out", []), results):
            if not name or value is None:
                continue
            scope.set(name, value)
            if block.has_var(name):
                block.var(name).persistable = True
            available.add(name)
        folded += 1
    if folded:
        block.ops[:] = keep
        program._version += 1
    return folded


def dead_op_elimination_pass(program, fetch_names):
    """Remove global-block ops no fetch transitively depends on, to a
    fixpoint; ops that write a persistable var or have no outputs stay.
    Returns the number of ops removed."""
    block = program.global_block()
    fetches = set(fetch_names)
    persist = {v.name for v in program.list_vars() if v.persistable}
    removed_total = 0
    while True:
        uses = {}
        for op in block.ops:
            for n in op.input_names():
                uses[n] = uses.get(n, 0) + 1
        keep = []
        for op in block.ops:
            outs = [n for n in op.output_names() if n]
            side_effecting = (op.type in _BLOCK_OPS or not outs
                              or any(n in persist for n in outs))
            if side_effecting or any(n in fetches or uses.get(n, 0) > 0 for n in outs):
                keep.append(op)
        removed = len(block.ops) - len(keep)
        if not removed:
            return removed_total
        block.ops[:] = keep
        program._version += 1
        removed_total += removed


class IrPassManager:
    """Ordered pass application with the legacy stats dictionary."""

    _KNOWN = ("constant_folding", "dead_op_elimination")

    def __init__(self, passes=None):
        self.passes = list(passes or self._KNOWN)
        unknown = [p for p in self.passes if p not in self._KNOWN]
        if unknown:
            raise NotFoundError(f"unknown passes {unknown}; known: {list(self._KNOWN)}")
        self.stats = {}

    def apply(self, program, scope, feed_names, fetch_names, device=None):
        block = program.global_block()
        self.stats = {"ops_before": len(block.ops)}
        for name in self.passes:
            if name == "constant_folding":
                self.stats["folded"] = constant_folding_pass(program, scope, feed_names,
                                                             fetch_names, device)
            else:
                self.stats["dce_removed"] = dead_op_elimination_pass(program, fetch_names)
        self.stats["ops_after"] = len(block.ops)
        return self.stats
