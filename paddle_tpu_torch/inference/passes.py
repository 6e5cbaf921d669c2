"""Inference IR passes: a facade over the program-IR optimizer (``paddle_tpu/inference/passes.py``).

The Predictor's load-time pipeline (constant folding and dead-op
elimination) is two of the passes registered in
:mod:`paddle_tpu_torch.analysis.optimizer`, which ``Executor.run`` drives
too; this module keeps the load-time API, ``IrPassManager`` and the two
pass functions, and the legacy stats dictionary ``Predictor.pass_stats``
shows: ``{ops_before, folded, dce_removed, ops_after}``. Folding runs the
real kernels on the Predictor's device.
"""
from __future__ import annotations

from ..analysis import optimizer as _opt

__all__ = ["IrPassManager", "constant_folding_pass", "dead_op_elimination_pass"]

# optimizer pass name -> legacy Predictor.pass_stats key
_LEGACY_KEY = {"constant_folding": "folded", "dead_op_elimination": "dce_removed"}


def constant_folding_pass(program, scope, feed_names, fetch_names, device=None):
    """Precompute every op not reachable from a feed.

    An op whose inputs are all load-time constants (parameters in the scope,
    captured constants, outputs of already-folded ops) runs once with the
    real kernels, on ``device`` when one is given; its outputs become
    scope-resident persistable vars and the op leaves the block. A
    ``dequantize_static`` of an int8 weight folds this way. Returns the
    number of ops folded. Delegates to the registered ``constant_folding``
    optimizer pass.
    """
    return _opt.constant_folding(
        _opt.OptContext(program, feed_names, fetch_names, scope=scope, device=device))


def dead_op_elimination_pass(program, fetch_names):
    """Remove global-block ops no fetch transitively depends on, to a
    fixpoint; control flow, ``grad::`` replays, ``__inplace__`` ops,
    persistable writers and ops without outputs stay. Returns the number
    of ops removed. Delegates to the registered ``dead_op_elimination``
    optimizer pass."""
    return _opt.dead_op_elimination(_opt.OptContext(program, (), fetch_names))


class IrPassManager:
    """Ordered load-time pass application with the legacy stats
    dictionary, over :class:`paddle_tpu_torch.analysis.optimizer.PassManager`
    (which verifies the program before and after each pass that changed
    it, and books per-pass counters)."""

    def __init__(self, passes=None):
        self.passes = list(passes or ["constant_folding", "dead_op_elimination"])
        _opt.PassManager(self.passes)  # NotFoundError on unknown names, here
        self.stats = {}

    def apply(self, program, scope, feed_names, fetch_names, device=None):
        block = program.global_block()
        self.stats = {"ops_before": len(block.ops)}
        pm = _opt.PassManager(self.passes)
        for st in pm.apply(program, feed_names, fetch_names, level=1, scope=scope,
                           device=device):
            self.stats[_LEGACY_KEY.get(st.name, st.name)] = st.ops_rewritten
        self.stats["ops_after"] = len(block.ops)
        return self.stats
