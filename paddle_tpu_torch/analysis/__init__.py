"""Program-IR analysis (``paddle_tpu/analysis``): verifier, memory planner and IR optimizer.

The static executor runs three gates over every program before it
interprets or captures it, in the JAX package's order
(``paddle_tpu/static/executor.py:769-826``):

- :mod:`verifier` / :mod:`passes`: a pass framework over the static
  Program IR. :func:`verify_program` (also ``Program.verify``) checks block
  structure, def-before-use, write conflicts and undeclared in-place
  aliasing, dtype consistency against the port's registry and dead code;
  a malformed program becomes a :class:`VerifyError` naming the op index,
  op type and variable. Behind ``FLAGS_program_verify``; the verdict is
  cached per program version.
- :mod:`optimizer`: a :class:`PassManager` of fusion passes (conv2d +
  batch_norm + relu, residual add + layer_norm, dequantized-int8
  matmul/mul) onto the fused registry ops and so onto the hand-written
  kernels, constant folding and dead-op elimination (the Predictor's
  load-time pipeline, ``inference/passes.py``), and rematerialization
  under memory pressure. Behind ``FLAGS_ir_opt_level``.
- :mod:`memory`: liveness intervals and the peak-memory plan
  (:func:`plan_memory`), donation safety, and admission against the card's
  memory (:func:`check_memory_budget`) behind
  ``FLAGS_memory_budget_check``; :func:`note_actual` closes the plan
  against the card's measured peak.

The JAX package's AST lint (``lint``, ``waivers``) holds rules about
``jax.jit`` tracing; rules for CUDA-graph capture take their place in a
later slice (ROADMAP.md).
"""
from .verifier import (  # noqa: F401
    Finding,
    VerifyError,
    VerifyReport,
    register_pass,
    verifier_passes,
    verify_program,
)
from .memory import (  # noqa: F401
    DonationError,
    MemoryBudgetError,
    MemoryFinding,
    MemoryPlan,
    accuracy_records,
    check_memory_budget,
    hbm_budget_bytes,
    note_actual,
    plan_memory,
)
from .optimizer import (  # noqa: F401
    OptResult,
    PassManager,
    PassStats,
    measure_pass_deltas,
    optimize_program,
    optimizer_passes,
    optimizer_stats,
    register_opt_pass,
)

__all__ = [
    "DonationError",
    "MemoryBudgetError",
    "MemoryFinding",
    "MemoryPlan",
    "accuracy_records",
    "check_memory_budget",
    "hbm_budget_bytes",
    "note_actual",
    "plan_memory",
    "OptResult",
    "PassManager",
    "PassStats",
    "measure_pass_deltas",
    "optimize_program",
    "optimizer_passes",
    "optimizer_stats",
    "register_opt_pass",
    "Finding",
    "VerifyError",
    "VerifyReport",
    "register_pass",
    "verifier_passes",
    "verify_program",
]
