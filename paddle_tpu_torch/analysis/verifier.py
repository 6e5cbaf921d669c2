"""Program-IR verifier: pass framework and structured findings (``paddle_tpu/analysis/verifier.py``).

An explicit pass framework over ``Program``/``Block``/``OpDesc`` that runs
before the executor interprets or captures a program, so a malformed
program fails with the op index, op type and variable named instead of
wherever torch happens to fail.

The passes themselves live in :mod:`paddle_tpu_torch.analysis.passes`; this
module owns the finding/report/error types, the pass registry and the
entry point (:func:`verify_program`).

Severity contract: ``error`` findings always fail verification;
``warning`` findings (dead ops/vars, inconclusive dtype inference) are
reported but non-fatal unless ``level="strict"`` promotes the dead-code
pass's warnings to errors. ``Executor.run`` drives this behind
``FLAGS_program_verify`` (off | on | strict), caching the verdict on the
Program per (version, feeds, fetches) so steady-state dispatch re-pays
nothing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..errors import EnforceNotMet

__all__ = [
    "Finding", "VerifyError", "VerifyReport", "register_pass",
    "verifier_passes", "verify_program",
]


@dataclass
class Finding:
    """One verifier diagnosis, anchored to (block, op index, var)."""

    severity: str          # "error" | "warning"
    pass_name: str         # which verifier pass produced it
    message: str
    block_idx: int = 0
    op_index: Optional[int] = None   # index within its block's op list
    op_type: Optional[str] = None
    var: Optional[str] = None

    def where(self) -> str:
        loc = f"block {self.block_idx}"
        if self.op_index is not None:
            loc += f" op #{self.op_index}"
        if self.op_type:
            loc += f" <{self.op_type}>"
        return loc

    def __str__(self):
        var = f" var {self.var!r}" if self.var else ""
        return f"[{self.pass_name}] {self.where()}{var}: {self.message}"


@dataclass
class VerifyReport:
    """Outcome of one verification run over a Program."""

    findings: List[Finding] = field(default_factory=list)
    level: str = "on"

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if self._is_error(f)]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if not self._is_error(f)]

    def _is_error(self, f: Finding) -> bool:
        if f.severity == "error":
            return True
        # strict mode: dead code stops being advisory
        return self.level == "strict" and f.pass_name == "dead-code"

    @property
    def ok(self) -> bool:
        return not self.errors

    def raise_if_failed(self, program_repr=""):
        errs = self.errors
        if not errs:
            return self
        first = errs[0]
        more = f" (+{len(errs) - 1} more error(s))" if len(errs) > 1 else ""
        raise VerifyError(
            f"program verification failed{': ' + program_repr if program_repr else ''}"
            f"\n  {first}{more}",
            finding=first, report=self,
        )

    def __str__(self):
        if not self.findings:
            return "VerifyReport(clean)"
        lines = [f"VerifyReport({len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s))"]
        lines += [f"  {f}" for f in self.findings]
        return "\n".join(lines)


class VerifyError(EnforceNotMet):
    """Structured verification failure (raised before the program runs).

    Carries the first error :class:`Finding` — ``pass_name``,
    ``block_idx``, ``op_index``, ``op_type``, ``var`` — plus the full
    :class:`VerifyReport` for callers that want every diagnosis.
    """

    code = "PROGRAM_VERIFY"

    def __init__(self, message, finding: Finding = None,
                 report: VerifyReport = None):
        self.finding = finding
        self.report = report
        self.pass_name = finding.pass_name if finding else None
        self.block_idx = finding.block_idx if finding else None
        self.op_index = finding.op_index if finding else None
        self.op_type = finding.op_type if finding else None
        self.var = finding.var if finding else None
        op_context = None
        if finding is not None and finding.op_type:
            op_context = {"op_type": finding.op_type, "inputs": None}
        super().__init__(message, op_context=op_context)


# -- pass registry -----------------------------------------------------------

_PASSES: list = []  # [(name, fn)]


def register_pass(name: str):
    """Register a verifier pass: ``fn(ctx) -> None`` appending findings
    via ``ctx.error`` / ``ctx.warn``. Passes run in registration order;
    the structural pass runs first and gates the rest (walking a program
    whose block links are broken is not meaningful)."""

    def deco(fn):
        _PASSES.append((name, fn))
        return fn

    return deco


def verifier_passes() -> list:
    """Registered (name, fn) pairs, in run order."""
    from . import passes as _passes  # noqa: F401  (registers on import)

    return list(_PASSES)


class VerifyContext:
    """Everything a pass needs: the program plus the run's IO contract."""

    def __init__(self, program, feed_names=(), fetch_names=(), level="on"):
        self.program = program
        self.feed_names = frozenset(feed_names or ())
        self.fetch_names = tuple(fetch_names or ())
        self.level = level
        self.constants = frozenset(getattr(program, "_constants", {}) or ())
        # names resolvable without any op running: feeds, declared data
        # vars, persistables (the startup-scope promise), captured consts
        persist, data = set(), set()
        for blk in program.blocks:
            for name, var in blk.vars.items():
                if getattr(var, "persistable", False):
                    persist.add(name)
                if getattr(var, "is_data", False):
                    data.add(name)
        self.persistables = frozenset(persist)
        self.data_vars = frozenset(data)
        self.findings: List[Finding] = []
        self.structure_ok = True  # set by the structural pass

    # -- finding emission ---------------------------------------------------
    def error(self, pass_name, message, block_idx=0, op_index=None,
              op_type=None, var=None):
        self.findings.append(Finding("error", pass_name, message, block_idx,
                                     op_index, op_type, var))

    def warn(self, pass_name, message, block_idx=0, op_index=None,
             op_type=None, var=None):
        self.findings.append(Finding("warning", pass_name, message,
                                     block_idx, op_index, op_type, var))

    # -- shared helpers -----------------------------------------------------
    def statically_defined(self, name) -> bool:
        return (name in self.feed_names or name in self.data_vars
                or name in self.persistables or name in self.constants)

    def resolve_var(self, block, name):
        """Block-scoped var lookup through parent links, or None."""
        try:
            return block.var(name)
        except KeyError:
            return None


def op_in_names(op):
    """Positional input names: the ``__in_slots__`` slots in order, else
    ``X`` (the JAX executor's ``op_in_names``)."""
    slots = op.attrs.get("__in_slots__")
    if slots:
        return [n for s in slots for n in op.inputs.get(s, [])]
    return op.inputs.get("X", [])


def op_out_names(op):
    slots = op.attrs.get("__out_slots__")
    if slots:
        return [n for s in slots for n in op.outputs.get(s, [])]
    return op.outputs.get("Out", [])


def all_in_names(op):
    return [n for ns in op.inputs.values() for n in ns]


def all_out_names(op):
    return [n for ns in op.outputs.values() for n in ns]


def verify_program(program, feed_names=(), fetch_names=(),
                   level="on") -> VerifyReport:
    """Run every registered verifier pass over ``program``.

    Returns the :class:`VerifyReport` when verification passes (it may
    still carry warnings); raises :class:`VerifyError` naming the first
    offending (block, op index, op type, var) otherwise.
    """
    ctx = VerifyContext(program, feed_names, fetch_names, level)
    passes = verifier_passes()
    for name, fn in passes:
        fn(ctx)
        if name == "block-structure" and any(
                f.severity == "error" for f in ctx.findings):
            # broken block links: later passes would chase bad indices
            break
    report = VerifyReport(ctx.findings, level=level)
    report.raise_if_failed(program_repr=repr(program))
    return report
