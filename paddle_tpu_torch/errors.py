"""Structured errors (PADDLE_ENFORCE equivalent), the port's own copy.

Counterpart of ``paddle_tpu/errors.py``: the same names and codes for the
errors the serving path raises. Each carries a ``code`` from the
reference's error_codes.proto taxonomy; one raised about a static op
carries its ``op_context`` (type, inputs, outputs). The message follows
``FLAGS_call_stack_level`` as the JAX package formats it
(``paddle_tpu/errors.py:47-66``): 0 the message, 1 (the default) with the
op context, 2 with the Python call stack too.
"""
from __future__ import annotations

import traceback

__all__ = [
    "EnforceNotMet",
    "InvalidArgumentError",
    "NotFoundError",
    "PreconditionNotMetError",
    "ResourceExhaustedError",
    "ExecutionTimeoutError",
    "UnavailableError",
    "UnimplementedError",
    "FatalError",
    "op_error_context",
]


class EnforceNotMet(RuntimeError):
    """Base structured error (enforce.h EnforceNotMet)."""

    code = "UNKNOWN"

    def __init__(self, message, op_context=None):
        self.raw_message = str(message)
        self.op_context = op_context
        super().__init__(self._format())

    def _format(self):
        # flags imports this module: the flag is read when an error is made
        from .flags import flag

        try:
            level = int(flag("call_stack_level"))
        except Exception:
            level = 1
        parts = [f"[{self.code}] {self.raw_message}"]
        ctx = self.op_context
        if level >= 1 and ctx:
            io = ""
            if ctx.get("inputs") is not None:
                io = (f" inputs={list(ctx['inputs'])}"
                      f" outputs={list(ctx.get('outputs', []))}")
            parts.append(f"  [operator < {ctx.get('op_type', '?')} > error]{io}")
        if level >= 2:
            stack = "".join(traceback.format_stack()[:-3])
            parts.append("  [python call stack]\n" + stack)
        return "\n".join(parts)


class InvalidArgumentError(EnforceNotMet):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet):
    code = "NOT_FOUND"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class ResourceExhaustedError(EnforceNotMet):
    code = "RESOURCE_EXHAUSTED"


class ExecutionTimeoutError(EnforceNotMet):
    code = "EXECUTION_TIMEOUT"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


class UnimplementedError(EnforceNotMet):
    code = "UNIMPLEMENTED"


class FatalError(EnforceNotMet):
    code = "FATAL"


def op_error_context(op):
    """The op-context dict of a static-graph op."""
    return {
        "op_type": getattr(op, "type", "?"),
        "inputs": [n for ns in getattr(op, "inputs", {}).values() for n in ns],
        "outputs": [n for ns in getattr(op, "outputs", {}).values() for n in ns],
    }
