"""Structured errors (PADDLE_ENFORCE equivalent), the port's own copy.

Counterpart of ``paddle_tpu/errors.py``: the same names and codes for the
errors the serving path raises. Each carries a ``code`` from the
reference's error_codes.proto taxonomy; one raised about a static op
carries its ``op_context`` (type, inputs, outputs), formatted as the JAX
package formats it at its default ``FLAGS_call_stack_level`` of 1.
"""
from __future__ import annotations

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
        parts = [f"[{self.code}] {self.raw_message}"]
        if op_context:
            io = ""
            if op_context.get("inputs") is not None:
                io = (f" inputs={list(op_context['inputs'])}"
                      f" outputs={list(op_context.get('outputs', []))}")
            parts.append(f"  [operator < {op_context.get('op_type', '?')} > error]{io}")
        super().__init__("\n".join(parts))


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
