"""Structured errors (PADDLE_ENFORCE equivalent), the port's own copy.

Counterpart of ``paddle_tpu/errors.py``: the same names and codes for the
errors the serving path raises. Each carries a ``code`` from the
reference's error_codes.proto taxonomy.
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
]


class EnforceNotMet(RuntimeError):
    """Base structured error (enforce.h EnforceNotMet)."""

    code = "UNKNOWN"

    def __init__(self, message):
        self.raw_message = str(message)
        super().__init__(f"[{self.code}] {self.raw_message}")


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
