"""Graphlint waiver file, the port's copy (``paddle_tpu/analysis/waivers.py``): reviewed false positives, justified inline.

Format (``paddle_tpu_torch/analysis/graphlint_waivers.txt``): one waiver
per line —

    <path> <rule> <scope>  # <justification>

- ``path``: repo-relative file path the finding is in (matched by
  normalized suffix, so absolute paths from the CLI still match);
- ``rule``: rule slug (``stale-flag-read``) or id (``GL001``), or ``*``;
- ``scope``: the finding's enclosing function name or dotted qualname
  (``Batcher._assemble``), or ``*`` for the whole file;
- the justification comment is REQUIRED — an unexplained waiver is
  itself a lint error, so the gate stays zero-by-default with every
  exception reviewable in one file.

Unused waivers are reported by the CLI so the file cannot silently rot.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["Waiver", "WaiverFormatError", "load_waivers", "match_waiver"]


class WaiverFormatError(ValueError):
    pass


@dataclass
class Waiver:
    path: str
    rule: str
    scope: str
    reason: str
    line_no: int = 0
    used: int = field(default=0)  # findings this waiver absorbed

    def __str__(self):
        return (f"{self.path} {self.rule} {self.scope}  # {self.reason}")


def load_waivers(path: str) -> List[Waiver]:
    """Parse a waiver file; raises :class:`WaiverFormatError` on a line
    without a justification (the gate must not accept bare waivers)."""
    waivers = []
    if not os.path.exists(path):
        return waivers
    with open(path, encoding="utf-8") as f:
        for i, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            body, sep, reason = line.partition("#")
            reason = reason.strip()
            if not sep or not reason:
                raise WaiverFormatError(
                    f"{path}:{i}: waiver without a justification comment "
                    f"('<path> <rule> <scope>  # why'): {line!r}")
            parts = body.split()
            if len(parts) != 3:
                raise WaiverFormatError(
                    f"{path}:{i}: expected '<path> <rule> <scope>  # why', "
                    f"got {line!r}")
            waivers.append(Waiver(parts[0], parts[1], parts[2], reason, i))
    return waivers


def _norm(p: str) -> str:
    return os.path.normpath(p).replace(os.sep, "/")


def match_waiver(waivers: List[Waiver], finding) -> Optional[Waiver]:
    """First waiver covering the finding (and mark it used), else None."""
    fpath = _norm(finding.path)
    for w in waivers:
        if w.rule not in ("*", finding.rule, finding.rule_id):
            continue
        wpath = _norm(w.path)
        if not (fpath == wpath or fpath.endswith("/" + wpath)):
            continue
        if w.scope != "*":
            qual = finding.func or "<module>"
            if not (qual == w.scope or qual.endswith("." + w.scope)
                    or w.scope in qual.split(".")):
                continue
        w.used += 1
        return w
    return None
