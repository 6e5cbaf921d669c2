"""graphlint: the port's source lint gate (counterpart of ``tools/graphlint.py``).

Runs :mod:`paddle_tpu_torch.analysis.lint` over the port's package and
reconciles the findings with the port's waiver file.

Usage:
    python -m paddle_tpu_torch.analysis.graphlint            # lint paddle_tpu_torch/
    python -m paddle_tpu_torch.analysis.graphlint FILE ...   # lint given paths
    python -m paddle_tpu_torch.analysis.graphlint --check    # gate: exit 1 on any
                                                             #   unwaived finding (and on
                                                             #   an unused waiver)
    python -m paddle_tpu_torch.analysis.graphlint --list-rules
    python -m paddle_tpu_torch.analysis.graphlint --json

Waivers: ``paddle_tpu_torch/analysis/graphlint_waivers.txt``, one
``<path> <rule> <scope>  # why`` a line. A bad waiver file exits 2, as
does a path that does not exist.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .lint import lint_paths, lint_rules
from .waivers import WaiverFormatError, load_waivers, match_waiver

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PACKAGE)
DEFAULT_PATHS = [_PACKAGE]
DEFAULT_WAIVERS = os.path.join(_PACKAGE, "analysis", "graphlint_waivers.txt")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: paddle_tpu_torch/; unused "
                         "waivers fail only this default run)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any unwaived finding (the gate)")
    ap.add_argument("--waivers", default=DEFAULT_WAIVERS,
                    help="waiver file (default: paddle_tpu_torch/analysis/"
                         "graphlint_waivers.txt)")
    ap.add_argument("--no-waivers", action="store_true",
                    help="ignore the waiver file (show every finding)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--list-rules", action="store_true")
    ns = ap.parse_args(argv)

    if ns.list_rules:
        for slug, (rid, desc, hint) in sorted(lint_rules().items(),
                                              key=lambda kv: kv[1][0]):
            print(f"{rid}  {slug}\n    {desc}\n    fix: {hint}")
        return 0

    paths = ns.paths or DEFAULT_PATHS
    for p in paths:
        # a mistyped path must fail, not gate nothing
        if not os.path.exists(p):
            print(f"graphlint: no such path: {p}", file=sys.stderr)
            return 2
        if os.path.isfile(p) and not p.endswith(".py"):
            print(f"graphlint: not a python file: {p}", file=sys.stderr)
            return 2
    findings = lint_paths(paths)
    # repo-relative paths, so waivers and logs are stable
    for f in findings:
        ap_path = os.path.abspath(f.path)
        if ap_path.startswith(_REPO + os.sep):
            f.path = os.path.relpath(ap_path, _REPO)

    try:
        waivers = [] if ns.no_waivers else load_waivers(ns.waivers)
    except WaiverFormatError as e:
        print(f"graphlint: bad waiver file: {e}", file=sys.stderr)
        return 2

    open_findings, waived = [], []
    for f in findings:
        (waived if match_waiver(waivers, f) is not None else open_findings).append(f)
    # a run over given paths never touches most waivers
    unused = [] if ns.paths else [w for w in waivers if not w.used]

    if ns.as_json:
        print(json.dumps({
            "findings": [vars(f) for f in open_findings],
            "waived": [vars(f) for f in waived],
            "unused_waivers": [vars(w) for w in unused],
        }, indent=1))
    else:
        for f in open_findings:
            print(f)
        if waived:
            print(f"graphlint: {len(waived)} finding(s) waived ({ns.waivers})")
        for w in unused:
            print(f"graphlint: UNUSED waiver {ns.waivers}:{w.line_no}: {w}")
        if not open_findings:
            print(f"graphlint: clean ({len(findings)} finding(s) total, "
                  f"{len(waived)} waived)")
        else:
            print(f"graphlint: {len(open_findings)} unwaived finding(s)")

    if ns.check and (open_findings or unused):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
