#!/usr/bin/env python3
"""Count the names ``tools/api_spec.txt`` pins for ``paddle_tpu`` that resolve in the port.

    python tools/port_api_count.py [--list]

Each pinned ``paddle_tpu.a.b.Name`` resolves when ``paddle_tpu_torch.a.b``
imports (or ``paddle_tpu_torch.a`` has an attribute ``b``) and has
``Name``. Prints the total and the count by namespace (the first part after
``paddle_tpu``; top-level names count as ``(top level)``); ``--list`` also
prints every resolved name. Signatures are not compared. Runs on the CPU.
"""
from __future__ import annotations

import collections
import importlib
import os
import sys

SPEC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "api_spec.txt")


def _resolve(dotted):
    """The port's object for ``paddle_tpu.<dotted>``, or None."""
    parts = dotted.split(".")
    for cut in range(len(parts) - 1, -1, -1):
        try:
            obj = importlib.import_module(".".join(["paddle_tpu_torch"] + parts[:cut]))
        except ImportError:
            continue
        for name in parts[cut:]:
            obj = getattr(obj, name, None)
            if obj is None:
                return None
        return obj
    return None


def main(argv):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    names = []
    with open(SPEC) as f:
        for line in f:
            head = line.split("(", 1)[0].strip()
            if head.startswith("paddle_tpu."):
                names.append(head[len("paddle_tpu."):])
    total, found = collections.Counter(), collections.Counter()
    resolved = []
    for dotted in names:
        ns = dotted.split(".")[0] if "." in dotted else "(top level)"
        total[ns] += 1
        if _resolve(dotted) is not None:
            found[ns] += 1
            resolved.append(dotted)
    print(f"{len(resolved)} of {len(names)} pinned names resolve in paddle_tpu_torch")
    for ns in sorted(total, key=lambda n: (-found[n], n)):
        print(f"  {ns}: {found[ns]}/{total[ns]}")
    if "--list" in argv:
        print("\n".join(resolved))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
