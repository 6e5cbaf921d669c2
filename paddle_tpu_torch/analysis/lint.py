"""Framework-aware AST lint, the port's copy (``paddle_tpu/analysis/lint.py``), retargeted at CUDA-graph capture.

The JAX package's five rules keep their ids and slugs; each reads as what
it means where the port captures a step into a CUDA graph. A captured body
runs in Python twice (the eager first run and the capture) and never again:
every replay launches what those runs recorded.

- ``stale-flag-read`` (GL001): a ``flag("...")``/``FLAGS_*``/environ read
  lexically inside a captured body. The graph bakes in the branch the read
  took, and ``set_flags`` afterwards changes nothing.
- ``unlocked-shared-mutation`` (GL002): augmented assignment on a
  ``self.*`` counter in a class that also spawns threads or serves HTTP,
  outside any ``with <lock>`` block (unchanged).
- ``host-sync-in-hot-path`` (GL003): ``.item()``, ``.cpu()``,
  ``.tolist()``, ``float()``/``int()``/``bool()`` of a value,
  ``np.asarray()`` or ``torch.cuda.synchronize()`` inside a decode or
  dispatch loop: each waits for the card and stalls the launch queue.
  ``.cpu()``/``.tolist()`` of a cache-named value is GL005's.
- ``weak-type-capture`` (GL004): ``torch.tensor(<literal>)`` or
  ``torch.as_tensor(<literal>)`` without both ``dtype=`` and ``device=``
  inside a captured body: a host tensor made at capture, whose value and
  copy the graph freezes (and whose dtype is inferred from the literal).
  The JAX forms (``jnp.asarray(0)``, ``jnp.full(s, 0.5)``) stay.
- ``cache-pull-in-hot-loop`` (GL005): ``np.asarray``/``.numpy()``/
  ``.tolist()``/``.copy()``/``.cpu()`` of a kv/cache/slab-named value
  inside a decode or dispatch loop: O(cache) bytes to the host per token.

A captured body ("traced" below, the JAX word) is any of:

- a function handed to ``jax.jit``/``pjit``/``pmap`` or ``to_static``
  (decorated, or passed by name), or built inside a ``_build_pure`` /
  ``_trace_*`` function (the JAX package's roots, kept so that this lint
  gives the JAX lint's findings on the JAX package's sources);
- the loss function handed to ``train_step(model, opt, loss_fn)`` unless
  ``jit=False`` (``framework/jit.py``), the function handed to
  ``eval_step(model, fn)``, and the function handed to a store's
  ``capture(sig, fn, inputs)`` (``runtime/compiled.py``), by name or as a
  lambda;
- the body of a ``with compiled_step():`` or ``with torch.cuda.graph(...):``
  block;
- anything defined lexically inside one of these.

This module is pure ``ast``: it imports neither torch nor the port, so
``python -m paddle_tpu_torch.analysis.graphlint`` runs without a card.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import List, Optional

__all__ = ["LintFinding", "lint_rules", "lint_source", "lint_file",
           "lint_paths", "RULES"]


@dataclass
class LintFinding:
    rule: str       # slug, e.g. "stale-flag-read"
    rule_id: str    # short id, e.g. "GL001"
    path: str
    line: int
    col: int
    func: str       # enclosing function qualname ("<module>" at top level)
    message: str
    hint: str

    def __str__(self):
        return (f"{self.path}:{self.line}:{self.col}: {self.rule_id} "
                f"[{self.rule}] in {self.func}: {self.message}\n"
                f"    fix: {self.hint}")


# rule slug -> (id, one-line description, fix hint)
RULES = {
    "stale-flag-read": (
        "GL001",
        "FLAGS read inside a captured (or jitted) body",
        "read the flag once when the step is built and close over the "
        "value; a read at capture bakes its branch into the graph, which "
        "every replay runs whatever set_flags says later",
    ),
    "unlocked-shared-mutation": (
        "GL002",
        "unsynchronized augmented assignment on shared instance state in "
        "a threaded/serving class",
        "guard the read-modify-write with the object's lock (with "
        "self._lock:); concurrent += interleaves and drops updates",
    ),
    "host-sync-in-hot-path": (
        "GL003",
        "device->host sync (.item()/.cpu()/.tolist()/float()/"
        "torch.cuda.synchronize()) inside a decode/dispatch loop",
        "keep the value on the card (tensor ops, torch.where) or read it "
        "once per batch outside the loop; each sync drains the launch "
        "queue",
    ),
    "weak-type-capture": (
        "GL004",
        "python literal becomes a tensor without a pinned dtype and "
        "device inside a captured body",
        "make the constant once, on the card with its dtype, when the "
        "step is built (torch.tensor(0, dtype=..., device=...)); a host "
        "tensor made at capture is frozen into every replay",
    ),
    "cache-pull-in-hot-loop": (
        "GL005",
        "whole-cache host materialization (np.asarray/.numpy()/.tolist()/"
        ".copy()/.cpu() of a kv/cache/slab value) inside a decode/"
        "dispatch loop",
        "keep the cache on the card (index updates in place) and pull "
        "only the per-step slice once per loop exit; a per-token "
        "whole-cache pull copies O(cache) bytes per token",
    ),
}


def lint_rules():
    """{slug: (id, description, hint)} for docs/CLI."""
    return dict(RULES)


# -- AST plumbing ------------------------------------------------------------

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
# callables whose function-valued arguments are traced (the JAX ones) or
# converted and captured (to_static)
_JIT_CALLS = {"jit", "pjit", "pmap", "to_static"}
# callable -> (position, keyword) of the function argument it captures
_CAPTURE_ARGS = {"train_step": (2, "loss_fn"), "eval_step": (1, "fn"),
                 "capture": (1, "fn")}
# context managers whose body is captured
_CAPTURE_BLOCKS = ("compiled_step", "cuda.graph")
# a nested function made inside one of these is handed to jax.jit by the
# enclosing function (TrainStepFn._build_pure, executor _trace_block, ...)
_TRACED_BUILDER_PREFIXES = ("_build_pure", "_trace_")
_LOCKISH = ("lock", "mutex", "cond", "cv", "sem")
_THREADY_MARKERS = {
    "Thread", "ThreadPoolExecutor", "ThreadingHTTPServer", "HTTPServer",
    "BaseHTTPRequestHandler", "serve_forever", "start_new_thread", "Timer",
    "threading", "socketserver",
}
_HOT_NAME_MARKERS = ("decode", "dispatch")
# dotted-name tokens that mark a value as a device CACHE (GL005)
_CACHE_NAME_MARKERS = ("cache", "kv", "slab", "planes")
# host-materializing zero-arg methods (GL005): each makes a host copy
_MATERIALIZE_METHODS = ("numpy", "tolist", "copy", "cpu")
# zero-arg methods that read a value on the host (GL003)
_SYNC_METHODS = ("item", "cpu", "tolist")


def _dotted(node) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _leaf(node) -> str:
    d = _dotted(node)
    return "" if d is None else d.rsplit(".", 1)[-1]


def _is_jit_callable(node) -> bool:
    return _leaf(node) in _JIT_CALLS


def _numeric_literal(node) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool):
        return True
    return (isinstance(node, ast.UnaryOp)
            and isinstance(node.op, (ast.USub, ast.UAdd))
            and _numeric_literal(node.operand))


def _literal(node) -> bool:
    """A number, a bool, or a list/tuple of them."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_literal(e) for e in node.elts)
    return _numeric_literal(node) or (isinstance(node, ast.Constant)
                                      and isinstance(node.value, bool))


def _captured_arg(call):
    """The function argument a capture entry point (``train_step``,
    ``eval_step``, a store's ``capture``) captures, else None."""
    spec = _CAPTURE_ARGS.get(_leaf(call.func))
    if spec is None:
        return None
    pos, kw = spec
    for k in call.keywords:
        if k.arg == "jit" and isinstance(k.value, ast.Constant) and k.value.value is False:
            return None
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    return call.args[pos] if len(call.args) > pos else None


def _captures_block(with_node) -> bool:
    for item in with_node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            d = _dotted(expr.func) or ""
            if any(d == m or d.endswith("." + m) for m in _CAPTURE_BLOCKS):
                return True
    return False


class _Index:
    """Parent links, per-function qualnames, the traced functions and the
    traced regions (with-block bodies and lambdas outside them)."""

    def __init__(self, tree):
        self.parent = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
        self.funcs = [n for n in ast.walk(tree) if isinstance(n, _FUNC_NODES)]
        self.qualname = {f: self._qual(f) for f in self.funcs}
        self.traced, self.regions = self._traced_set(tree)

    def _ancestors(self, node):
        while node in self.parent:
            node = self.parent[node]
            yield node

    def _qual(self, fn):
        parts = [fn.name]
        for anc in self._ancestors(fn):
            if isinstance(anc, _FUNC_NODES + (ast.ClassDef,)):
                parts.append(anc.name)
        return ".".join(reversed(parts))

    def enclosing_function(self, node):
        for anc in self._ancestors(node):
            if isinstance(anc, _FUNC_NODES):
                return anc
        return None

    def enclosing_class(self, node):
        for anc in self._ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc
        return None

    def _traced_set(self, tree):
        roots = set()
        regions = []  # ast nodes whose own nodes are captured
        by_name = {}
        for f in self.funcs:
            by_name.setdefault(f.name, []).append(f)
            # (a) decorated with jit or to_static (plain or partial(jax.jit, ...))
            for dec in f.decorator_list:
                target = dec
                if isinstance(dec, ast.Call):
                    d = _dotted(dec.func)
                    if d and d.rsplit(".", 1)[-1] == "partial" and dec.args:
                        target = dec.args[0]
                    else:
                        target = dec.func
                if _is_jit_callable(target):
                    roots.add(f)
            # (c) made inside a function that hands it to jit (_build_pure etc.)
            enc = self.enclosing_function(f)
            if enc is not None and enc.name.startswith(
                    _TRACED_BUILDER_PREFIXES):
                roots.add(f)

        def take(arg):
            if isinstance(arg, ast.Name):
                roots.update(by_name.get(arg.id, ()))
            elif isinstance(arg, _FUNC_NODES):
                roots.add(arg)
            elif isinstance(arg, ast.Lambda):
                regions.append(arg.body)

        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                # (b) passed into a jit call: jax.jit(step), to_static(fn)
                if _is_jit_callable(node.func):
                    for arg in node.args:
                        take(arg)
                # (d) handed to a capture entry point
                arg = _captured_arg(node)
                if arg is not None:
                    take(arg)
            # (e) the body of a capture block
            elif isinstance(node, (ast.With, ast.AsyncWith)) and _captures_block(node):
                regions.extend(node.body)
        # transitive: anything lexically inside a traced fn or region traces with it
        region_ids = {id(r) for r in regions}
        traced = set(roots)
        for f in self.funcs:
            for a in self._ancestors(f):
                if a in roots or id(a) in region_ids:
                    traced.add(f)
                    break
        return traced, regions

    def traced_nodes(self):
        """``[(node, fn name, qualname)]`` of every node captured with its
        body: the own nodes of each traced function and of each region, each
        node once."""
        seen, out = set(), []

        def add(nodes, name, qual):
            for node in nodes:
                if id(node) not in seen:
                    seen.add(id(node))
                    out.append((node, name, qual))

        for fn in self.traced:
            add(self.own_nodes(fn), fn.name, self.qualname[fn])
        for region in self.regions:
            fn = self.enclosing_function(region)
            if fn in self.traced:
                continue
            name = fn.name if fn is not None else "<module>"
            qual = self.qualname[fn] if fn is not None else "<module>"
            add(self._own(region), name, qual)
        return out

    def own_nodes(self, fn):
        """fn's body nodes, excluding nested function bodies (each nested
        def reports through its own walk)."""
        out = []
        for stmt in fn.body:
            out.extend(self._own(stmt))
        return out

    @staticmethod
    def _own(root):
        out = []
        stack = [root]
        while stack:
            node = stack.pop()
            out.append(node)
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _FUNC_NODES):
                    continue
                stack.append(child)
        return out

    def under_lock(self, node):
        for anc in self._ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call):
                        expr = expr.func
                    d = (_dotted(expr) or "").lower()
                    if any(tok in d for tok in _LOCKISH):
                        return True
        return False

    def in_loop_within(self, node, fn):
        for anc in self._ancestors(node):
            if anc is fn:
                return False
            if isinstance(anc, (ast.For, ast.While, ast.AsyncFor)):
                return True
        return False

    def hot_functions(self):
        """The decode/dispatch functions (by name) and their qualnames."""
        for fn in self.funcs:
            name = fn.name.lower()
            if any(m in name for m in _HOT_NAME_MARKERS) or name.endswith("_loop"):
                yield fn, self.qualname[fn]


# -- the rules ---------------------------------------------------------------

def _emit(findings, rule, path, node, func, message):
    rid, _desc, hint = RULES[rule]
    findings.append(LintFinding(
        rule, rid, path, getattr(node, "lineno", 0),
        getattr(node, "col_offset", 0), func, message, hint))


def _rule_stale_flag_read(idx, path, findings):
    for node, name, qual in idx.traced_nodes():
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            leaf = d.rsplit(".", 1)[-1]
            if leaf in ("flag", "_flag", "get_flags", "getenv"):
                _emit(findings, "stale-flag-read", path, node, qual,
                      f"{d}(...) runs while {name!r} is traced or captured; "
                      "the value is frozen into the graph")
            elif d.startswith("os.environ"):
                _emit(findings, "stale-flag-read", path, node, qual,
                      "os.environ read inside a captured body")
        elif isinstance(node, (ast.Name, ast.Attribute)):
            ident = node.id if isinstance(node, ast.Name) else node.attr
            if ident.startswith("FLAGS_"):
                _emit(findings, "stale-flag-read", path, node, qual,
                      f"{ident} read while {name!r} is traced or captured")


def _rule_unlocked_shared_mutation(idx, path, tree, findings):
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        concurrent = False
        for node in ast.walk(cls):
            ident = None
            if isinstance(node, ast.Name):
                ident = node.id
            elif isinstance(node, ast.Attribute):
                ident = node.attr
            if ident in _THREADY_MARKERS:
                concurrent = True
                break
        if not concurrent:
            continue
        for node in ast.walk(cls):
            if not isinstance(node, ast.AugAssign):
                continue
            tgt = node.target
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            fn = idx.enclosing_function(node)
            if fn is None or fn.name in ("__init__", "__new__"):
                continue
            if idx.enclosing_class(fn) is not cls:
                continue  # belongs to a nested class; judged there
            if idx.under_lock(node):
                continue
            _emit(findings, "unlocked-shared-mutation", path, node,
                  idx.qualname[fn],
                  f"self.{tgt.attr} {_augop(node)}= ... mutates shared "
                  f"state of threaded/serving class {cls.name!r} outside "
                  "any lock")


def _augop(node):
    return {
        ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
        ast.FloorDiv: "//", ast.Mod: "%", ast.BitOr: "|", ast.BitAnd: "&",
        ast.BitXor: "^",
    }.get(type(node.op), "?")


def _rule_host_sync_in_hot_path(idx, path, findings):
    for fn, qual in idx.hot_functions():
        for node in idx.own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            if not idx.in_loop_within(node, fn):
                continue
            sync = None
            d = _dotted(node.func) or ""
            leaf = d.rsplit(".", 1)[-1]
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS and not node.args
                    and (node.func.attr == "item"
                         or _cache_named(node.func.value) is None)):
                sync = f".{node.func.attr}()"
            elif d in ("np.asarray", "numpy.asarray", "np.array",
                       "numpy.array"):
                sync = f"{d}(...)"
            elif d.endswith("cuda.synchronize"):
                sync = f"{d}()"
            elif (leaf in ("float", "bool", "int") and "." not in d
                    and len(node.args) == 1
                    and isinstance(node.args[0], (ast.Name, ast.Attribute))):
                sync = f"{leaf}(...)"
            if sync:
                _emit(findings, "host-sync-in-hot-path", path, node, qual,
                      f"{sync} waits for the card inside the {fn.name!r} loop")


def _rule_weak_type_capture(idx, path, findings):
    for node, name, qual in idx.traced_nodes():
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func) or ""
        leaf = d.rsplit(".", 1)[-1]
        root = d.split(".", 1)[0]
        kws = {kw.arg for kw in node.keywords}
        has_dtype = "dtype" in kws
        bad = None
        if leaf in ("asarray", "array") and root in ("jnp", "jax"):
            if (len(node.args) == 1 and not has_dtype
                    and _numeric_literal(node.args[0])):
                bad = "a weak-typed scalar"
        elif leaf == "full" and root in ("jnp", "jax"):
            if (len(node.args) >= 2 and len(node.args) < 3
                    and not has_dtype
                    and _numeric_literal(node.args[1])):
                bad = "a weak-typed scalar"
        elif leaf in ("tensor", "as_tensor") and root == "torch":
            if (len(node.args) == 1 and not {"dtype", "device"} <= kws
                    and _literal(node.args[0])):
                bad = "a host tensor that the graph freezes"
        if bad is not None:
            _emit(findings, "weak-type-capture", path, node, qual,
                  f"{d}(<python literal>) without a pinned dtype/device inside "
                  f"{name!r}, which is traced or captured, makes {bad}")


def _cache_named(node) -> Optional[str]:
    """Dotted name of ``node`` when it names a cache-like value
    (contains a kv/cache/slab token segment-wise), else None. Sees
    through subscripts: ``self._kv[0]`` pulls the same cache."""
    while isinstance(node, ast.Subscript):
        node = node.value
    d = _dotted(node)
    if d is None:
        return None
    segments = d.lower().replace("self.", "").split(".")
    for seg in segments:
        for tok in _CACHE_NAME_MARKERS:
            if tok in seg:
                return d
    return None


def _rule_cache_pull_in_hot_loop(idx, path, findings):
    for fn, qual in idx.hot_functions():
        for node in idx.own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            if not idx.in_loop_within(node, fn):
                continue
            pull, target = None, None
            d = _dotted(node.func) or ""
            leaf = d.rsplit(".", 1)[-1]
            # np/numpy only: jnp.asarray of a device array is a free
            # device-side no-op, not a host pull
            if (d.split(".", 1)[0] in ("np", "numpy")
                    and leaf in ("asarray", "array") and node.args):
                target = _cache_named(node.args[0])
                if target:
                    pull = f"{d}({target})"
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MATERIALIZE_METHODS
                    and not node.args):
                target = _cache_named(node.func.value)
                if target:
                    pull = f"{target}.{node.func.attr}()"
            if pull:
                _emit(findings, "cache-pull-in-hot-loop", path, node, qual,
                      f"{pull} materializes the whole cache on host every "
                      f"iteration of the {fn.name!r} loop — O(cache) "
                      "bytes copied per token")


# -- entry points ------------------------------------------------------------

def lint_source(source: str, path: str = "<string>") -> List[LintFinding]:
    """Lint one source string. Returns findings (empty when clean)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        f = LintFinding("parse-error", "GL000", path, e.lineno or 0,
                        e.offset or 0, "<module>", f"syntax error: {e.msg}",
                        "fix the syntax error")
        return [f]
    idx = _Index(tree)
    findings: List[LintFinding] = []
    _rule_stale_flag_read(idx, path, findings)
    _rule_unlocked_shared_mutation(idx, path, tree, findings)
    _rule_host_sync_in_hot_path(idx, path, findings)
    _rule_weak_type_capture(idx, path, findings)
    _rule_cache_pull_in_hot_loop(idx, path, findings)
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def lint_file(path: str) -> List[LintFinding]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path)


def lint_paths(paths) -> List[LintFinding]:
    """Lint every .py file under the given files/directories."""
    files = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    findings = []
    for fp in files:
        findings.extend(lint_file(fp))
    return findings
