"""Dygraph-to-static: value-dependent Python control flow under ``jit.to_static`` (``paddle_tpu/dygraph_to_static.py``).

:func:`convert_to_static` rewrites a function's source (the port's own copy
of the JAX package's AST transformers): early ``return``\\ s become a flag
and a value, ``break``/``continue`` become flags that guard the rest of the
loop body, ``for ... in range`` becomes ``while``, and ``if``, ``while``,
``and``/``or``/``not``, ``print``, ``assert`` and ``int``/``float``/
``bool``/``len`` become calls of the runtime converters below. Where the
JAX converters ask whether a value is a tracer, the port asks whether a
tensor meets a compiled step (``runtime/compiled.py`` ``in_compiled_step``:
the eager first run and the capture of a ``to_static`` function, a layer's
``eval_step``, a ``train_step``):

- **Outside a compiled step** (plain eager, on the CPU or on the card) a
  tensor predicate is read on the host and Python control flow runs
  unchanged.
- **Inside one**, :func:`convert_ifelse` never brings its predicate to the
  host: both branches run and each output is selected with ``torch.where``
  on the predicate, as static ``cond`` does, so a captured graph replays
  either branch. The branches unify as ``lax.cond``'s do: dtypes promote, a
  value one branch leaves unbound (``None``/:data:`UNDEF`) becomes zeros
  shaped like the other branch's, and different structures or shapes
  raise. Running both branches would apply an in-place write twice, so a
  branch that writes in place to a tensor it can reach raises: one it
  carries, reads from the enclosing function or from its globals, or a
  parameter or buffer of a layer it reaches so (a train-mode BatchNorm's
  running statistics).
- :func:`convert_while_loop` on a tensor condition, and :func:`convert_print`
  and :func:`convert_assert` on tensors, need the host at every run. Inside
  a compiled step each is a sanctioned host read
  (``runtime.compiled.host_read``): the store's first run of the signature
  notes it and leaves the signature uncaptured, so it runs eagerly on the
  device at every call (``store.uncaptured`` counts the runs); the loop
  reads its predicate once an iteration, ``print`` prints and ``assert``
  raises at run time. A host read while a CUDA graph records raises: a
  value baked into a graph would be a wrong answer.
"""
from __future__ import annotations

import ast
import functools
import inspect
import sys
import textwrap

import numpy as np
import torch

from .errors import InvalidArgumentError
from .framework.tensor import Tensor, wrap

__all__ = [
    "convert_ifelse",
    "convert_while_loop",
    "convert_logical_and",
    "convert_logical_or",
    "convert_logical_not",
    "convert_print",
    "convert_assert",
    "convert_cast",
    "convert_to_static",
    "UNDEF",
]


class _Undefined:
    """Sentinel for names not yet bound when a transformed control-flow
    region starts (the reference's UndefinedVar)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<paddle_tpu_torch UNDEF>"

    def __bool__(self):
        raise NameError("variable is used before assignment inside transformed control flow")


UNDEF = _Undefined()


# ---------------------------------------------------------------------------
# runtime converters
# ---------------------------------------------------------------------------


def _traced(v) -> bool:
    """Whether ``v`` is a tensor met inside a compiled step (where the JAX
    converters meet a tracer)."""
    from .runtime.compiled import in_compiled_step

    return isinstance(v, torch.Tensor) and in_compiled_step()


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray, np.generic))


def _host_bool(v, what):
    """The Python truth of ``v``; a tensor's inside a compiled step is a
    sanctioned host read (``runtime.compiled.host_read``), which refuses
    while a graph records."""
    if isinstance(v, torch.Tensor):
        if _traced(v):
            from .runtime.compiled import host_read

            host_read(what)
        return bool(torch.Tensor.__bool__(torch.Tensor.detach(v)))
    if isinstance(v, (np.ndarray, np.generic)):
        return bool(np.asarray(v))
    return bool(v)


def _missing(v) -> bool:
    return v is None or v is UNDEF


def _flatten(tree):
    """``(leaves, spec)`` of a tree of tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        leaves, specs = [], []
        for x in tree:
            sub, spec = _flatten(x)
            leaves += sub
            specs.append(spec)
        return leaves, (type(tree), None, tuple(specs))
    if isinstance(tree, dict):
        leaves, specs = [], []
        for k in tree:
            sub, spec = _flatten(tree[k])
            leaves += sub
            specs.append(spec)
        return leaves, (dict, tuple(tree), tuple(specs))
    return [tree], None


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, subs = s
        items = [build(x) for x in subs]
        if kind is dict:
            return dict(zip(keys, items))
        if hasattr(kind, "_fields"):  # a namedtuple
            return kind(*items)
        return kind(items)

    return build(spec)


def _global_names(code):
    """The global (and attribute) names ``code`` and the functions nested
    in it read."""
    names = set(code.co_names)
    for c in code.co_consts:
        if inspect.iscode(c):
            names |= _global_names(c)
    return names


def _watched(args, fns):
    """``[(tensor, version)]`` of the tensors a branch can write to: those
    it carries (``args``), reads from the enclosing function (its closure
    cells) or from its module's globals (where ``convert_to_static`` also
    puts the original function's closure), and the parameters and buffers
    of any layer among them (``self``, a model the function closes over)."""
    values = list(args)
    for fn in fns:
        for cell in getattr(fn, "__closure__", None) or ():
            try:
                values.append(cell.cell_contents)
            except ValueError:
                pass  # an empty cell
        code, glb = getattr(fn, "__code__", None), getattr(fn, "__globals__", None)
        if code is not None and glb is not None:
            values += [glb[n] for n in sorted(_global_names(code)) if n in glb]
    leaves, _ = _flatten(values)
    seen, out = set(), []
    for v in leaves:
        ts = [v] if isinstance(v, torch.Tensor) else (
            list(v.parameters()) + list(v.buffers()) if isinstance(v, torch.nn.Module) else [])
        for t in ts:
            if id(t) not in seen:
                seen.add(id(t))
                out.append((t, t._version))
    return out


def _run_branch(fn, args, watched, which):
    out = fn(*args)
    for t, version in watched:
        if t._version != version:
            raise InvalidArgumentError(
                f"the {which} branch of an `if` on a tensor predicate writes in place to a "
                f"tensor of shape {tuple(t.shape)} it carries or reads (an argument, a closure "
                "or global value, a layer's parameter or buffer): inside a compiled step "
                "both branches run and each output is selected on the device, so the write "
                "would land whichever branch is taken; assign a new value instead (`y = y + 1`, "
                "not `y += 1` or `y.add_(1)`)")
    return out


def _as_tensor(v, device):
    """``v`` as a tensor on ``device``; a number by a fill on the device,
    not a copy from the host (which a graph capture refuses)."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, bool):
        return torch.full((), v, dtype=torch.bool, device=device)
    if isinstance(v, int):
        return torch.full((), v, dtype=torch.int64, device=device)
    if isinstance(v, float):
        return torch.full((), v, dtype=torch.get_default_dtype(), device=device)
    return torch.as_tensor(np.asarray(v), device=device)


def _numeric(v) -> bool:
    return isinstance(v, (bool, int, float)) or _is_array(v)


def _select(p, a, b, i):
    """One output of :func:`convert_ifelse` under a tensor predicate: ``a``
    where ``p``, else ``b``, unified as ``lax.cond`` unifies branches."""
    if _missing(a) and _missing(b):
        return a
    if not ((_missing(a) or _numeric(a)) and (_missing(b) or _numeric(b))):
        if a is b:
            return a
        raise TypeError(f"output {i} of an `if` on a tensor predicate differs between the "
                        f"branches and is not a tensor ({a!r} and {b!r}): both branches run "
                        "inside a compiled step, and only tensors and numbers can be selected")
    ta = None if _missing(a) else _as_tensor(a, p.device)
    tb = None if _missing(b) else _as_tensor(b, p.device)
    ta = torch.zeros_like(tb) if ta is None else ta
    tb = torch.zeros_like(ta) if tb is None else tb
    if ta.shape != tb.shape:
        raise ValueError(f"output {i} of an `if` on a tensor predicate has shape "
                         f"{tuple(ta.shape)} in the true branch and {tuple(tb.shape)} in the "
                         "false one: both branches run inside a compiled step, and their "
                         "outputs must have one shape")
    dtype = torch.promote_types(ta.dtype, tb.dtype)
    out = torch.where(p, ta.to(dtype), tb.to(dtype))
    return wrap(out) if isinstance(a, Tensor) or isinstance(b, Tensor) else out


def convert_ifelse(pred, true_fn, false_fn, args=()):
    """ifelse_transformer target: branch on a predicate.

    ``args`` are the branch-local carries (names the branches modify),
    passed as parameters so self-referential updates like ``s = s + x``
    read the pre-branch value instead of an unbound closure local. Under a
    tensor predicate inside a compiled step both branches run and the
    outputs are selected on the device (see the module's docstring)."""
    if not _traced(pred):
        return true_fn(*args) if _host_bool(pred, "if") else false_fn(*args)
    p = torch.Tensor.detach(pred).reshape(()).to(torch.bool)
    watched = _watched(args, (true_fn, false_fn))
    t_out = _run_branch(true_fn, args, watched, "true")
    f_out = _run_branch(false_fn, args, watched, "false")
    t_leaves, t_spec = _flatten(t_out)
    f_leaves, f_spec = _flatten(f_out)
    if t_spec != f_spec:
        raise TypeError("the branches of an `if` on a tensor predicate give outputs of "
                        f"different structures ({t_spec} and {f_spec}): both branches run "
                        "inside a compiled step, and their outputs are selected one by one")
    return _unflatten(t_spec, [_select(p, a, b, i)
                               for i, (a, b) in enumerate(zip(t_leaves, f_leaves))])


def convert_while_loop(cond_fn, body_fn, loop_vars):
    """loop_transformer target: a while loop that reads its condition once
    an iteration, on the host when it is a tensor (inside a compiled step a
    sanctioned read, which leaves the signature uncaptured). A name the
    body binds that was unbound before the loop (:data:`UNDEF`) binds on
    the first iteration."""
    vars_ = tuple(loop_vars)
    while _host_bool(cond_fn(*vars_), "while"):
        out = body_fn(*vars_)
        vars_ = tuple(out) if isinstance(out, tuple) else (out,)
    return vars_ if len(vars_) > 1 else vars_[0]


def _as_bool(v, other):
    """``v`` as a bool tensor beside ``other``; a number by a fill on the
    device, not a copy from the host."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.bool)
    device = other.device if isinstance(other, torch.Tensor) else None
    if np.size(v) == 1:
        return torch.full((), bool(np.asarray(v)), dtype=torch.bool, device=device)
    return torch.as_tensor(np.asarray(v), device=device).to(torch.bool)


def convert_logical_and(x_fn, y_fn):
    x = x_fn()
    if not _traced(x):
        if _is_array(x) and np.size(x) == 1:
            if not _host_bool(x, "and"):
                return x  # python short-circuit semantics
            return y_fn()
        if not _is_array(x):
            return x and y_fn()
    y = y_fn()
    return wrap(torch.logical_and(_as_bool(x, y), _as_bool(y, x)))


def convert_logical_or(x_fn, y_fn):
    x = x_fn()
    if not _traced(x):
        if _is_array(x) and np.size(x) == 1:
            if _host_bool(x, "or"):
                return x
            return y_fn()
        if not _is_array(x):
            return x or y_fn()
    y = y_fn()
    return wrap(torch.logical_or(_as_bool(x, y), _as_bool(y, x)))


def convert_logical_not(x):
    if not _traced(x) and not _is_array(x):
        return not x
    return wrap(torch.logical_not(_as_bool(x, x)))


def _host_value(v):
    """``v`` as numpy when it is a tensor (bf16 read as float32)."""
    t = torch.Tensor.detach(v)
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def convert_print(*args, **kwargs):
    """print_transformer target. A print of tensors inside a compiled step
    prints their values at run time (a sanctioned host read, which leaves
    the signature uncaptured), formatted as ``jax.debug.print`` formats
    arrays; any other print is Python's."""
    if any(_traced(a) for a in args):
        from .runtime.compiled import host_read

        host_read("print")
        args = [_host_value(a) if isinstance(a, torch.Tensor) else a for a in args]
    print(*args, **kwargs)


def convert_assert(cond, msg=None):
    """assert_transformer target: an assert of a tensor inside a compiled
    step is checked at run time (a sanctioned host read, which leaves the
    signature uncaptured) and raises ``AssertionError`` when false; any
    other assert is Python's."""
    if not _traced(cond):
        if not _host_bool(cond, "assert"):
            raise AssertionError(msg if msg is not None else "assert failed")
        return
    if not _host_bool(torch.Tensor.detach(cond).reshape(()), "assert"):
        raise AssertionError(msg if msg is not None else "Assert failed inside compiled function")


_CAST_DTYPES = {"int": torch.int64, "float": torch.float32, "bool": torch.bool}


def convert_cast(ty, x):
    """cast_transformer target: ``int(x)``/``float(x)``/``bool(x)`` of a
    tensor inside a compiled step become dtype casts on the device, and
    ``len(x)`` of anything with a shape reads its first dimension; Python
    builtins otherwise."""
    if ty == "len":
        if hasattr(x, "shape") and getattr(x, "ndim", 0) >= 1:
            return x.shape[0]
        return len(x)
    if _traced(x):
        return wrap(x.to(_CAST_DTYPES[ty]))
    return {"int": int, "float": float, "bool": bool}[ty](x)


# ---------------------------------------------------------------------------
# AST transformer (ifelse_transformer.py / loop_transformer.py)
# ---------------------------------------------------------------------------


def _assign_const(name, value):
    return ast.Assign(targets=[ast.Name(id=name, ctx=ast.Store())],
                      value=ast.Constant(value))


def _flag_guard(flags, body):
    """``if not (f1 or f2): body`` — skip-the-rest guard shared by the
    return and break/continue transformers."""
    test = ast.Name(id=flags[0], ctx=ast.Load())
    if len(flags) > 1:
        test = ast.BoolOp(
            op=ast.Or(),
            values=[ast.Name(id=f, ctx=ast.Load()) for f in flags],
        )
    return ast.If(
        test=ast.UnaryOp(op=ast.Not(), operand=test),
        body=body or [ast.Pass()], orelse=[],
    )


def _scan_bc(stmts):
    """(has_break, has_continue) bound to the CURRENT loop: descends ifs
    and with/try blocks but not nested loops or function scopes."""
    has_b = has_c = False
    for s in stmts:
        if isinstance(s, ast.Break):
            has_b = True
        elif isinstance(s, ast.Continue):
            has_c = True
        elif isinstance(s, ast.If):
            for blk in (s.body, s.orelse):
                b, c = _scan_bc(blk)
                has_b |= b
                has_c |= c
        elif isinstance(s, ast.With):
            b, c = _scan_bc(s.body)
            has_b |= b
            has_c |= c
        elif isinstance(s, ast.Try):
            for blk in [s.body, s.orelse, s.finalbody] + [h.body for h in s.handlers]:
                b, c = _scan_bc(blk)
                has_b |= b
                has_c |= c
    return has_b, has_c


def _bc_only_under_ifs(stmts):
    """True when every current-loop break/continue sits under plain
    if/else nesting (the supported shape); with/try wrapping keeps python
    semantics."""
    for s in stmts:
        if isinstance(s, (ast.With, ast.Try)):
            blks = [getattr(s, "body", [])]
            if isinstance(s, ast.Try):
                blks += [s.orelse, s.finalbody] + [h.body for h in s.handlers]
            if any(any(_scan_bc(b)) for b in blks):
                return False
        elif isinstance(s, ast.If):
            if not (_bc_only_under_ifs(s.body) and _bc_only_under_ifs(s.orelse)):
                return False
    return True


def _is_range_for(node):
    return (
        isinstance(node.target, ast.Name)
        and isinstance(node.iter, ast.Call)
        and isinstance(node.iter.func, ast.Name)
        and node.iter.func.id == "range"
        and not node.iter.keywords
        and 1 <= len(node.iter.args) <= 3
    )


def _range_for_to_while(node, uid):
    """Desugar ``for i in range(...)`` to the explicit while form (the
    loop_transformer.py for→while lowering), shared by the break/continue
    and control-flow phases so both see identical loop-variable semantics.
    Returns (prelude_stmts, while_node) or None when the step is
    dynamic/negative (python semantics kept)."""
    args = node.iter.args
    start = args[0] if len(args) >= 2 else ast.Constant(0)
    stop = args[1] if len(args) >= 2 else args[0]
    step = args[2] if len(args) == 3 else ast.Constant(1)
    if len(args) == 3 and not (
        isinstance(step, ast.Constant) and isinstance(step.value, int)
        and step.value > 0
    ):
        return None
    it = f"_pt_for_{uid}"
    stop_name = f"_pt_stop_{uid}"
    init = ast.Assign(targets=[ast.Name(id=it, ctx=ast.Store())],
                      value=start)
    # snapshot the bound: python evaluates range() args exactly once, so a
    # body that mutates the bound variable must not change the trip count
    init_stop = ast.Assign(
        targets=[ast.Name(id=stop_name, ctx=ast.Store())], value=stop
    )
    # pre-bind the loop target ONLY if currently unbound (an empty range
    # must not clobber a prior value) — it then is a well-defined loop
    # carry
    pre_bind = ast.Try(
        body=[ast.Assign(
            targets=[ast.Name(id=node.target.id, ctx=ast.Store())],
            value=ast.Name(id=node.target.id, ctx=ast.Load()),
        )],
        handlers=[ast.ExceptHandler(
            type=ast.Name(id="NameError", ctx=ast.Load()), name=None,
            body=[ast.Assign(
                targets=[ast.Name(id=node.target.id, ctx=ast.Store())],
                value=ast.Name(id=it, ctx=ast.Load()),
            )],
        )],
        orelse=[], finalbody=[],
    )
    test = ast.Compare(
        left=ast.Name(id=it, ctx=ast.Load()), ops=[ast.Lt()],
        comparators=[ast.Name(id=stop_name, ctx=ast.Load())],
    )
    bind = ast.Assign(
        targets=[node.target], value=ast.Name(id=it, ctx=ast.Load())
    )
    # `it = it + step`, not `it += step`: on a tensor `+=` writes in place,
    # which an `if` on a tensor predicate that guards the bump refuses
    bump = ast.Assign(
        targets=[ast.Name(id=it, ctx=ast.Store())],
        value=ast.BinOp(left=ast.Name(id=it, ctx=ast.Load()), op=ast.Add(), right=step),
    )
    loop = ast.While(test=test, body=[bind] + node.body + [bump], orelse=[])
    return [init, init_stop, pre_bind], loop


class _ReturnTransformer(ast.NodeTransformer):
    """Early/mid-function returns (return_transformer.py): every
    ``return e`` becomes ``retv = e; retf = True`` (plus ``break`` when
    inside a loop), statements after a maybe-returning construct are
    guarded by ``if not retf``, and the function ends with a single
    ``return retv`` — so conditionals on tensors can merge return paths."""

    _counter = [0]

    def visit_FunctionDef(self, node):
        self.generic_visit(node)  # nested defs get their own flags first
        rets = [
            s for stmt in node.body for s in _walk_same_scope(stmt)
            if isinstance(s, ast.Return)
        ]
        if not rets or (len(rets) == 1 and node.body[-1] is rets[0]):
            return node
        self._counter[0] += 1
        uid = self._counter[0]
        flag, val = f"_pt_retf_{uid}", f"_pt_retv_{uid}"
        new_body, _ = self._rewrite(list(node.body), flag, val, in_loop=False)
        node.body = (
            [_assign_const(flag, False), _assign_const(val, None)]
            + new_body
            + [ast.Return(value=ast.Name(id=val, ctx=ast.Load()))]
        )
        ast.fix_missing_locations(node)
        return node

    @staticmethod
    def _contains_return(stmt):
        return any(isinstance(s, ast.Return) for s in _walk_same_scope(stmt))

    def _rewrite(self, stmts, flag, val, in_loop):
        out = []
        for i, s in enumerate(stmts):
            rest = stmts[i + 1:]
            if isinstance(s, ast.Return):
                out.append(ast.Assign(
                    targets=[ast.Name(id=val, ctx=ast.Store())],
                    value=s.value or ast.Constant(None),
                ))
                out.append(_assign_const(flag, True))
                if in_loop:
                    out.append(ast.Break())
                return out, True  # statements after a return are dead
            if isinstance(s, ast.If) and self._contains_return(s):
                s.body = self._rewrite(s.body, flag, val, in_loop)[0] or [ast.Pass()]
                s.orelse = self._rewrite(s.orelse, flag, val, in_loop)[0]
                out.append(s)
                if rest:
                    out.append(_flag_guard(
                        [flag], self._rewrite(rest, flag, val, in_loop)[0]
                    ))
                return out, True
            if isinstance(s, (ast.While, ast.For)) and self._contains_return(s):
                s.body = self._rewrite(s.body, flag, val, in_loop=True)[0]
                out.append(s)
                if in_loop:
                    # the return exited the INNER loop via break; the
                    # enclosing loop must stop too, or later outer
                    # iterations would overwrite the return value
                    out.append(ast.If(
                        test=ast.Name(id=flag, ctx=ast.Load()),
                        body=[ast.Break()], orelse=[],
                    ))
                if rest:
                    out.append(_flag_guard(
                        [flag], self._rewrite(rest, flag, val, in_loop)[0]
                    ))
                return out, True
            out.append(s)
        return out, False


class _BreakContinueTransformer(ast.NodeTransformer):
    """break/continue desugaring (break_continue_transformer.py):
    ``break`` sets a flag that both guards the rest of the iteration and
    joins the loop condition; ``continue`` sets a per-iteration flag that
    guards the rest of the iteration. The flag form contains no
    break/continue, so the control-flow transformer can lower the loop to
    convert_while_loop."""

    _counter = [0]

    def visit_While(self, node):
        self.generic_visit(node)  # inner loops first
        has_b, has_c = _scan_bc(node.body)
        if not (has_b or has_c) or node.orelse:
            return node
        if not _bc_only_under_ifs(node.body):
            return node  # with/try-wrapped: keep python semantics
        self._counter[0] += 1
        uid = self._counter[0]
        brk = f"_pt_brk_{uid}" if has_b else None
        cnt = f"_pt_cnt_{uid}" if has_c else None
        new_body = self._rewrite(list(node.body), brk, cnt)
        prelude = []
        if cnt:
            new_body = [_assign_const(cnt, False)] + new_body
            # pre-loop binding so the flag is a well-formed loop carry
            prelude.append(_assign_const(cnt, False))
        if brk:
            prelude.append(_assign_const(brk, False))
            node.test = ast.BoolOp(op=ast.And(), values=[
                ast.UnaryOp(op=ast.Not(),
                            operand=ast.Name(id=brk, ctx=ast.Load())),
                node.test,
            ])
        node.body = new_body
        out = prelude + [node]
        for x in out:
            ast.copy_location(x, node)
            ast.fix_missing_locations(x)
        return out

    def visit_For(self, node):
        self.generic_visit(node)
        has_b, has_c = _scan_bc(node.body)
        if not (has_b or has_c) or node.orelse:
            return node
        # only the range() form lowers further (the control-flow phase's
        # visit_For); anything else keeps python break/continue semantics
        # (incl. generators, which must not be exhausted past the break)
        if not _is_range_for(node):
            return node
        if not _bc_only_under_ifs(node.body):
            return node
        # two-phase: rewrite CONTINUE first, inside the for body only, so
        # the loop-variable bump added by the while desugar is NOT skipped
        # (python's continue still advances the iterator); then desugar to
        # the shared while form and let visit_While rewrite BREAK, which
        # must guard the bump (python's break leaves the loop variable at
        # its break-time value — `for i in range(10): if i == 3: break`
        # ends with i == 3, not 9)
        a = node.iter.args
        if len(a) == 3 and not (
            isinstance(a[2], ast.Constant) and isinstance(a[2].value, int)
            and a[2].value > 0
        ):
            return node  # dynamic/negative step: python semantics (checked
            # BEFORE any rewrite so a bail leaves the body untouched)
        prelude = []
        if has_c:
            self._counter[0] += 1
            cnt = f"_pt_cnt_bc{self._counter[0]}"
            body_c = self._rewrite(list(node.body), None, cnt)
            node.body = [_assign_const(cnt, False)] + body_c
            prelude.append(_assign_const(cnt, False))  # the carry's init
        self._counter[0] += 1
        for_prelude, loop = _range_for_to_while(node, f"bc{self._counter[0]}")
        prelude = for_prelude + prelude
        res = self.visit_While(loop) if has_b else loop
        res = res if isinstance(res, list) else [res]
        out = prelude + res
        for x in out:
            ast.copy_location(x, node)
            ast.fix_missing_locations(x)
        return out

    def _rewrite(self, stmts, brk, cnt):
        """Flag-selective pass: a None flag leaves that statement kind in
        place for a later pass (visit_For rewrites continue before the
        for→while desugar so the loop-variable bump stays un-guarded, then
        visit_While rewrites break so the bump IS guarded)."""
        flags = [f for f in (brk, cnt) if f]
        out = []
        for i, s in enumerate(stmts):
            rest = stmts[i + 1:]
            if isinstance(s, ast.Break):
                if brk is None:
                    out.append(s)
                    continue
                out.append(_assign_const(brk, True))
                return out
            if isinstance(s, ast.Continue):
                if cnt is None:
                    out.append(s)
                    continue
                out.append(_assign_const(cnt, True))
                return out
            if isinstance(s, ast.If):
                hb, hc = _scan_bc([s])
                if (hb and brk) or (hc and cnt):
                    s.body = self._rewrite(s.body, brk, cnt) or [ast.Pass()]
                    s.orelse = self._rewrite(s.orelse, brk, cnt)
                    out.append(s)
                    if rest:
                        out.append(_flag_guard(
                            flags, self._rewrite(rest, brk, cnt)
                        ))
                    return out
            out.append(s)
        return out


def _walk_same_scope(node):
    """ast.walk that does NOT descend into nested function/class scopes
    (their locals are not this scope's assignments) — including when the
    root itself is one (a nested def appearing as a body statement)."""
    yield node
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.Lambda, ast.ClassDef)):
        return
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            continue
        yield from _walk_same_scope(child)


def _assigned_names(nodes):
    """Names bound by assignment/augassign within nodes (current scope)."""
    out = []
    for node in nodes:
        for sub in _walk_same_scope(node):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    out.extend(_target_names(t))
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                out.extend(_target_names(sub.target))
    seen = []
    for n in out:
        if n not in seen:
            seen.append(n)
    return seen


def _prelude(names):
    """`try: n = n / except NameError: n = _pt_jst.UNDEF` per name — the
    UndefinedVar seeding (variable_trans_func.py) so branch/loop closures
    can always read and return every merged name."""
    stmts = []
    for n in names:
        stmts.append(ast.Try(
            body=[ast.Assign(
                targets=[ast.Name(id=n, ctx=ast.Store())],
                value=ast.Name(id=n, ctx=ast.Load()),
            )],
            handlers=[ast.ExceptHandler(
                type=ast.Name(id="NameError", ctx=ast.Load()),
                name=None,
                body=[ast.Assign(
                    targets=[ast.Name(id=n, ctx=ast.Store())],
                    value=ast.Attribute(
                        value=ast.Name(id="_pt_jst", ctx=ast.Load()),
                        attr="UNDEF", ctx=ast.Load(),
                    ),
                )],
            )],
            orelse=[], finalbody=[],
        ))
    return stmts


def _target_names(t):
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        out = []
        for e in t.elts:
            out.extend(_target_names(e))
        return out
    return []


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self._n = 0

    def _uid(self):
        self._n += 1
        return self._n

    # -- if/else ------------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        uid = self._uid()

        def ends_in_return(body):
            return bool(body) and isinstance(body[-1], ast.Return)

        has_return = any(
            isinstance(s, ast.Return)
            for b in (node.body, node.orelse) for stmt in b
            for s in _walk_same_scope(stmt)
        )
        if has_return:
            # supported: both branches ARE a single return (the common
            # `if c: return a` / `else: return b` tail); otherwise leave
            # untouched (plain python — a tensor predicate inside a
            # compiled step then reads the host, which refuses)
            if (
                len(node.body) == 1 and ends_in_return(node.body)
                and len(node.orelse) == 1 and ends_in_return(node.orelse)
            ):
                t = ast.Lambda(
                    args=_no_args(), body=node.body[0].value or
                    ast.Constant(None),
                )
                f = ast.Lambda(
                    args=_no_args(), body=node.orelse[0].value or
                    ast.Constant(None),
                )
                call = _call("convert_ifelse", [node.test, t, f])
                return ast.copy_location(ast.Return(value=call), node)
            return node

        modified = _assigned_names(node.body + node.orelse)
        if not modified:
            return node  # side-effect-only branches: left as Python

        tname, fname = f"_pt_true_{uid}", f"_pt_false_{uid}"
        ret = ast.Return(
            value=ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Load()) for n in modified],
                ctx=ast.Load(),
            ) if len(modified) > 1 else ast.Name(id=modified[0],
                                                ctx=ast.Load())
        )
        # the modified names come in as PARAMETERS (seeded from the outer
        # scope) so branch bodies can read-then-write them
        branch_args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in modified],
            kwonlyargs=[], kw_defaults=[], defaults=[],
        )
        t_def = ast.FunctionDef(
            name=tname, args=branch_args,
            body=(node.body or [ast.Pass()]) + [ret],
            decorator_list=[], type_params=[],
        )
        f_def = ast.FunctionDef(
            name=fname, args=ast.arguments(
                posonlyargs=[], args=[ast.arg(arg=n) for n in modified],
                kwonlyargs=[], kw_defaults=[], defaults=[],
            ),
            body=(node.orelse or [ast.Pass()]) + [ret],
            decorator_list=[], type_params=[],
        )
        assign = ast.Assign(
            targets=[
                ast.Tuple(
                    elts=[ast.Name(id=n, ctx=ast.Store()) for n in modified],
                    ctx=ast.Store(),
                ) if len(modified) > 1 else ast.Name(id=modified[0],
                                                     ctx=ast.Store())
            ],
            value=_call(
                "convert_ifelse",
                [node.test, ast.Name(id=tname, ctx=ast.Load()),
                 ast.Name(id=fname, ctx=ast.Load()),
                 ast.Tuple(
                     elts=[ast.Name(id=n, ctx=ast.Load()) for n in modified],
                     ctx=ast.Load(),
                 )],
            ),
        )
        return [
            ast.copy_location(x, node)
            for x in _prelude(modified) + [t_def, f_def, assign]
        ]

    # -- while --------------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        # same-scope walk: the branch closures generated by visit_If contain
        # `return` statements that belong to THEIR scope, not the loop's
        if node.orelse or any(
            isinstance(s, (ast.Break, ast.Continue, ast.Return))
            for stmt in node.body for s in _walk_same_scope(stmt)
        ):
            return node  # unsupported: keep python semantics
        uid = self._uid()
        # the carry is EVERY name the body assigns — a write-only var's
        # final value must survive the loop for post-loop readers
        carry = _assigned_names(node.body)
        if not carry:
            return node

        args = ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=n) for n in carry],
            kwonlyargs=[], kw_defaults=[], defaults=[],
        )
        cname, bname = f"_pt_wcond_{uid}", f"_pt_wbody_{uid}"
        c_def = ast.FunctionDef(
            name=cname, args=args,
            body=[ast.Return(value=node.test)], decorator_list=[],
            type_params=[],
        )
        ret = ast.Return(
            value=ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Load()) for n in carry],
                ctx=ast.Load(),
            )
        )
        b_def = ast.FunctionDef(
            name=bname, args=args, body=node.body + [ret],
            decorator_list=[], type_params=[],
        )
        assign = ast.Assign(
            targets=[
                ast.Tuple(
                    elts=[ast.Name(id=n, ctx=ast.Store()) for n in carry],
                    ctx=ast.Store(),
                ) if len(carry) > 1 else ast.Name(id=carry[0],
                                                 ctx=ast.Store())
            ],
            value=_call(
                "convert_while_loop",
                [ast.Name(id=cname, ctx=ast.Load()),
                 ast.Name(id=bname, ctx=ast.Load()),
                 ast.Tuple(
                     elts=[ast.Name(id=n, ctx=ast.Load()) for n in carry],
                     ctx=ast.Load(),
                 )],
            ),
        )
        return [
            ast.copy_location(x, node)
            for x in _prelude(carry) + [c_def, b_def, assign]
        ]

    # -- for over range -----------------------------------------------------
    def visit_For(self, node):
        """``for i in range(...)`` desugars to the while form, which then
        lowers through visit_While (loop_transformer.py's for→while). The
        desugaring itself is shared with the break/continue phase
        (_range_for_to_while) so both phases agree on loop-variable
        semantics."""
        self.generic_visit(node)
        if (
            node.orelse
            or not _is_range_for(node)
            or any(
                isinstance(s, (ast.Break, ast.Continue, ast.Return))
                for stmt in node.body for s in _walk_same_scope(stmt)
            )
        ):
            return node
        uid = self._uid()
        lowered = _range_for_to_while(node, str(uid))
        if lowered is None:
            return node  # negative/dynamic step: keep python semantics
        prelude, loop = lowered
        res = self.visit_While(loop)
        res = res if isinstance(res, list) else [res]
        return [ast.copy_location(x, node) for x in prelude + res]

    # -- print / assert / casts ---------------------------------------------
    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Name):
            if node.func.id == "print":
                return ast.copy_location(ast.Call(
                    func=ast.Attribute(
                        value=ast.Name(id="_pt_jst", ctx=ast.Load()),
                        attr="convert_print", ctx=ast.Load(),
                    ),
                    args=node.args, keywords=node.keywords,
                ), node)
            if (
                node.func.id in ("int", "float", "bool", "len")
                and len(node.args) == 1 and not node.keywords
                and not isinstance(node.args[0], ast.Starred)
            ):
                return ast.copy_location(
                    _call("convert_cast",
                          [ast.Constant(node.func.id), node.args[0]]),
                    node,
                )
        return node

    def visit_Assert(self, node):
        self.generic_visit(node)
        args = [node.test] + ([node.msg] if node.msg is not None else [])
        return ast.copy_location(
            ast.Expr(value=_call("convert_assert", args)), node
        )

    # -- and/or/not ---------------------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = ("convert_logical_and" if isinstance(node.op, ast.And)
              else "convert_logical_or")
        out = node.values[-1]
        for v in reversed(node.values[:-1]):
            out = _call(
                fn,
                [ast.Lambda(args=_no_args(), body=v),
                 ast.Lambda(args=_no_args(), body=out)],
            )
        return ast.copy_location(out, node)

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.copy_location(
                _call("convert_logical_not", [node.operand]), node
            )
        return node


def _call(name, args):
    return ast.Call(
        func=ast.Attribute(
            value=ast.Name(id="_pt_jst", ctx=ast.Load()),
            attr=name, ctx=ast.Load(),
        ),
        args=args, keywords=[],
    )


def _no_args():
    return ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                         kw_defaults=[], defaults=[])


class _ExplicitSuper(ast.NodeTransformer):
    """``super()`` -> ``super(__class__, <self>)``."""

    def __init__(self, self_name):
        self.self_name = self_name

    def visit_Call(self, node):
        self.generic_visit(node)
        if (isinstance(node.func, ast.Name) and node.func.id == "super" and not node.args
                and not node.keywords):
            node.args = [ast.Name(id="__class__", ctx=ast.Load()),
                         ast.Name(id=self.self_name, ctx=ast.Load())]
        return node


def convert_to_static(fn):
    """Rewrite ``fn``'s control flow (program_translator.py's role).

    Returns the transformed function, or ``fn`` unchanged when its source
    is unavailable or is not a function definition. Names the original
    reads from enclosing scopes become globals of the rebuilt function,
    with the values they hold now (a snapshot); a method's zero-argument
    ``super()`` keeps its class."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError):
        return fn
    fdef = tree.body[0] if tree.body else None
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn  # a lambda, or a source that does not start at a def
    fdef.decorator_list = []  # the decorator would recurse
    # phase order matters: returns become flag+break first, then
    # break/continue become flag+guard form, then control flow lowers to
    # the runtime converters
    tree = _ReturnTransformer().visit(tree)
    tree = _BreakContinueTransformer().visit(tree)
    new = _ControlFlowTransformer().visit(tree)
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__ or ()))
    if "__class__" in cells:
        # zero-argument super(): rebuilt outside its class, the def takes
        # its __class__ cell from an enclosing function's parameter, and
        # each super() names the method's own first argument (inside a
        # branch function it would take the branch's first argument)
        if fdef.args.args:
            _ExplicitSuper(fdef.args.args[0].arg).visit(new)
        new.body = [ast.FunctionDef(
            name="_pt_with_class",
            args=ast.arguments(posonlyargs=[], args=[ast.arg(arg="__class__")],
                               kwonlyargs=[], kw_defaults=[], defaults=[]),
            body=new.body + [ast.Return(value=ast.Name(id=fdef.name, ctx=ast.Load()))],
            decorator_list=[], type_params=[])]
    ast.fix_missing_locations(new)
    try:
        code = compile(new, f"<dygraph_to_static:{fn.__qualname__}>", "exec")
    except SyntaxError:
        return fn
    glb = dict(fn.__globals__)
    glb["_pt_jst"] = sys.modules[__name__]
    for name, cell in cells.items():
        try:
            glb[name] = cell.cell_contents
        except ValueError:
            pass  # an empty cell (a recursive self-reference)
    loc = {}
    exec(code, glb, loc)  # noqa: S102 - an AST built here from fn's own source
    transformed = (loc["_pt_with_class"](cells["__class__"].cell_contents)
                   if "__class__" in cells else loc[fdef.name])
    functools.update_wrapper(transformed, fn)
    transformed.__wrapped_original__ = fn
    return transformed
