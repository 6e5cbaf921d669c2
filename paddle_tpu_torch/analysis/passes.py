"""The verifier passes, registered into ``analysis.verifier``'s framework (``paddle_tpu/analysis/passes.py``).

Run order matters: ``block-structure`` gates everything (walking broken
block links is meaningless), then ``def-before-use``, ``write-conflicts``,
``dtype-consistency``, and finally the advisory ``dead-code`` pass.

Executor-semantics notes the passes encode (``static/executor.py``):
- an op input resolves from, in order: a prior op's output in the same
  walk, the run's feed dict, a declared data var, a persistable var (the
  startup-scope promise), or a captured eager constant;
- sub-blocks run on a COPY of the enclosing env plus the formal names the
  parent control-flow op's attrs declare, so outer names are visible
  inside and sub-block writes (except threaded persistables) die with it;
- output lists may contain "" placeholders (grad ops) — never names;
- an op may write a var it also reads ONLY by declaring it in the
  ``__inplace__`` attr (optimizer updates, batch_norm's aliased running
  stats); undeclared read-write aliasing is exactly the conflict the
  executor's env overwrite would silently last-win.
"""
from __future__ import annotations

from .verifier import (
    all_in_names,
    all_out_names,
    op_in_names,
    op_out_names,
    register_pass,
)

_BLOCK_OPS = ("while", "cond", "scan")

# attr key -> is the value a list of names (else a single name)
_NAME_LIST_ATTRS = (
    "__cond_formals__", "__body_formals__", "__body_outs__",
    "__carry_formals__", "__seq_formals__", "__carry_outs__", "__y_outs__",
    "__true_outs__", "__false_outs__", "__inplace__",
)
_NAME_ATTRS = ("__cond_out__",)

# which sub-blocks + formal lists each control-flow op type declares
_SUBBLOCK_SPEC = {
    "while": (
        ("__cond_block__", ("__cond_formals__",)),
        ("__body_block__", ("__body_formals__",)),
    ),
    "cond": (
        ("__true_block__", ()),
        ("__false_block__", ()),
    ),
    "scan": (
        ("__body_block__", ("__carry_formals__", "__seq_formals__")),
    ),
}

_REQUIRED_ATTRS = {
    "while": ("__cond_block__", "__body_block__", "__cond_formals__",
              "__body_formals__", "__cond_out__", "__body_outs__",
              "__n_loop__"),
    "cond": ("__true_block__", "__false_block__", "__true_outs__",
             "__false_outs__"),
    "scan": ("__body_block__", "__carry_formals__", "__seq_formals__",
             "__carry_outs__", "__y_outs__", "__n_carry__", "__n_seq__"),
}


def _attr_names(op):
    """Every var name an op references through its control/alias attrs."""
    names = []
    for key in _NAME_LIST_ATTRS:
        v = op.attrs.get(key)
        if v:
            names.extend(n for n in v if n)
    for key in _NAME_ATTRS:
        v = op.attrs.get(key)
        if v:
            names.append(v)
    return names


def _parent_chain(program, block_idx):
    """Block indices from ``block_idx`` up to the root (cycle-safe)."""
    chain, seen = [], set()
    idx = block_idx
    while 0 <= idx < len(program.blocks) and idx not in seen:
        chain.append(idx)
        seen.add(idx)
        idx = program.blocks[idx].parent_idx
    return chain


# ---------------------------------------------------------------------------
# 1. block-structure: parent links, sub-block attrs, formal declarations
# ---------------------------------------------------------------------------

@register_pass("block-structure")
def _block_structure(ctx):
    program = ctx.program
    n_blocks = len(program.blocks)
    if n_blocks == 0:
        ctx.error("block-structure", "program has no blocks")
        return
    for pos, blk in enumerate(program.blocks):
        if blk.idx != pos:
            ctx.error("block-structure",
                      f"block at position {pos} carries idx {blk.idx}",
                      block_idx=pos)
        if pos == 0:
            if blk.parent_idx != -1:
                ctx.error("block-structure",
                          f"global block declares parent {blk.parent_idx} "
                          "(must be -1)", block_idx=0)
            continue
        if not (0 <= blk.parent_idx < n_blocks) or blk.parent_idx == pos:
            ctx.error("block-structure",
                      f"block {pos} has invalid parent_idx "
                      f"{blk.parent_idx}", block_idx=pos)
            continue
        chain = _parent_chain(program, pos)
        if chain[-1] != 0:
            ctx.error("block-structure",
                      f"block {pos}'s parent chain {chain} never reaches "
                      "the global block (cycle or dangling link)",
                      block_idx=pos)

    for blk in program.blocks:
        for i, op in enumerate(blk.ops):
            if op.type not in _BLOCK_OPS:
                continue
            missing = [a for a in _REQUIRED_ATTRS[op.type]
                       if a not in op.attrs]
            if missing:
                ctx.error("block-structure",
                          f"{op.type} op is missing control attrs "
                          f"{missing}", block_idx=blk.idx, op_index=i,
                          op_type=op.type)
                continue
            for bkey, fkeys in _SUBBLOCK_SPEC[op.type]:
                bidx = op.attrs[bkey]
                if not isinstance(bidx, int) or not (0 < bidx < n_blocks):
                    ctx.error("block-structure",
                              f"{bkey}={bidx!r} does not name a sub-block "
                              f"of this program ({n_blocks} blocks)",
                              block_idx=blk.idx, op_index=i,
                              op_type=op.type)
                    continue
                sub = program.blocks[bidx]
                if blk.idx not in _parent_chain(program, bidx):
                    ctx.error("block-structure",
                              f"sub-block {bidx}'s parent chain does not "
                              f"include block {blk.idx}; vars captured "
                              "across the block boundary cannot resolve",
                              block_idx=blk.idx, op_index=i,
                              op_type=op.type)
                for fkey in fkeys:
                    for formal in op.attrs.get(fkey, ()):
                        if formal not in sub.vars:
                            ctx.error(
                                "block-structure",
                                f"formal {formal!r} ({fkey}) is not "
                                f"declared in sub-block {bidx}",
                                block_idx=blk.idx, op_index=i,
                                op_type=op.type, var=formal)
            _check_block_op_arity(ctx, blk, i, op)


def _check_block_op_arity(ctx, blk, i, op):
    outs = [n for n in op_out_names(op) if n]
    if op.type == "while":
        n_loop = op.attrs["__n_loop__"]
        ins = op_in_names(op)
        sizes = {
            "__cond_formals__": len(op.attrs["__cond_formals__"]),
            "__body_formals__": len(op.attrs["__body_formals__"]),
            "__body_outs__": len(op.attrs["__body_outs__"]),
        }
        bad = {k: v for k, v in sizes.items() if v != n_loop}
        if bad or len(ins) < n_loop or len(outs) != n_loop:
            ctx.error("block-structure",
                      f"while op carry arity mismatch: __n_loop__={n_loop} "
                      f"but inputs={len(ins)} outputs={len(outs)} {sizes}",
                      block_idx=blk.idx, op_index=i, op_type=op.type)
    elif op.type == "cond":
        t, f = op.attrs["__true_outs__"], op.attrs["__false_outs__"]
        if len(t) != len(f) or len(outs) != len(t):
            ctx.error("block-structure",
                      f"cond op output arity mismatch: true={len(t)} "
                      f"false={len(f)} declared={len(outs)}",
                      block_idx=blk.idx, op_index=i, op_type=op.type)
    elif op.type == "scan":
        n_c = op.attrs["__n_carry__"]
        n_y = len(op.attrs["__y_outs__"])
        if (len(op.attrs["__carry_outs__"]) != n_c
                or len(op.attrs["__carry_formals__"]) != n_c
                or len(outs) != n_c + n_y):
            ctx.error("block-structure",
                      f"scan op carry/y arity mismatch: __n_carry__={n_c} "
                      f"__y_outs__={n_y} declared outputs={len(outs)}",
                      block_idx=blk.idx, op_index=i, op_type=op.type)


# ---------------------------------------------------------------------------
# 2. def-before-use: every input resolvable at the point its op runs
# ---------------------------------------------------------------------------

@register_pass("def-before-use")
def _def_before_use(ctx):
    program = ctx.program

    def walk(block_idx, defined, visiting):
        if block_idx in visiting:  # structural pass already flagged cycles
            return
        blk = program.blocks[block_idx]
        for i, op in enumerate(blk.ops):
            for n in all_in_names(op):
                if not n:
                    continue
                if n not in defined and not ctx.statically_defined(n):
                    ctx.error(
                        "def-before-use",
                        f"input {n!r} is not produced by any prior op and "
                        "is neither a feed/data var, a persistable "
                        "(startup-scope) var, nor a captured constant",
                        block_idx=blk.idx, op_index=i, op_type=op.type,
                        var=n)
            if op.type in _BLOCK_OPS:
                for bkey, fkeys in _SUBBLOCK_SPEC.get(op.type, ()):
                    bidx = op.attrs.get(bkey)
                    if isinstance(bidx, int) and 0 < bidx < len(program.blocks):
                        formals = [f for k in fkeys
                                   for f in op.attrs.get(k, ())]
                        walk(bidx, defined | set(formals),
                             visiting | {block_idx})
            for n in all_out_names(op):
                if n:
                    defined.add(n)
        return defined

    defined = walk(0, set(), frozenset()) or set()
    for n in ctx.fetch_names:
        if n not in defined and not ctx.statically_defined(n):
            ctx.error("def-before-use",
                      f"fetch target {n!r} is never produced by the "
                      "program (and is not a feed/persistable var)",
                      var=n)


# ---------------------------------------------------------------------------
# 3. write-conflicts: double writes + undeclared in-place aliasing
# ---------------------------------------------------------------------------

@register_pass("write-conflicts")
def _write_conflicts(ctx):
    for blk in ctx.program.blocks:
        writers: dict = {}  # name -> op index of first writer
        for i, op in enumerate(blk.ops):
            ins = set(n for n in all_in_names(op) if n)
            declared = set(op.attrs.get("__inplace__") or ())
            seen_here = set()
            for n in all_out_names(op):
                if not n:
                    continue
                if n in seen_here:
                    ctx.error("write-conflicts",
                              f"op writes {n!r} twice in one output list",
                              block_idx=blk.idx, op_index=i,
                              op_type=op.type, var=n)
                    continue
                seen_here.add(n)
                if n in ins and n not in declared:
                    ctx.error(
                        "write-conflicts",
                        f"op writes {n!r} which it also reads without "
                        "declaring the aliasing (add it to the op's "
                        "__inplace__ attr if the in-place update is "
                        "intended)",
                        block_idx=blk.idx, op_index=i, op_type=op.type,
                        var=n)
                prev = writers.get(n)
                if prev is not None:
                    # a persistable updated in place by every later writer
                    # is a legal sequential state chain; anything else is
                    # a conflict the executor would silently last-win
                    if not (n in ctx.persistables and n in declared):
                        ctx.error(
                            "write-conflicts",
                            f"{n!r} is written by op #{prev} and again by "
                            f"op #{i}; the second write silently wins "
                            "(declare __inplace__ on a persistable state "
                            "chain, or write distinct vars)",
                            block_idx=blk.idx, op_index=i, op_type=op.type,
                            var=n)
                else:
                    writers[n] = i


# ---------------------------------------------------------------------------
# 4. dtype-consistency: declared output dtypes vs the kernel's inference
# ---------------------------------------------------------------------------

_DYN = 83  # op_append.py's dynamic-dim placeholder (prime & recognizable)


@register_pass("dtype-consistency")
def _dtype_consistency(ctx):
    import torch

    from ..framework.dtype import torch_dtype
    from ..ops.registry import _REGISTRY, eval_meta

    for blk in ctx.program.blocks:
        for i, op in enumerate(blk.ops):
            if op.type in _BLOCK_OPS or op.type.startswith("grad::"):
                continue  # run structurally / through autograd, not a kernel
            if op.type == "init_param":
                continue  # startup-program op, run by run_startup
            if op.type not in _REGISTRY:
                ctx.error("dtype-consistency",
                          f"op type {op.type!r} is not in the kernel "
                          "registry; the executor cannot run it",
                          block_idx=blk.idx, op_index=i, op_type=op.type)
                continue
            in_names = op_in_names(op)
            metas = []
            for n in in_names:
                var = ctx.resolve_var(blk, n) if n else None
                if var is None or var.shape is None:
                    metas = None  # unknown operand: inference inconclusive
                    break
                shape = tuple(_DYN if d in (-1, None) else d
                              for d in var.shape)
                metas.append(torch.empty(shape, dtype=torch_dtype(var.dtype),
                                         device="meta"))
            if metas is None:
                continue
            attrs = {k: v for k, v in op.attrs.items()
                     if not k.startswith("__")}
            try:
                out = eval_meta(op.type, metas, attrs)
            except Exception as e:  # inconclusive, not provably wrong
                ctx.warn("dtype-consistency",
                         f"kernel shape/dtype inference failed "
                         f"({type(e).__name__}: {str(e)[:160]}); op left "
                         "unchecked", block_idx=blk.idx, op_index=i,
                         op_type=op.type)
                continue
            out_specs = list(out) if isinstance(out, (tuple, list)) else [out]
            out_names = op_out_names(op)
            if len([n for n in out_names if n]) > len(out_specs):
                ctx.error("dtype-consistency",
                          f"op declares {len(out_names)} outputs but its "
                          f"kernel yields {len(out_specs)}",
                          block_idx=blk.idx, op_index=i, op_type=op.type)
                continue
            for name, spec in zip(out_names, out_specs):
                if not name or spec is None:
                    continue
                var = ctx.resolve_var(blk, name)
                if var is None:
                    continue  # def-before-use territory
                declared = torch_dtype(var.dtype)
                inferred = spec.dtype
                if declared != inferred:
                    ctx.error(
                        "dtype-consistency",
                        f"output {name!r} is declared {_name(declared)} but "
                        f"the {op.type!r} kernel produces {_name(inferred)} "
                        "for these operands",
                        block_idx=blk.idx, op_index=i, op_type=op.type,
                        var=name)


def _name(dtype):
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# 5. dead-code: ops/vars unreachable from fetches + persistable writes
# ---------------------------------------------------------------------------

def _writes_persistables(ctx, block_idx, seen=None):
    """Does the block (or any nested sub-block) write a persistable?"""
    seen = seen or set()
    if block_idx in seen or not (0 <= block_idx < len(ctx.program.blocks)):
        return False
    seen.add(block_idx)
    blk = ctx.program.blocks[block_idx]
    for op in blk.ops:
        if any(n in ctx.persistables for n in all_out_names(op) if n):
            return True
        if op.type in _BLOCK_OPS:
            for bkey, _ in _SUBBLOCK_SPEC.get(op.type, ()):
                bidx = op.attrs.get(bkey)
                if isinstance(bidx, int) and _writes_persistables(
                        ctx, bidx, seen):
                    return True
    return False


@register_pass("dead-code")
def _dead_code(ctx):
    program = ctx.program

    def live_walk(block_idx, roots, visiting):
        """Reverse-walk one block; emit a warning per dead op, recurse
        into live control-flow ops' sub-blocks."""
        blk = program.blocks[block_idx]
        live = set(roots)
        for i in range(len(blk.ops) - 1, -1, -1):
            op = blk.ops[i]
            outs = [n for n in all_out_names(op) if n]
            side_effecting = (
                not outs  # nothing to track: assume effects
                or any(n in ctx.persistables for n in outs)
            )
            if not side_effecting and op.type in _BLOCK_OPS:
                side_effecting = any(
                    _writes_persistables(ctx, op.attrs.get(bkey, -1))
                    for bkey, _ in _SUBBLOCK_SPEC.get(op.type, ()))
            if side_effecting or any(n in live for n in outs):
                live.update(n for n in all_in_names(op) if n)
                live.update(_attr_names(op))
                if op.type in _BLOCK_OPS:
                    for bkey, _ in _SUBBLOCK_SPEC.get(op.type, ()):
                        bidx = op.attrs.get(bkey)
                        if (isinstance(bidx, int)
                                and 0 < bidx < len(program.blocks)
                                and bidx not in visiting):
                            live_walk(bidx, _subblock_roots(op),
                                      visiting | {block_idx})
            else:
                first = outs[0] if outs else None
                ctx.warn(
                    "dead-code",
                    f"op result {outs} is unreachable from the fetch "
                    "targets and writes no persistable state; the op is "
                    "dead weight in the compiled block",
                    block_idx=blk.idx, op_index=i, op_type=op.type,
                    var=first)

    live_walk(0, set(ctx.fetch_names), frozenset())

    # dead vars: declared but referenced by nothing at all
    referenced = set(ctx.fetch_names) | set(ctx.feed_names) | ctx.constants
    for blk in program.blocks:
        for op in blk.ops:
            referenced.update(n for n in all_in_names(op) if n)
            referenced.update(n for n in all_out_names(op) if n)
            referenced.update(_attr_names(op))
    for blk in program.blocks:
        for name, var in blk.vars.items():
            if name in referenced:
                continue
            if getattr(var, "persistable", False) or getattr(var, "is_data", False):
                continue  # loadable / feedable by name at any time
            ctx.warn("dead-code",
                     f"var {name!r} is declared in block {blk.idx} but "
                     "referenced by no op, feed, or fetch",
                     block_idx=blk.idx, var=name)


def _subblock_roots(op):
    roots = []
    for key in ("__body_outs__", "__carry_outs__", "__y_outs__",
                "__true_outs__", "__false_outs__"):
        roots.extend(n for n in op.attrs.get(key, ()) if n)
    if op.attrs.get("__cond_out__"):
        roots.append(op.attrs["__cond_out__"])
    return roots
