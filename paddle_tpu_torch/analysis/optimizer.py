"""Program-IR optimizer: pass manager, fusion rewrites, rematerialization (``paddle_tpu/analysis/optimizer.py``).

The rewrite half over the ``Program``/``Block``/``OpDesc`` IR, ahead of the
executor's interpretation and capture. Three families of passes, all
registered on one ordered registry (the verifier's ``register_pass``
idiom), in the JAX package's order:

- **Fusion**: pattern-match op chains onto the fused registry ops
  (``ops/fused_ops.py``): ``conv2d -> batch_norm -> relu`` becomes
  ``fused_conv_bn_relu`` (the fused conv GEMM kernel,
  ``csrc/conv_bn_relu_mm.cu``), ``elementwise_add -> layer_norm`` over the
  last dim becomes ``fused_layernorm_residual`` (the LayerNorm kernel), and
  a matmul/mul whose operands are ``dequantize_static``-restored int8
  tensors becomes ``matmul_int8``/``mul_int8`` (the int8 kernel). Fusion is
  refused whenever an eliminated intermediate is fetched, read by any
  second consumer (a ``grad::`` op or a sub-block included), written twice,
  or aliased: a training program with no fusible chain comes back
  unchanged.
- **Constant folding and dead-op elimination**: folding needs a ``Scope``
  (load-time weights) and runs ops whose inputs are all statically
  available once, with the real kernels, on the caller's device; DCE
  removes side-effect-free ops whose outputs nothing reads (ops writing
  persistables, declaring ``__inplace__``, carrying sub-blocks or replaying
  ``grad::`` are never touched).
- **Rematerialization** (level >= 2): while the planned peak
  (:func:`~paddle_tpu_torch.analysis.plan_memory`) exceeds the budget
  (:func:`~paddle_tpu_torch.analysis.hbm_budget_bytes`), recompute a cheap
  activation at its late uses instead of holding it across the high-water
  op.

The manager verifies the program before the pipeline and after every pass
that changed it, replans memory per pass, and reports ``ops_rewritten``,
``bytes_saved`` and wall time per pass as :class:`PassStats`, counters
(``profiler`` ``ir_opt::<pass>::*`` and the monitor registry's
``ir_opt/<pass>/*``) and :func:`optimizer_stats`. :func:`optimize_program`
is the cached clone-and-rewrite entry ``Executor.run`` drives behind
``FLAGS_ir_opt_level``: an unchanged program version pays one dict lookup
and gets back the same clone (so the executor's capture signature, which
keys on the program's identity and version, is stable), and a pipeline
that rewrites nothing returns the original program object.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional

from .. import profiler
from .verifier import all_in_names, all_out_names, op_in_names, op_out_names

__all__ = [
    "OptPass", "OptResult", "PassManager", "PassStats",
    "constant_folding", "dead_op_elimination", "fuse_conv_bn_relu",
    "fuse_int8_matmul", "fuse_layernorm_residual", "measure_pass_deltas",
    "optimize_program", "optimizer_passes", "optimizer_stats",
    "register_opt_pass", "rematerialize", "reset_optimizer_stats",
]

_BLOCK_OPS = ("while", "cond", "scan")

#: ops cheap enough to recompute at a late use instead of holding the
#: activation across the high-water op (flops-light, deterministic)
_REMAT_CHEAP_OPS = frozenset({
    "relu", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "layer_norm", "fused_layernorm_residual", "tanh", "sigmoid", "gelu",
    "scale", "cast", "reshape", "transpose",
})

_REMAT_MAX_ROUNDS = 32
_CACHE_LIMIT = 16  # optimized-clone LRU bound per program


class PassStats(NamedTuple):
    """One pass's report: what it rewrote and what that bought."""
    name: str
    ops_rewritten: int
    bytes_saved: int
    wall_ms: float


class OptResult(NamedTuple):
    """:func:`optimize_program` result. ``program`` is the optimized
    clone, or the ORIGINAL object when no pass rewrote anything."""
    program: object
    stats: List[PassStats]
    changed: bool


class OptPass(NamedTuple):
    name: str
    fn: Callable
    min_level: int
    needs_scope: bool


_OPT_PASSES: Dict[str, OptPass] = {}


def register_opt_pass(name: str, min_level: int = 1, needs_scope: bool = False):
    """Decorator: register an optimizer pass ``fn(ctx) -> ops_rewritten``
    (the verifier's ``register_pass`` idiom, ordered by
    registration). ``min_level`` gates it on ``FLAGS_ir_opt_level``;
    ``needs_scope`` passes are skipped unless the caller supplies a
    Scope (the Predictor's load-time pipeline does, ``Executor.run``
    does not: folding a live training scope would freeze weights)."""

    def deco(fn):
        if name in _OPT_PASSES:
            raise ValueError(f"optimizer pass {name!r} registered twice")
        _OPT_PASSES[name] = OptPass(name, fn, min_level, needs_scope)
        return fn

    return deco


def optimizer_passes() -> list:
    """Registered pass names in pipeline order."""
    return list(_OPT_PASSES)


# ---------------------------------------------------------------------------
# pass context + IR helpers
# ---------------------------------------------------------------------------


class OptContext:
    """Per-pipeline state handed to each pass: the (mutable) program,
    run signature, and lazily-rebuilt use/def maps over the IR."""

    def __init__(self, program, feed_names=(), fetch_names=(), scope=None,
                 feed_shapes=None, level=1, device=None):
        self.program = program
        self.device = device  # where folding runs and whose memory remat budgets
        self.feed_names = tuple(feed_names or ())
        self.fetch_names = tuple(
            v if isinstance(v, str) else v.name for v in (fetch_names or ()))
        self.scope = scope
        self.feed_shapes = dict(feed_shapes or {})
        self.level = int(level)

    # -- use/def maps (recomputed per pass: passes mutate the IR) -----------

    def use_counts(self) -> Dict[str, int]:
        """Reads per var name across ALL blocks (sub-block reads of a
        parent var count — fusing it away would break the sub-block)."""
        uses: Dict[str, int] = {}
        for blk in self.program.blocks:
            for op in blk.ops:
                for n in all_in_names(op):
                    if n:
                        uses[n] = uses.get(n, 0) + 1
        return uses

    def writer_counts(self) -> Dict[str, int]:
        writes: Dict[str, int] = {}
        for blk in self.program.blocks:
            for op in blk.ops:
                for n in all_out_names(op):
                    if n:
                        writes[n] = writes.get(n, 0) + 1
        return writes

    def grad_read(self) -> set:
        """Names read by any ``grad::`` op (fusion must not eliminate a
        var the backward replay re-reads)."""
        names = set()
        for blk in self.program.blocks:
            for op in blk.ops:
                if op.type.startswith("grad::"):
                    names.update(n for n in all_in_names(op) if n)
        return names

    def persistables(self) -> set:
        names = set()
        for blk in self.program.blocks:
            for name, var in blk.vars.items():
                if getattr(var, "persistable", False):
                    names.add(name)
        return names

    def bump_version(self):
        p = self.program
        p._version = getattr(p, "_version", 0) + 1


def _var_dtype(block, name):
    try:
        return str(block.var(name).dtype)
    except KeyError:
        return None


def _var_shape(block, name):
    try:
        s = block.var(name).shape
    except KeyError:
        return None
    return None if s is None else tuple(s)


def _single_out(op) -> Optional[str]:
    """The op's sole non-empty output name, or None."""
    outs = [n for n in all_out_names(op) if n]
    return outs[0] if len(outs) == 1 else None


def _writes_between(block, names, lo, hi, skip=()) -> bool:
    """Any op with index in (lo, hi) writing one of ``names``? Fusion
    moves the matched producers down to the chain tail, which is only
    sound if nothing in between redefines their operands. ``skip``
    excludes the chain's own dropped ops from the check."""
    names = set(names)
    for idx in range(lo + 1, hi):
        if idx in skip:
            continue
        if any(n in names for n in all_out_names(block.ops[idx]) if n):
            return True
    return False


class _Chain(NamedTuple):
    """One matched fusion chain: ops to drop, the replacement OpDesc,
    and the index the replacement lands at (the chain tail).
    ``extra_replace`` holds further in-place ``(index, OpDesc)``
    substitutions (the int8 pass's quant-sim -> quantize rewrite)."""
    drop: tuple        # op indices removed from the block
    anchor: int        # index whose op is replaced by ``new_op``
    new_op: object
    new_vars: tuple    # (name, shape, dtype) descs to declare
    extra_replace: tuple = ()


def _apply_chains(ctx, block, chains) -> int:
    """Rewrite non-overlapping matched chains into the block in one
    reconstruction pass. Returns the number of chains applied."""
    if not chains:
        return 0
    claimed: set = set()
    replace: Dict[int, object] = {}
    drop: set = set()
    applied = 0
    for ch in chains:
        span = set(ch.drop) | {ch.anchor} | {i for i, _ in ch.extra_replace}
        if span & claimed:
            continue  # overlapping match: first registration wins
        claimed |= span
        replace[ch.anchor] = ch.new_op
        for idx, op in ch.extra_replace:
            replace[idx] = op
        drop |= set(ch.drop)
        for name, shape, dtype in ch.new_vars:
            if not block.has_var(name):
                block.create_var(name=name,
                                 shape=None if shape is None else list(shape),
                                 dtype=dtype)
        applied += 1
    new_ops = []
    for idx, op in enumerate(block.ops):
        if idx in replace:
            new_ops.append(replace[idx])
        elif idx not in drop:
            new_ops.append(op)
    block.ops[:] = new_ops
    ctx.bump_version()
    return applied


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


# ---------------------------------------------------------------------------
# fusion passes
# ---------------------------------------------------------------------------


def _fusible(ctx, name, uses, writes, grad_read, persist) -> bool:
    """May ``name`` be eliminated as a fused-chain intermediate? Refused
    when it is fetched, read by more than its one chain consumer, read
    by a ``grad::`` replay, persistable, or written more than once."""
    return (name not in ctx.fetch_names
            and name not in ctx.feed_names
            and name not in persist
            and name not in grad_read
            and uses.get(name, 0) == 1
            and writes.get(name, 0) == 1)


@register_opt_pass("fuse_conv_bn_relu")
def fuse_conv_bn_relu(ctx) -> int:
    """``conv2d -> batch_norm -> relu`` => ``fused_conv_bn_relu``.

    The conv must be bias-free (a biased ``static.nn.conv2d`` interposes
    an ``elementwise_add``, breaking adjacency by construction),
    ungrouped and undilated — the fused kernel's own admission rule. The
    ``batch_norm`` stat outputs keep their names and ``__inplace__``
    aliasing, so training-mode running-stat write-back is unchanged.
    """
    from ..static.program import OpDesc

    uses = ctx.use_counts()
    writes = ctx.writer_counts()
    grad_read = ctx.grad_read()
    persist = ctx.persistables()
    block = ctx.program.global_block()

    last_writer: Dict[str, int] = {}
    chains = []
    for j, bn in enumerate(block.ops):
        if bn.type == "batch_norm":
            bn_in = op_in_names(bn)
            bn_out = op_out_names(bn)
            if len(bn_in) == 5 and len(bn_out) == 3:
                chain = _match_conv_bn_relu(
                    ctx, block, j, bn, bn_in, bn_out, last_writer, uses,
                    writes, grad_read, persist, OpDesc)
                if chain is not None:
                    chains.append(chain)
        for n in all_out_names(bn):
            if n:
                last_writer[n] = j
    return _apply_chains(ctx, block, chains)


def _match_conv_bn_relu(ctx, block, j, bn, bn_in, bn_out, last_writer, uses,
                        writes, grad_read, persist, OpDesc):
    conv_out = bn_in[0]
    i = last_writer.get(conv_out)
    if i is None:
        return None
    conv = block.ops[i]
    if conv.type != "conv2d" or _single_out(conv) != conv_out:
        return None
    if int(conv.attrs.get("groups", 1)) != 1:
        return None
    if _pair(conv.attrs.get("dilation", 1)) != (1, 1):
        return None
    if conv.attrs.get("data_format", "NCHW") != bn.attrs.get(
            "data_format", "NCHW"):
        return None
    if not _fusible(ctx, conv_out, uses, writes, grad_read, persist):
        return None
    # the unique consumer of bn's y must be a relu
    bn_y = bn_out[0]
    if not _fusible(ctx, bn_y, uses, writes, grad_read, persist):
        return None
    relu_idx = None
    for k in range(j + 1, len(block.ops)):
        if bn_y in all_in_names(block.ops[k]):
            relu_idx = k
            break
    if relu_idx is None:
        return None
    relu = block.ops[relu_idx]
    if relu.type != "relu" or op_in_names(relu) != [bn_y]:
        return None
    relu_out = _single_out(relu)
    if relu_out is None:
        return None
    conv_in = op_in_names(conv)
    if len(conv_in) != 2:
        return None  # bias-free conv has exactly (x, weight)
    fused_in = [conv_in[0], conv_in[1],
                bn_in[1], bn_in[2], bn_in[3], bn_in[4]]
    # hoisting conv+bn down to the relu's slot: nothing in between may
    # redefine an operand (the dropped bn's own stat writes excepted),
    # and nothing may read the stat outputs before the fused op rewrites
    # them at the anchor
    if _writes_between(block, fused_in, i, relu_idx, skip=(j,)):
        return None
    for idx in range(j + 1, relu_idx):
        if any(n in bn_out[1:] for n in all_in_names(block.ops[idx])):
            return None
    attrs = {
        "stride": conv.attrs.get("stride", 1),
        "padding": conv.attrs.get("padding", 0),
        "momentum": bn.attrs.get("momentum", 0.9),
        "epsilon": bn.attrs.get("epsilon", 1e-5),
        "training": bn.attrs.get("training", True),
        "data_format": bn.attrs.get("data_format", "NCHW"),
    }
    if bn.attrs.get("__inplace__"):
        attrs["__inplace__"] = tuple(bn.attrs["__inplace__"])
    new_op = OpDesc("fused_conv_bn_relu", {"X": list(fused_in)},
                    {"Out": [relu_out, bn_out[1], bn_out[2]]}, attrs)
    return _Chain(drop=(i, j), anchor=relu_idx, new_op=new_op, new_vars=())


@register_opt_pass("fuse_layernorm_residual")
def fuse_layernorm_residual(ctx) -> int:
    """``elementwise_add -> layer_norm`` (last-dim norm, trailing [H]
    affine) => ``fused_layernorm_residual`` — the transformer residual
    idiom. Requires same-shape addends (the kernel's residual contract)
    and a 1-D scale/bias matching the last dim."""
    from ..static.program import OpDesc

    uses = ctx.use_counts()
    writes = ctx.writer_counts()
    grad_read = ctx.grad_read()
    persist = ctx.persistables()
    block = ctx.program.global_block()

    last_writer: Dict[str, int] = {}
    chains = []
    for j, ln in enumerate(block.ops):
        if ln.type == "layer_norm":
            chain = _match_ln_residual(
                ctx, block, j, ln, last_writer, uses, writes, grad_read,
                persist, OpDesc)
            if chain is not None:
                chains.append(chain)
        for n in all_out_names(ln):
            if n:
                last_writer[n] = j
    return _apply_chains(ctx, block, chains)


def _match_ln_residual(ctx, block, j, ln, last_writer, uses, writes,
                       grad_read, persist, OpDesc):
    ln_in = op_in_names(ln)
    if len(ln_in) != 3:  # need the affine pair for the fused kernel
        return None
    t, scale, bias = ln_in
    i = last_writer.get(t)
    if i is None:
        return None
    add = block.ops[i]
    if add.type != "elementwise_add" or _single_out(add) != t:
        return None
    add_in = op_in_names(add)
    if len(add_in) != 2 or not all(add_in):
        return None
    a, b = add_in
    if not _fusible(ctx, t, uses, writes, grad_read, persist):
        return None
    # last-dim normalization only (the kernel's contract)
    sa, sb = _var_shape(block, a), _var_shape(block, b)
    st = _var_shape(block, t)
    if sa is None or sb is None or sa != sb:
        return None  # broadcasting add: not the residual pattern
    bna = int(ln.attrs.get("begin_norm_axis", -1))
    ndim = len(st) if st is not None else len(sa)
    if bna not in (-1, ndim - 1):
        return None
    ss = _var_shape(block, scale)
    if ss is None or len(ss) != 1:
        return None
    h = (st or sa)[-1]
    if h in (-1, None) or ss[0] != h:
        return None
    if _writes_between(block, (a, b, scale, bias), i, j):
        return None
    ln_out = _single_out(ln)
    if ln_out is None:
        return None
    new_op = OpDesc("fused_layernorm_residual", {"X": [a, b, scale, bias]},
                    {"Out": [ln_out]},
                    {"epsilon": ln.attrs.get("epsilon", 1e-5)})
    return _Chain(drop=(i,), anchor=j, new_op=new_op, new_vars=())


@register_opt_pass("fuse_int8_matmul")
def fuse_int8_matmul(ctx) -> int:
    """Dequantized-int8 matmul/mul chains => ``matmul_int8``/``mul_int8``.

    Two admitted activation forms, both with the weight operand restored
    by ``dequantize_static`` from an int8 tensor (the shipped-int8 form
    ``slim/ptq.py`` leaves for ops it could not rewrite itself):

    - activation also ``dequantize_static``-restored from an int8
      tensor: contract the two int8 operands directly;
    - activation behind a ``quant_dequant_static`` sim op: replace the
      simulation with one real ``quantize_static`` (f32 -> int8) and
      contract — exactly the ``rewrite_int8_program`` lowering, now
      available to any imported program at run time.

    The int32 accumulation dequantizes once by the combined scale, so
    results match the f32-of-dequantized chain to float rounding (not
    bit-exact — the goldens use a tight allclose).
    """
    from ..static.program import OpDesc

    uses = ctx.use_counts()
    writes = ctx.writer_counts()
    grad_read = ctx.grad_read()
    persist = ctx.persistables()
    block = ctx.program.global_block()

    last_writer: Dict[str, int] = {}
    chains = []
    for j, mm in enumerate(block.ops):
        if mm.type in ("matmul", "mul"):
            chain = _match_int8(ctx, block, j, mm, last_writer, uses,
                                writes, grad_read, persist, OpDesc)
            if chain is not None:
                chains.append(chain)
        for n in all_out_names(mm):
            if n:
                last_writer[n] = j
    return _apply_chains(ctx, block, chains)


def _dequant_producer(block, last_writer, name):
    """(op index, int8 source, attrs) when ``name`` is written by a
    ``dequantize_static`` of an int8 var; None otherwise."""
    i = last_writer.get(name)
    if i is None:
        return None
    op = block.ops[i]
    if op.type != "dequantize_static" or _single_out(op) != name:
        return None
    src = op_in_names(op)[0]
    if _var_dtype(block, src) != "int8":
        return None
    return i, src, op.attrs


def _match_int8(ctx, block, j, mm, last_writer, uses, writes, grad_read,
                persist, OpDesc):
    ins = op_in_names(mm)
    if len(ins) != 2:
        return None
    a, w = ins
    wside = _dequant_producer(block, last_writer, w)
    if wside is None:
        return None
    iw, w8, wattrs = wside
    if not _fusible(ctx, w, uses, writes, grad_read, persist):
        return None

    drop = [iw]
    new_vars = ()
    extra_replace = ()
    aside = _dequant_producer(block, last_writer, a)
    if aside is not None:
        ia, a8, aattrs = aside
        if not _fusible(ctx, a, uses, writes, grad_read, persist):
            return None
        act_in, scale_x = a8, aattrs.get("scale")
        bl = aattrs.get("bit_length", 8)
        drop.append(ia)
        guard_in = [a8, w8]
        lo = min(ia, iw)
    else:
        i = last_writer.get(a)
        if i is None:
            return None
        qd = block.ops[i]
        if qd.type != "quant_dequant_static" or _single_out(qd) != a:
            return None
        if not _fusible(ctx, a, uses, writes, grad_read, persist):
            return None
        base = op_in_names(qd)[0]
        scale_x = qd.attrs.get("scale")
        bl = qd.attrs.get("bit_length", 8)
        if scale_x is None:
            return None
        q8 = f"{base}@q8"
        if block.has_var(q8) or q8 in writes:
            return None  # name already claimed (e.g. a prior rewrite)
        act_in = q8
        new_vars = ((q8, _var_shape(block, base), "int8"),)
        guard_in = [base, w8]
        lo = min(i, iw)
        # the quant-sim op at ``i`` BECOMES the real quantize (same
        # position, same input, new int8 output)
        quant = OpDesc("quantize_static", {"X": [base]}, {"Out": [q8]},
                       {"scale": float(scale_x), "bit_length": int(bl)})
        extra_replace = ((i, quant),)
    if scale_x is None or wattrs.get("scale") is None:
        return None
    if _writes_between(block, guard_in, lo, j):
        return None

    attrs = {k: v for k, v in mm.attrs.items() if not k.startswith("__")}
    attrs.update(scale_x=float(scale_x), scale_y=float(wattrs["scale"]),
                 bit_length=int(bl),
                 y_bit_length=int(wattrs.get("bit_length", 8)))
    new_op = OpDesc(f"{mm.type}_int8", {"X": [act_in, w8]},
                    dict(mm.outputs), attrs)
    return _Chain(drop=tuple(drop), anchor=j, new_op=new_op,
                  new_vars=new_vars, extra_replace=extra_replace)


# ---------------------------------------------------------------------------
# constant folding + dead-op elimination (generalized inference/passes.py)
# ---------------------------------------------------------------------------


@register_opt_pass("constant_folding", needs_scope=True)
def constant_folding(ctx) -> int:
    """Precompute every top-block op not reachable from a feed.

    An op whose inputs are all load-time constants (scope-resident
    parameters, captured constants, or outputs of already-folded ops)
    runs ONCE here with the real kernels, on ``ctx.device`` when one is
    given; its outputs become scope-resident persistable vars and the op
    disappears from the block. A ``dequantize_static`` of an int8 weight
    folds this way. RNG ops, control-flow ops and ``grad::`` replays never
    fold. Scope-gated: only the Predictor's load-time pipeline supplies one
    (folding against a live training scope would freeze weights).
    """
    from ..ops.registry import kernel

    program, scope, device = ctx.program, ctx.scope, ctx.device
    block = program.global_block()
    for cname, cval in program._constants.items():
        if not scope.has(cname):
            scope.set(cname, cval)
    available = set(scope.var_names())
    feeds = set(ctx.feed_names)

    folded = 0
    keep = []
    for op in block.ops:
        ins = all_in_names(op)
        outs = all_out_names(op)
        foldable = (
            op.type not in _BLOCK_OPS + ("feed", "fetch")
            and not op.type.startswith("grad::")
            and not op.attrs.get("__rng__")
            and all(n in available and n not in feeds for n in ins)
            and any(outs)
        )
        if not foldable:
            keep.append(op)
            continue
        attrs = {k: v for k, v in op.attrs.items() if not k.startswith("__")}
        args = [scope.get(n) if device is None else scope.on(n, device) for n in ins]
        try:
            out = kernel(op.type)(*args, **attrs)
        except Exception:
            keep.append(op)  # kernel refused
            continue
        results = list(out) if isinstance(out, (tuple, list)) else [out]
        for name, value in zip(op_out_names(op), results):
            if not name or value is None:
                continue
            scope.set(name, value)
            if block.has_var(name):
                block.var(name).persistable = True
            available.add(name)
        folded += 1
    if folded:
        block.ops[:] = keep
        ctx.bump_version()
    return folded


@register_opt_pass("dead_op_elimination")
def dead_op_elimination(ctx) -> int:
    """Remove side-effect-free top-block ops whose outputs nothing reads.

    Iterates to a fixpoint so dead chains collapse. Deliberately
    conservative — kept, regardless of use counts: control-flow ops,
    ``grad::`` replays (the level-1 byte-identity promise for training
    programs), ops writing persistables or declaring ``__inplace__``,
    and ops with no outputs. Safe by construction for the default
    executor pipeline; also the Predictor's DCE (where it reduces to
    fetch reachability, since inference programs have none of the
    side-effecting forms).
    """
    fetches = set(ctx.fetch_names)
    persist = ctx.persistables()
    removed_total = 0
    while True:
        uses = ctx.use_counts()
        block = ctx.program.global_block()
        keep = []
        removed = 0
        for op in block.ops:
            outs = [n for n in all_out_names(op) if n]
            side_effecting = (
                op.type in _BLOCK_OPS
                or op.type.startswith("grad::")
                or not outs
                or op.attrs.get("__inplace__")
                or any(n in persist for n in outs)
            )
            live = any(n in fetches or uses.get(n, 0) > 0 for n in outs)
            if side_effecting or live:
                keep.append(op)
            else:
                removed += 1
        if not removed:
            break
        block.ops[:] = keep
        ctx.bump_version()
        removed_total += removed
    return removed_total


# ---------------------------------------------------------------------------
# liveness-driven rematerialization
# ---------------------------------------------------------------------------


@register_opt_pass("rematerialize", min_level=2)
def rematerialize(ctx) -> int:
    """Recompute cheap activations at their late uses when over budget.

    Consults :func:`~paddle_tpu.analysis.plan_memory`'s resident curve:
    while the predicted peak exceeds the device HBM budget
    (:func:`~paddle_tpu.analysis.hbm_budget_bytes`), pick the largest
    intermediate live across the high-water op that (a) a flops-light
    deterministic op produces, (b) is only needed again strictly after
    the peak, and (c) can be recomputed there from operands that are
    statically resident (feeds/persistables/constants) or still live —
    never extending any interval. The producer is duplicated right
    before the first late use writing ``<v>@remat<k>`` and the late
    consumers rewired; replan, repeat until the program fits or no
    candidate reduces the peak. Returns remat ops inserted.
    """
    from .memory import hbm_budget_bytes, plan_memory

    budget = hbm_budget_bytes(ctx.device)
    if not budget:
        return 0
    inserted = 0
    prev_peak = None
    for _ in range(_REMAT_MAX_ROUNDS):
        try:
            plan = plan_memory(ctx.program, ctx.feed_names, ctx.fetch_names,
                               feed_shapes=ctx.feed_shapes, top_k=64)
        except Exception:
            return inserted
        if plan.peak_op_index is None or plan.peak_bytes <= budget:
            break
        if prev_peak is not None and plan.peak_bytes > prev_peak:
            break  # the last insertion made things WORSE: stop digging
        # a plateau is allowed: recomputing one of several equally-sized
        # held activations often just moves the high-water op, and the
        # drop only lands once the last of them is rematerialized
        prev_peak = plan.peak_bytes
        if not _remat_once(ctx, plan, inserted):
            break
        inserted += 1
    return inserted


def _remat_once(ctx, plan, serial) -> bool:
    program = ctx.program
    block = program.global_block()
    ops = block.ops
    peak_i = plan.peak_op_index
    persist = ctx.persistables()
    feeds = set(ctx.feed_names)
    consts = set(getattr(program, "_constants", {}) or {})
    statics = persist | feeds | consts
    for blk in program.blocks:
        for name, var in blk.vars.items():
            if getattr(var, "is_data", False):
                statics.add(name)

    def_idx: Dict[str, int] = {}
    last_use: Dict[str, int] = {}
    uses_at: Dict[str, List[int]] = {}
    writers: Dict[str, int] = {}
    for i, op in enumerate(ops):
        for n in all_in_names(op):
            if n:
                last_use[n] = i
                uses_at.setdefault(n, []).append(i)
        for n in all_out_names(op):
            if n:
                def_idx.setdefault(n, i)
                writers[n] = writers.get(n, 0) + 1

    # largest-first over the intermediates live at the high-water op
    for name, _bytes, src in plan.top_tensors:
        if src != "intermediate" or name in statics:
            continue
        if name in ctx.fetch_names or writers.get(name, 0) != 1:
            continue
        d = def_idx.get(name)
        if d is None or d >= peak_i:
            continue
        producer = ops[d]
        if (producer.type not in _REMAT_CHEAP_OPS
                or producer.attrs.get("__rng__")
                or producer.attrs.get("__inplace__")
                or _single_out(producer) != name):
            continue
        all_uses = uses_at.get(name, [])
        late = [u for u in all_uses if u > peak_i]
        # the var must die BEFORE the peak once late uses are rewired
        if not late or any(u == peak_i for u in all_uses):
            continue
        t0 = min(late)
        if any(ops[u].type.startswith("grad::") or ops[u].type in _BLOCK_OPS
               for u in late):
            continue
        # every producer operand must be free to re-read at t0: static,
        # or still live there — never extend an interval
        ok = True
        for x in all_in_names(producer):
            if not x or x in statics:
                continue
            if def_idx.get(x, t0) >= t0 or last_use.get(x, -1) < t0:
                ok = False
                break
            if writers.get(x, 0) != 1:
                ok = False
                break
        if not ok:
            continue
        _insert_remat(ctx, block, name, d, t0, late, serial)
        return True
    return False


def _insert_remat(ctx, block, name, d, t0, late_uses, serial):
    from ..static.program import OpDesc

    producer = block.ops[d]
    new_name = f"{name}@remat{serial}"
    shape = _var_shape(block, name)
    block.create_var(name=new_name,
                     shape=None if shape is None else list(shape),
                     dtype=_var_dtype(block, name) or "float32")
    outputs = {slot: [new_name if n == name else n for n in names]
               for slot, names in producer.outputs.items()}
    attrs = {k: v for k, v in producer.attrs.items() if k != "__inplace__"}
    clone = OpDesc(producer.type, {s: list(n) for s, n in
                                   producer.inputs.items()}, outputs, attrs)
    for u in late_uses:
        op = block.ops[u]
        op.inputs.update({
            slot: [new_name if n == name else n for n in names]
            for slot, names in op.inputs.items()})
    block.ops.insert(t0, clone)
    # if rewiring left the original value with zero readers (its only
    # uses were the late ones), the original producer now computes a
    # dead tensor every step — drop it. d < t0 always, so the freshly
    # inserted clone's index is unaffected by the deletion.
    if not any(name in all_in_names(op)
               for blk in ctx.program.blocks for op in blk.ops):
        del block.ops[d]
    ctx.bump_version()


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------


class PassManager:
    """Ordered pass application over a Program, IN PLACE.

    ``apply`` verifies the program up front, then for every selected
    pass: run it, and when it changed the IR re-verify and replan memory
    (the per-pass verify/replan contract). Per-pass
    :class:`PassStats` land on ``self.stats``, profiler counters and
    the monitor registry. Callers that must not mutate their input go
    through :func:`optimize_program`, which clones first and caches."""

    def __init__(self, passes=None):
        unknown = [p for p in (passes or []) if p not in _OPT_PASSES]
        if unknown:
            from ..errors import NotFoundError

            raise NotFoundError(f"unknown optimizer pass(es): {unknown}")
        self.passes = list(passes) if passes is not None \
            else list(_OPT_PASSES)
        self.stats: List[PassStats] = []

    def apply(self, program, feed_names=(), fetch_names=(), *, level=1,
              scope=None, feed_shapes=None, verify=True,
              device=None) -> List[PassStats]:
        ctx = OptContext(program, feed_names, fetch_names, scope=scope,
                         feed_shapes=feed_shapes, level=level, device=device)
        if verify:
            program.verify(feed_names=ctx.feed_names,
                           fetch_list=ctx.fetch_names)
        plan_peak = self._peak(ctx)
        stats = []
        for name in self.passes:
            p = _OPT_PASSES[name]
            if p.min_level > ctx.level:
                continue
            if p.needs_scope and scope is None:
                continue
            t0 = time.perf_counter()
            rewritten = int(p.fn(ctx) or 0)
            wall_ms = (time.perf_counter() - t0) * 1e3
            bytes_saved = 0
            if rewritten:
                if verify:
                    program.verify(feed_names=ctx.feed_names,
                                   fetch_list=ctx.fetch_names)
                new_peak = self._peak(ctx)
                if plan_peak is not None and new_peak is not None:
                    bytes_saved = max(0, plan_peak - new_peak)
                plan_peak = new_peak if new_peak is not None else plan_peak
            st = PassStats(name, rewritten, int(bytes_saved), wall_ms)
            stats.append(st)
            _record_pass(st)
        self.stats = stats
        return stats

    @staticmethod
    def _peak(ctx) -> Optional[int]:
        from .memory import plan_memory

        try:
            plan = plan_memory(ctx.program, ctx.feed_names, ctx.fetch_names,
                               feed_shapes=ctx.feed_shapes)
        except Exception:
            return None
        return int(plan.peak_bytes)


# -- stats plumbing (satellite: registry counters + /statz) ------------------

_TOTALS: Dict[str, Dict[str, float]] = {}


def _record_pass(st: PassStats):
    from ..monitor import registry as _registry

    tot = _TOTALS.setdefault(st.name, {
        "runs": 0, "ops_rewritten": 0, "bytes_saved": 0, "wall_ms": 0.0})
    tot["runs"] += 1
    tot["ops_rewritten"] += st.ops_rewritten
    tot["bytes_saved"] += st.bytes_saved
    tot["wall_ms"] += st.wall_ms
    if st.ops_rewritten:
        profiler.bump_counter(
            f"ir_opt::{st.name}::ops_rewritten", st.ops_rewritten)
        _registry.counter(
            f"ir_opt/{st.name}/ops_rewritten",
            help="ops rewritten by this IR-optimizer pass",
        ).inc(st.ops_rewritten)
    if st.bytes_saved:
        profiler.bump_counter(
            f"ir_opt::{st.name}::bytes_saved", st.bytes_saved)
        _registry.counter(
            f"ir_opt/{st.name}/bytes_saved",
            help="planned peak-memory bytes saved by this pass",
        ).inc(st.bytes_saved)


def optimizer_stats() -> dict:
    """Cumulative per-pass totals for /statz: ``{pass: {runs,
    ops_rewritten, bytes_saved, wall_ms}}``."""
    return {name: dict(tot) for name, tot in _TOTALS.items()}


def reset_optimizer_stats():
    _TOTALS.clear()


# ---------------------------------------------------------------------------
# the cached clone-and-rewrite entry (Executor.run / Predictor)
# ---------------------------------------------------------------------------


def _flag_level() -> int:
    from ..flags import flag

    try:
        return int(str(flag("ir_opt_level")).strip() or "0")
    except (ValueError, KeyError):
        return 0


def _clone_program(program):
    """A copy of ``program`` through ``to_dict``/``from_dict`` (every op
    with input and output lists of its own, so a rewrite never reaches
    back into the original) under a new process-unique identity: the
    executor's capture signature keys on it."""
    clone = type(program).from_dict(program.to_dict())
    clone._name_counter = dict(getattr(program, "_name_counter", {}))
    clone._rng_counter = getattr(program, "_rng_counter", 0)
    clone.random_seed = getattr(program, "random_seed", None)
    return clone


def optimize_program(program, feed_names=(), fetch_names=(), *, level=None,
                     feed_shapes=None, scope=None, passes=None,
                     device=None) -> OptResult:
    """Optimize ``program`` for a (feeds, fetches) run signature.

    Clones, runs the pass pipeline at ``level`` (``FLAGS_ir_opt_level``
    when None), and returns an :class:`OptResult`. When no pass rewrote
    anything the ORIGINAL program object is returned (``changed=False``)
    so downstream compile caches key on the identity they already know.
    Results cache on the program per (version, n_vars, feeds, fetches,
    level, feed-shape signature, device) with the verifier-cache LRU
    discipline: an unchanged program version pays one dict lookup per run
    and gets back the same clone. ``device`` is where folding runs and whose
    memory the remat pass budgets against.
    """
    level = _flag_level() if level is None else int(level)
    if level <= 0:
        return OptResult(program, [], False)
    feeds = tuple(sorted(feed_names or ()))
    fetches = tuple(
        v if isinstance(v, str) else v.name for v in (fetch_names or ()))
    shapes_sig = tuple(sorted(
        (n, tuple(int(d) for d in s))
        for n, s in (feed_shapes or {}).items()))
    n_vars = sum(len(b.vars) for b in program.blocks)
    key = (getattr(program, "_version", 0), n_vars, feeds, fetches,
           level, shapes_sig, bool(scope is not None), str(device))
    cache = program.__dict__.setdefault("_ir_opt_cache", {})
    hit = cache.get(key)
    if hit is not None:
        cache.pop(key, None)
        cache[key] = hit  # LRU refresh
        profiler.bump_counter("ir_opt::cache_hit")
        return hit
    profiler.bump_counter("ir_opt::cache_miss")
    clone = _clone_program(program)
    mgr = PassManager(passes)
    # honour FLAGS_program_verify=off: a caller who disabled verification
    # must not get VerifyErrors from the optimizer's internal pre/post
    # checks either (the legacy opaque failure path stays reachable)
    from ..flags import flag as _flag

    verify = str(_flag("program_verify")).strip().lower() not in (
        "", "0", "off", "false", "no")
    stats = mgr.apply(clone, feeds, fetches, level=level, scope=scope,
                      feed_shapes=feed_shapes, verify=verify, device=device)
    changed = any(s.ops_rewritten for s in stats)
    result = OptResult(clone if changed else program, stats, changed)
    cache[key] = result
    while len(cache) > _CACHE_LIMIT:
        try:
            cache.pop(next(iter(cache)), None)
        except (StopIteration, RuntimeError):
            break
    return result


# ---------------------------------------------------------------------------
# measured per-op before/after (the opprof closure on the pass pipeline)
# ---------------------------------------------------------------------------


def measure_pass_deltas(program, feed, fetch_names=(), *, level=None,
                        passes=None, scope=None, name=None,
                        warmup=None, repeats=None, device=None) -> dict:
    """Replay-profile ``program`` before and after the pass pipeline and
    report measured per-op deltas (``paddle_tpu/analysis/optimizer.py``):
    per op type, the replayed us before and after
    (``monitor.opprof.profile_program`` on ``device``), each pass's
    rewrite stats and the whole program's speedup. The program must run
    from ``scope`` (run it through the Executor once first). Both profiles
    land in the opprof store as ``<name>@pre`` / ``<name>@post``."""
    from ..monitor import opprof as _opprof

    name = name or f"prog{getattr(program, '_identity_token', id(program))}"
    feeds = tuple(sorted(feed or ()))
    fetches = tuple(v if isinstance(v, str) else v.name for v in (fetch_names or ()))
    before = _opprof.profile_program(
        program, feed, fetches, scope=scope, name=f"{name}@pre", warmup=warmup,
        repeats=repeats, with_trace=False, record=False, device=device)
    result = optimize_program(
        program, feeds, fetches, level=level, passes=passes, scope=scope,
        feed_shapes={k: tuple(getattr(v, "shape", ()) or ()) for k, v in (feed or {}).items()},
        device=device)
    after = _opprof.profile_program(
        result.program, feed, fetches, scope=scope, name=f"{name}@post", warmup=warmup,
        repeats=repeats, with_trace=False, record=False, device=device)

    def _by_type(profile):
        agg: Dict[str, Dict[str, float]] = {}
        for row in profile["ops"]:
            if not row.get("replayed"):
                continue
            t = agg.setdefault(row["op_type"], {"time_us": 0.0, "ops": 0})
            t["time_us"] = round(t["time_us"] + row["time_us"], 3)
            t["ops"] += 1
        return agg

    before_by, after_by = _by_type(before), _by_type(after)
    deltas = {}
    for op_type in sorted(set(before_by) | set(after_by)):
        b = before_by.get(op_type, {"time_us": 0.0, "ops": 0})
        a = after_by.get(op_type, {"time_us": 0.0, "ops": 0})
        deltas[op_type] = {
            "before_us": b["time_us"], "after_us": a["time_us"],
            "before_ops": b["ops"], "after_ops": a["ops"],
            "delta_us": round(a["time_us"] - b["time_us"], 3),
        }
    return {
        "name": name,
        "changed": result.changed,
        "passes": [{"name": s.name, "ops_rewritten": s.ops_rewritten,
                    "bytes_saved": s.bytes_saved, "wall_ms": round(s.wall_ms, 3)}
                   for s in result.stats],
        "before_us": before["total_us"],
        "after_us": after["total_us"],
        "speedup": (round(before["total_us"] / after["total_us"], 4)
                    if after["total_us"] else None),
        "deltas": deltas,
    }
