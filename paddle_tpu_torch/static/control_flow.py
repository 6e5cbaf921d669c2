"""Static control flow (``paddle_tpu/static/control_flow.py``): ``while_loop``, ``cond``, ``scan``, ``case``, ``switch_case``.

Each of these functions traces the user's functions into new nested blocks (under
:func:`~.program.block_guard`, on placeholder Variables standing for the
loop variables) and appends one op to the current block, ``while``,
``cond`` or ``scan``, that names its sub-blocks in the attributes of
:data:`BLOCK_ATTR_KEYS` and lists its sub-blocks' formals and results: the
JAX package's op layout, attribute for attribute, so a program with
sub-blocks either package serialized runs in the other. A name a sub-block
reads but does not define (a parameter, say) becomes an explicit input of
the op (:func:`_collect_captures`), so ``append_backward`` routes its
gradient.

How the port's executor runs them (``executor.py``):

- ``scan`` is a bounded loop: the body runs ``length`` times on the card,
  its per-step outputs stacked; differentiable, and captured with the
  rest of the program.
- ``cond`` runs both branches and selects each output, and each
  persistable the branches write, with ``torch.where`` on the predicate,
  which stays on the card; differentiable, and captured.
- ``while`` has a data-dependent trip count: the predicate comes to the
  host once per iteration, so a program holding one is interpreted at
  every run and never captured. It has no gradient.
  ``while_loop(max_iters=N)`` is a masked ``scan`` of N steps instead
  (:func:`_bounded_while`): captured and differentiable.
"""
from __future__ import annotations

import numpy as np

from .op_append import capture_constant
from .program import Variable, block_guard, default_main_program

__all__ = ["while_loop", "cond", "scan", "case", "switch_case", "BLOCK_ATTR_KEYS"]

# attribute keys holding sub-block indices (the executor and captures walk these)
BLOCK_ATTR_KEYS = ("__cond_block__", "__body_block__", "__true_block__", "__false_block__")


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _as_variables(vars_, block=None):
    """Loop inputs as program variables: a host tensor or array becomes a
    captured constant."""
    return [v if isinstance(v, Variable) else capture_constant(v, block) for v in _as_list(vars_)]


def _placeholders(block, ref_vars, shapes=None, prefix="loopvar"):
    """Formal-argument Variables inside ``block`` mirroring ``ref_vars``."""
    prog = block.program
    out = []
    for i, v in enumerate(ref_vars):
        shape = shapes[i] if shapes is not None else v.shape
        ph = block.create_var(name=prog._unique_name(prefix), shape=shape, dtype=str(v.dtype))
        ph.stop_gradient = v.stop_gradient
        out.append(ph)
    return out


def _collect_captures(program, block_idxs, exclude):
    """Names the sub-blocks (and the blocks nested in them) read that
    resolve outside them: the op's captured inputs."""
    captures = []
    seen = set(exclude)
    stack = list(block_idxs)
    local_blocks = set(block_idxs)
    while stack:
        blk = program.blocks[stack.pop()]
        for op in blk.ops:
            for key, val in op.attrs.items():
                if key in BLOCK_ATTR_KEYS and isinstance(val, int):
                    local_blocks.add(val)
                    stack.append(val)
            for n in op.input_names():
                if n in seen:
                    continue
                seen.add(n)
                owner = _owning_block(program, blk, n)
                if owner is not None and owner.idx not in local_blocks:
                    captures.append(n)
    return captures


def _owning_block(program, block, name):
    blk = block
    while blk is not None:
        if name in blk.vars:
            return blk
        blk = program.blocks[blk.parent_idx] if blk.parent_idx >= 0 else None
    return None


def while_loop(cond, body, loop_vars, is_test=False, name=None, max_iters=None):
    """``paddle.static.nn.while_loop``: ``cond(*loop_vars)`` gives a bool
    scalar, ``body(*loop_vars)`` the next loop variables (same shapes and
    dtypes). ``max_iters=N`` lowers the loop to a masked ``scan`` of N
    steps: captured on the card and differentiable, where the unbounded
    loop is neither."""
    if max_iters is not None:
        return _bounded_while(cond, body, loop_vars, int(max_iters))
    loop_vars = _as_variables(loop_vars)
    if not loop_vars:
        raise ValueError("while_loop needs at least one loop variable")
    prog = default_main_program()
    parent = prog.current_block()

    cond_blk = prog._create_block()
    cond_formals = _placeholders(cond_blk, loop_vars)
    with block_guard(cond_blk):
        pred = cond(*cond_formals)
    if isinstance(pred, (list, tuple)):
        raise TypeError("while_loop cond must return a single boolean")

    body_blk = prog._create_block()
    body_formals = _placeholders(body_blk, loop_vars)
    with block_guard(body_blk):
        body_outs = _as_variables(body(*body_formals), body_blk)
    if len(body_outs) != len(loop_vars):
        raise ValueError(f"body returned {len(body_outs)} vars, expected {len(loop_vars)}")

    formal_names = [v.name for v in cond_formals] + [v.name for v in body_formals]
    captures = _collect_captures(prog, [cond_blk.idx, body_blk.idx], set(formal_names))

    out_vars = []
    for v in loop_vars:
        ov = parent.create_var(name=prog._unique_name("while_out"), shape=v.shape,
                               dtype=str(v.dtype))
        ov.stop_gradient = True  # an unbounded while has no gradient
        out_vars.append(ov)

    parent.append_op(
        "while",
        {"X": [v.name for v in loop_vars] + captures},
        {"Out": [v.name for v in out_vars]},
        {"__cond_block__": cond_blk.idx, "__body_block__": body_blk.idx,
         "__cond_formals__": [v.name for v in cond_formals],
         "__body_formals__": [v.name for v in body_formals],
         "__cond_out__": pred.name, "__body_outs__": [v.name for v in body_outs],
         "__n_loop__": len(loop_vars), "is_test": is_test})
    return out_vars


def _bounded_while(cond_fn, body_fn, loop_vars, max_iters):
    """while(cond) bounded by ``max_iters``: a scan whose body is
    ``cond(vars) ? body(vars) : vars``."""
    loop_vars = _as_variables(loop_vars)

    def sbody(*carries):
        pred = cond_fn(*carries)
        outs = cond(pred, lambda: _as_list(body_fn(*carries)), lambda: list(carries))
        return _as_list(outs), []

    finals, _ = scan(sbody, list(loop_vars), None, length=max_iters)
    return finals


def cond(pred, true_fn, false_fn, name=None):
    """``paddle.static.nn.cond``: both branches traced into sub-blocks; the
    outputs must agree in number, dtype and shape (checked here, at build
    time). Differentiable."""
    prog = default_main_program()
    parent = prog.current_block()

    true_blk = prog._create_block()
    with block_guard(true_blk):
        t_outs = _as_variables(true_fn(), true_blk)
    false_blk = prog._create_block()
    with block_guard(false_blk):
        f_outs = _as_variables(false_fn(), false_blk)
    if len(t_outs) != len(f_outs):
        raise ValueError(f"cond branches returned {len(t_outs)} vs {len(f_outs)} outputs")
    for i, (t, f) in enumerate(zip(t_outs, f_outs)):
        if str(t.dtype) != str(f.dtype):
            raise TypeError(f"cond branch dtype mismatch: {t.dtype} vs {f.dtype}")
        ts, fs = t.shape, f.shape
        if ts is not None and fs is not None and list(ts) != list(fs):
            raise ValueError(
                f"cond branch output {i} shape mismatch: true_fn returned {list(ts)}, false_fn "
                f"returned {list(fs)} — both branches must produce identically-shaped outputs")

    captures = _collect_captures(prog, [true_blk.idx, false_blk.idx], set())

    out_vars = []
    for t, f in zip(t_outs, f_outs):
        ov = parent.create_var(name=prog._unique_name("cond_out"), shape=t.shape,
                               dtype=str(t.dtype))
        ov.stop_gradient = t.stop_gradient and f.stop_gradient
        out_vars.append(ov)

    parent.append_op(
        "cond",
        {"X": [pred.name] + captures},
        {"Out": [v.name for v in out_vars]},
        {"__true_block__": true_blk.idx, "__false_block__": false_blk.idx,
         "__true_outs__": [v.name for v in t_outs], "__false_outs__": [v.name for v in f_outs]})
    return out_vars[0] if len(out_vars) == 1 else out_vars


def scan(body, init, sequences=None, length=None, name=None):
    """The differentiable bounded loop over time-major sequences:
    ``body(*carries, *x_slices) -> (new_carries, y_slices)``, where
    ``x_slices`` are the step's slices ``seq[t]`` and the ``y_slices`` are
    stacked into ``[T, ...]``. Returns ``(final_carries, stacked_ys)``."""
    init = _as_variables(init)
    sequences = _as_variables(sequences)
    if not init and not sequences:
        raise ValueError("scan needs carries and/or sequences")
    if not sequences and length is None:
        raise ValueError("scan without sequences needs an explicit length= (a static trip count)")
    prog = default_main_program()
    parent = prog.current_block()

    body_blk = prog._create_block()
    carry_formals = _placeholders(body_blk, init, prefix="scan_carry")
    seq_formals = _placeholders(body_blk, sequences,
                                shapes=[list(s.shape)[1:] for s in sequences], prefix="scan_x")
    with block_guard(body_blk):
        res = body(*carry_formals, *seq_formals)
        if not (isinstance(res, tuple) and len(res) == 2):
            raise TypeError("scan body must return (new_carries, y_slices); use ([], ...) or "
                            "(..., []) for empty groups")
        new_carries = _as_variables(res[0], body_blk)
        ys = _as_variables(res[1], body_blk)
    if len(new_carries) != len(init):
        raise ValueError(f"body returned {len(new_carries)} carries, expected {len(init)}")

    formal_names = {v.name for v in carry_formals} | {v.name for v in seq_formals}
    captures = _collect_captures(prog, [body_blk.idx], formal_names)

    length = sequences[0].shape[0] if sequences else int(length)

    out_vars = []
    for v in new_carries:
        ov = parent.create_var(name=prog._unique_name("scan_carry_out"), shape=v.shape,
                               dtype=str(v.dtype))
        ov.stop_gradient = v.stop_gradient
        out_vars.append(ov)
    for v in ys:
        ov = parent.create_var(name=prog._unique_name("scan_y"),
                               shape=[length] + list(v.shape or []), dtype=str(v.dtype))
        ov.stop_gradient = v.stop_gradient
        out_vars.append(ov)

    parent.append_op(
        "scan",
        {"X": [v.name for v in init] + [v.name for v in sequences] + captures},
        {"Out": [v.name for v in out_vars]},
        {"__body_block__": body_blk.idx,
         "__carry_formals__": [v.name for v in carry_formals],
         "__seq_formals__": [v.name for v in seq_formals],
         "__carry_outs__": [v.name for v in new_carries], "__y_outs__": [v.name for v in ys],
         "__n_carry__": len(init), "__n_seq__": len(sequences),
         "__length__": None if sequences else length})
    n_c = len(init)
    return out_vars[:n_c], out_vars[n_c:]


def case(pred_fn_pairs, default=None, name=None):
    """``fluid.layers.case``: the first true predicate wins; a chain of
    ``cond``."""
    if not pred_fn_pairs:
        raise ValueError("case needs at least one (pred, fn) pair")
    pred, fn = pred_fn_pairs[0]
    rest = pred_fn_pairs[1:]
    if rest:
        return cond(pred, fn, lambda: case(rest, default=default))
    if default is not None:
        return cond(pred, fn, default)
    return fn()


def switch_case(branch_index, branch_fns, default=None, name=None):
    """``fluid.layers.switch_case`` over an integer index (the last branch
    is the default unless one is given)."""
    from .. import ops

    items = (sorted(branch_fns.items()) if isinstance(branch_fns, dict)
             else list(enumerate(branch_fns)))
    pairs = [(ops.equal(branch_index, np.int64(i)), fn) for i, fn in items]
    if default is None:
        default = items[-1][1]
    return case(pairs, default=default)
