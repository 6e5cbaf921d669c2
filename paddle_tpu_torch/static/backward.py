"""Static autodiff (``paddle_tpu/static/backward.py:27-148``): ``append_backward`` and ``gradients``.

The same ops as the JAX package, in the same order and with the same
names: a ``fill_any_like`` of ones for the loss's gradient, then, walking
the forward ops in reverse, one ``grad::<type>`` op for each forward op
that has a gradient to pass on (its inputs: the forward inputs, then the
gradients of the forward outputs, ``""`` where an output has none; its
attributes: the forward op's plus ``__n_fwd_in__``), and a ``sum_n`` where
several consumers feed one variable's gradient. The executor evaluates a
``grad::<type>`` op by re-running the registered forward kernel under
autograd (:func:`paddle_tpu_torch.static.executor.run_grad_op`), where the
JAX executor takes ``jax.vjp`` of it; a ``grad::cond`` or ``grad::scan``
re-runs the op over its sub-blocks. A loss that depends on an unbounded
``while`` op's output, wholly or in part, raises, as there.
"""
from __future__ import annotations

from ..framework.dtype import torch_dtype
from .program import default_main_program

__all__ = ["append_backward", "gradients"]


def _is_float_var(block, name):
    try:
        v = block.var(name)
    except KeyError:
        return False
    return torch_dtype(v.dtype).is_floating_point


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Append the gradient ops of ``loss``; returns ``[(param, grad_var)]``
    for the parameters (``parameter_list``, by default every parameter of
    the block) that have a gradient."""
    prog = default_main_program()
    block = loss.block if hasattr(loss, "block") else prog.global_block()
    ops = block.ops
    no_grad_set = set(no_grad_set or [])

    # forward: which variables require a gradient; `tainted` follows values
    # whose gradient path runs through a while op, which has none
    requires = set()
    tainted = set()
    for v in block.vars.values():
        if not v.stop_gradient and _is_float_var(block, v.name):
            requires.add(v.name)
    for op in ops:
        all_ins = op.input_names()
        all_outs = op.output_names()
        if op.type == "while":
            if any(n in requires or n in tainted for n in all_ins):
                tainted.update(all_outs)
            continue
        if any(n in tainted for n in all_ins):
            tainted.update(all_outs)
        if any(n in requires for n in op.inputs.get("X", [])):
            for n in op.outputs.get("Out", []):
                if _is_float_var(block, n) and n not in no_grad_set:
                    requires.add(n)

    if loss.name in tainted:
        raise RuntimeError(
            f"loss {loss.name!r} depends on the output of a while op, which is not "
            "reverse-differentiable in static autodiff. Pass max_iters=N to while_loop for "
            "the differentiable masked-scan lowering, rewrite the loop with static.nn.scan, "
            "or detach the while outputs from the loss.")
    if loss.name not in requires:
        raise RuntimeError(f"loss {loss.name!r} does not depend on any trainable variable")

    grad_map: dict[str, str] = {}  # variable -> the name of its gradient so far
    loss_grad = block.create_var(name=loss.name + "@GRAD", shape=loss.shape,
                                 dtype=str(loss.dtype))
    block.append_op("fill_any_like", {"X": [loss.name]}, {"Out": [loss_grad.name]},
                    {"value": 1.0})
    grad_map[loss.name] = loss_grad.name

    for i in range(len(ops) - 1, -1, -1):
        op = ops[i]
        if op.type == "while":
            continue  # the loss does not flow through it (checked above)
        in_names = op.inputs.get("X", [])
        out_grads = [grad_map.get(n) for n in op.outputs.get("Out", [])]
        if all(g is None for g in out_grads):
            continue
        if not any(n in requires for n in in_names):
            continue

        grad_in = list(in_names) + [g or "" for g in out_grads]
        grad_out = []
        accum_jobs = []  # (variable, its gradient so far, this op's part)
        for n in in_names:
            if n not in requires or n in no_grad_set:
                grad_out.append("")
                continue
            base = n + "@GRAD"
            if n in grad_map:
                gname = prog._unique_name(base)
                accum_jobs.append((n, grad_map[n], gname))
            else:
                gname = base if not block.has_var(base) else prog._unique_name(base)
                grad_map[n] = gname
            if not block.has_var(gname):
                src = block.var(n)
                block.create_var(name=gname, shape=src.shape, dtype=str(src.dtype))
            grad_out.append(gname)

        attrs = dict(op.attrs)
        attrs["__n_fwd_in__"] = len(in_names)
        # the input list keeps the "" placeholders: the executor splits it
        # at __n_fwd_in__ and gives an output without a gradient zeros
        block.append_op("grad::" + op.type, {"X": grad_in}, {"Out": grad_out}, attrs)

        for n, old, fresh in accum_jobs:
            acc = prog._unique_name(n + "@GRAD@ACC")
            src = block.var(n)
            block.create_var(name=acc, shape=src.shape, dtype=str(src.dtype))
            block.append_op("sum_n", {"X": [old, fresh]}, {"Out": [acc]}, {})
            grad_map[n] = acc

    params = parameter_list or [v.name for v in block.vars.values() if v.is_parameter]
    result = []
    for p in params:
        pname = p if isinstance(p, str) else p.name
        if pname in grad_map:
            result.append((block.var(pname), block.var(grad_map[pname])))
    return result


def gradients(targets, inputs, target_gradients=None):
    """``paddle.static.gradients``: the gradient variables of ``targets[0]``
    with respect to ``inputs`` (None where there is none)."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    pairs = append_backward(targets[0], parameter_list=[v.name for v in inputs])
    by_name = {p.name: g for p, g in pairs}
    return [by_name.get(v.name) for v in inputs]
