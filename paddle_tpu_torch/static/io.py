"""Static-graph model serialization (``paddle_tpu/static/io.py:91-167``).

``<dir>/__model__`` holds the pruned Program as JSON with its feed and fetch
names, ``<dir>/__params__`` every persistable variable in one
``framework.serialization`` file: the JAX package's file names and keys, so
a directory either package writes loads in the other.
"""
from __future__ import annotations

import json
import os

from ..framework import serialization
from .executor import global_scope
from .program import Program, default_main_program

__all__ = ["save_inference_model", "load_inference_model"]

_MODEL_FILENAME = "__model__"
_PARAMS_FILENAME = "__params__"


def _persistable_dict(program, scope=None):
    scope = scope or global_scope()
    out = {}
    for var in program.list_vars():
        if var.persistable and scope.has(var.name):
            out[var.name] = scope.numpy(var.name)
    # captured constants are authoritative over a same-named scope value
    out.update(program._constants)
    return out


def save_inference_model(dirname, feeded_var_names, target_vars, executor, main_program=None,
                         model_filename=None, params_filename=None, scope=None):
    """Prune the program to what the targets need from the feeds and save
    program and parameters. Returns the target names."""
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    target_names = [v.name if hasattr(v, "name") else str(v) for v in target_vars]
    pruned = _prune_for_inference(main_program, feeded_var_names, target_names)
    model = {"program": pruned.to_dict(), "feed_names": list(feeded_var_names),
             "fetch_names": target_names}
    with open(os.path.join(dirname, model_filename or _MODEL_FILENAME), "w") as f:
        json.dump(model, f)
    serialization.save(_persistable_dict(pruned, scope),
                       os.path.join(dirname, params_filename or _PARAMS_FILENAME))
    return target_names


def load_inference_model(dirname, executor, model_filename=None, params_filename=None,
                         scope=None):
    """Returns ``(program, feed_names, fetch_names)``; the parameters go
    into ``scope`` (the global scope by default) with the dtypes they were
    saved in, int8 weights as int8."""
    from ..convert import int8_model_from_numpy

    with open(os.path.join(dirname, model_filename or _MODEL_FILENAME)) as f:
        model = json.load(f)
    state = serialization.load(os.path.join(dirname, params_filename or _PARAMS_FILENAME),
                               return_numpy=True)
    program, _ = int8_model_from_numpy(model["program"], state, scope or global_scope())
    return program, model["feed_names"], model["fetch_names"]


def _prune_for_inference(program, feed_names, target_names):
    """Keep the forward subgraph producing target_names from feed_names."""
    block = program.global_block()
    kept_idx = []
    needed = set(target_names)
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if set(op.output_names()) & needed:
            kept_idx.append(i)
            needed |= set(op.input_names())
    kept_idx.reverse()
    pruned = Program.from_dict(program.to_dict())
    pblock = pruned.global_block()
    pblock.ops = [pblock.ops[i] for i in kept_idx]
    used = set()
    for op in pblock.ops:
        used |= set(op.input_names()) | set(op.output_names())
    pblock.vars = {n: v for n, v in pblock.vars.items() if n in used}
    return pruned
