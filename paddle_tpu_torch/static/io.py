"""Static-graph model serialization (``paddle_tpu/static/io.py``).

``<dir>/__model__`` holds the pruned Program as JSON with its feed and fetch
names, ``<dir>/__params__`` every persistable variable in one
``framework.serialization`` file: the JAX package's file names and keys, so
a directory either package writes loads in the other. ``save``/``load``
write and read ``<path>.pdparams`` (the persistables) and ``<path>.pdmodel``
(the program); ``save_persistables``/``load_persistables`` one file of
persistables in a directory (``__params__`` unless named), the checkpoint
of a static training run. Each takes the global scope unless given one.
"""
from __future__ import annotations

import json
import os

from ..framework import serialization
from .executor import global_scope
from .program import Program, default_main_program

__all__ = ["save", "load", "save_persistables", "load_persistables", "save_inference_model",
           "load_inference_model"]

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


def save(program, model_path, protocol=4, scope=None):
    """``paddle.static.save``: the program's persistables to
    ``<model_path>.pdparams``, the program to ``<model_path>.pdmodel``."""
    d = os.path.dirname(model_path)
    if d:
        os.makedirs(d, exist_ok=True)
    serialization.save(_persistable_dict(program, scope), model_path + ".pdparams")
    with open(model_path + ".pdmodel", "wb") as f:
        f.write(program.serialize_to_string())


def load(program, model_path, executor=None, var_list=None, scope=None):
    """``paddle.static.load``: the persistables of ``program`` (or of
    ``var_list``) found in ``<model_path>.pdparams`` into the scope."""
    state = serialization.load(model_path + ".pdparams", return_numpy=True)
    scope = scope or global_scope()
    names = ([v.name for v in var_list] if var_list is not None
             else [v.name for v in program.list_vars() if v.persistable])
    for name in names:
        if name in state:
            scope.set(name, state[name])
    return program


def save_persistables(executor, dirname, main_program=None, filename=None, scope=None):
    """``fluid.io.save_persistables``: every persistable of the program in
    one file."""
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    serialization.save(_persistable_dict(main_program, scope),
                       os.path.join(dirname, filename or _PARAMS_FILENAME))


def load_persistables(executor, dirname, main_program=None, filename=None, scope=None):
    """Every variable of a :func:`save_persistables` file into the scope."""
    state = serialization.load(os.path.join(dirname, filename or _PARAMS_FILENAME),
                               return_numpy=True)
    scope = scope or global_scope()
    for name, arr in state.items():
        scope.set(name, arr)


def save_inference_model(dirname, feeded_var_names, target_vars, executor, main_program=None,
                         model_filename=None, params_filename=None, **kwargs):
    """Prune the program to what the targets need from the feeds and save
    program and parameters, read from ``scope=`` (a keyword; the global
    scope by default). Returns the target names. Other keywords are
    accepted and not kept, as in the JAX package."""
    scope = kwargs.get("scope")
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
