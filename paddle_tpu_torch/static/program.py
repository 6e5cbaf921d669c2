"""Static-graph Program IR (``paddle_tpu/static/program.py``), the port's own copy.

``Program`` -> ``Block`` -> ``OpDesc`` / ``Variable``: an op is a type,
name-keyed input and output lists and attributes; a variable is symbolic
(name, shape, dtype, flags) and holds no storage. ``to_dict`` /
``from_dict`` keep the JAX package's JSON layout key for key, so a program
either package serialized loads in the other. The port's executor
interprets the global block op by op (on the card, once per feed
signature, into a CUDA graph); nested blocks exist in the layout, but the
control-flow ops that would use them are not ported.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Any, Dict, List

import numpy as np

from ..framework.dtype import dtype_name

__all__ = ["VarDesc", "OpDesc", "Block", "Variable", "Program", "default_main_program",
           "default_startup_program", "reset_default_programs", "program_guard",
           "enable_static", "disable_static", "in_static_mode", "data"]

class VarDesc:
    def __init__(self, name, shape=None, dtype="float32", persistable=False,
                 stop_gradient=True, is_data=False):
        self.name = name
        self.shape = list(shape) if shape is not None else None
        self.dtype = dtype_name(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data

    def to_dict(self):
        return dict(name=self.name, shape=self.shape, dtype=self.dtype,
                    persistable=self.persistable, stop_gradient=self.stop_gradient,
                    is_data=self.is_data)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class OpDesc:
    """type + name-keyed input/output lists + attrs."""

    def __init__(self, op_type: str, inputs: Dict[str, List[str]],
                 outputs: Dict[str, List[str]], attrs: Dict[str, Any]):
        self.type = op_type
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = dict(attrs)

    def input_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def to_dict(self):
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, np.ndarray):
                attrs[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            else:
                attrs[k] = v
        return dict(type=self.type, inputs={k: list(v) for k, v in self.inputs.items()},
                    outputs={k: list(v) for k, v in self.outputs.items()}, attrs=attrs)

    @classmethod
    def from_dict(cls, d):
        attrs = {}
        for k, v in d["attrs"].items():
            if isinstance(v, dict) and "__ndarray__" in v:
                attrs[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
            else:
                attrs[k] = v
        return cls(d["type"], {k: list(v) for k, v in d["inputs"].items()},
                   {k: list(v) for k, v in d["outputs"].items()}, attrs)


class Variable:
    """Symbolic variable in a Block: metadata only, values live in a Scope."""

    def __init__(self, block, name, shape, dtype, persistable, stop_gradient, is_data):
        self.block = block
        self.name = name
        self.shape = list(shape) if shape is not None else None
        self.dtype = dtype_name(dtype)  # the canonical name: str(var.dtype) names it
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.is_parameter = False
        self.initializer = None

    @property
    def ndim(self):
        return len(self.shape)

    def desc_dict(self):
        return VarDesc(self.name, self.shape, self.dtype, self.persistable, self.stop_gradient,
                       self.is_data).to_dict()

    def numpy(self):
        raise RuntimeError(
            f"Variable {self.name!r} is symbolic; run it through an Executor to get values")

    def __repr__(self):
        return f"Variable(name={self.name}, shape={self.shape}, dtype={self.dtype})"


class Block:
    """Ordered op list + var map."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[OpDesc] = []

    def create_var(self, name=None, shape=None, dtype="float32", persistable=False,
                   stop_gradient=True, is_data=False):
        name = name or self.program._unique_name("tmp")
        var = Variable(self, name, shape, dtype, persistable, stop_gradient, is_data)
        self.vars[name] = var
        return var

    def create_parameter(self, name, shape, dtype="float32", initializer=None, trainable=True):
        var = self.create_var(name=name, shape=shape, dtype=dtype, persistable=True,
                              stop_gradient=not trainable)
        var.is_parameter = True
        var.initializer = initializer
        return var

    def var(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = self.program.blocks[blk.parent_idx] if blk.parent_idx >= 0 else None
        raise KeyError(f"variable {name!r} not found in block {self.idx}")

    def has_var(self, name):
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def append_op(self, op_type, inputs, outputs, attrs=None):
        op = OpDesc(op_type, inputs, outputs, attrs or {})
        self.ops.append(op)
        self.program._version += 1
        return op

    def to_dict(self):
        return dict(idx=self.idx, parent_idx=self.parent_idx,
                    vars=[v.desc_dict() for v in self.vars.values()],
                    ops=[op.to_dict() for op in self.ops])


# process-unique program identities (paddle_tpu/static/program.py:249)
_program_tokens = itertools.count()


class Program:
    def __init__(self):
        self.blocks = [Block(self, 0)]
        self._name_counter = {}
        self._version = 0
        self.random_seed = None
        self._constants = {}
        # the executor keys its graphs by this, not id(): a freed program's
        # id may come back for a new one
        self._identity_token = next(_program_tokens)

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[0]

    def _unique_name(self, prefix):
        i = self._name_counter.get(prefix, 0)
        self._name_counter[prefix] = i + 1
        return f"{prefix}_{i}"

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    # serialization ---------------------------------------------------------
    def to_dict(self):
        d = dict(blocks=[b.to_dict() for b in self.blocks], version=1)
        if self._constants:
            d["constants"] = {
                k: {"__ndarray__": np.asarray(v).tolist(), "dtype": str(np.asarray(v).dtype)}
                for k, v in self._constants.items()}
        return d

    @classmethod
    def from_dict(cls, data):
        prog = cls()
        prog.blocks = []
        for bd in data["blocks"]:
            blk = Block(prog, bd["idx"], bd["parent_idx"])
            prog.blocks.append(blk)
            for vd in bd["vars"]:
                v = VarDesc.from_dict(vd)
                blk.vars[v.name] = Variable(blk, v.name, v.shape, v.dtype, v.persistable,
                                            v.stop_gradient, v.is_data)
            blk.ops = [OpDesc.from_dict(od) for od in bd["ops"]]
        if data.get("constants"):
            prog._constants = {k: np.asarray(v["__ndarray__"], dtype=v["dtype"])
                               for k, v in data["constants"].items()}
        return prog

    def __repr__(self):
        n_ops = sum(len(b.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={n_ops})"


# -- global default/startup programs + guards --------------------------------

_default_main_program = Program()
_default_startup_program = Program()
_static_mode = [False]


def default_main_program() -> Program:
    return _default_main_program


def default_startup_program() -> Program:
    return _default_startup_program


def reset_default_programs():
    global _default_main_program, _default_startup_program
    _default_main_program = Program()
    _default_startup_program = Program()


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _default_main_program, _default_startup_program
    prev_main, prev_startup = _default_main_program, _default_startup_program
    _default_main_program = main_program
    if startup_program is not None:
        _default_startup_program = startup_program
    try:
        yield
    finally:
        _default_main_program, _default_startup_program = prev_main, prev_startup


def enable_static():
    _static_mode[0] = True


def disable_static():
    _static_mode[0] = False


def in_static_mode() -> bool:
    return _static_mode[0]


def data(name, shape, dtype="float32"):
    """``paddle.static.data``: declare a feed variable."""
    blk = default_main_program().global_block()
    return blk.create_var(name=name, shape=shape, dtype=dtype, is_data=True)
