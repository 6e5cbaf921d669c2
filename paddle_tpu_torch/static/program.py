"""Static-graph Program IR (``paddle_tpu/static/program.py``), the port's own copy.

``Program`` -> ``Block`` -> ``OpDesc`` / ``Variable``: an op is a type,
name-keyed input and output lists and attributes; a variable is symbolic
(name, shape, dtype, flags) and holds no storage. ``to_dict`` /
``from_dict`` keep the JAX package's JSON layout key for key, so a program
either package serialized loads in the other, nested blocks included: a
control-flow op (``control_flow.py``) names its sub-blocks by index in the
``BLOCK_ATTR_KEYS`` attributes. :func:`block_guard` makes a sub-block the
current block, the one ops are appended to (``:354``, ``:460``), and a
variable name resolves through the parent blocks (``:111``).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import sys
from typing import Any, Dict, List

import numpy as np

from ..framework.dtype import dtype_name

__all__ = ["VarDesc", "OpDesc", "Block", "Variable", "Program", "default_main_program",
           "default_startup_program", "reset_default_programs", "program_guard", "block_guard",
           "enable_static", "disable_static", "in_static_mode", "in_dynamic_mode", "data"]

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
        self._rng_counter = 0  # the next random op's __rng_id__
        # the executor keys its graphs by this, not id(): a freed program's
        # id may come back for a new one
        self._identity_token = next(_program_tokens)

    def global_block(self) -> Block:
        return self.blocks[0]

    def verify(self, feed_names=(), fetch_list=(), level="on"):
        """Run the program-IR verifier (``analysis/``) over this program
        (``paddle_tpu/static/program.py:254-290``).

        Returns the :class:`~paddle_tpu_torch.analysis.VerifyReport` when
        the program is well-formed (it may carry warnings); raises
        :class:`~paddle_tpu_torch.analysis.VerifyError` naming the
        offending block, op index, op type and var otherwise.
        ``level="strict"`` also fails on dead code.

        The verdict is cached per (program version, variable count, feeds,
        fetches, level): ``append_op`` and ``_create_block`` move the
        version, and the variable count re-arms a cached verdict when a
        variable is declared (``create_var`` moves no version), so the
        executor's automatic call costs one dict lookup in steady state.
        """
        fetch_names = tuple(v if isinstance(v, str) else v.name for v in (fetch_list or ()))
        n_vars = sum(len(b.vars) for b in self.blocks)
        key = (self._version, n_vars, tuple(sorted(feed_names or ())), fetch_names, level)
        # __dict__: a program built through from_dict has no cache attribute yet
        cache = self.__dict__.setdefault("_verify_cache", {})
        hit = cache.get(key)
        if hit is not None:
            cache.pop(key, None)
            cache[key] = hit  # LRU refresh
            if isinstance(hit, Exception):
                # a fresh traceback each raise: the cached instance's would grow
                raise hit.with_traceback(None)
            return hit
        from ..analysis import VerifyError, verify_program

        try:
            verdict = verify_program(self, key[2], fetch_names, level)
        except VerifyError as e:
            verdict = e
        cache[key] = verdict
        while len(cache) > 64:
            try:  # replica pools verify from several threads
                cache.pop(next(iter(cache)), None)
            except (StopIteration, RuntimeError):
                break
        # the verdict lands in the black box, so a rejected program is there
        # even when the raising process dies
        from ..monitor import flight_recorder as _flight

        failed = isinstance(verdict, Exception)
        fields = dict(program=f"{self._identity_token}@v{self._version}", ok=not failed,
                      warnings=0 if failed else len(verdict.warnings))
        if failed:
            fields["error"] = str(verdict)[:500]
        _flight.record_event("program_verify", **fields)
        if isinstance(verdict, Exception):
            raise verdict
        return verdict

    def plan_memory(self, feed_names=(), fetch_list=(), feed_shapes=None, top_k=8):
        """Static liveness and peak-memory plan of this program
        (:func:`paddle_tpu_torch.analysis.plan_memory`): the predicted peak
        resident bytes, the high-water op, the per-op resident curve and the
        top-K largest live tensors, from the IR alone. ``feed_shapes``
        (``{name: shape}``) concretizes ``-1`` batch dims."""
        from ..analysis import plan_memory as _plan

        fetch_names = tuple(v if isinstance(v, str) else v.name for v in (fetch_list or ()))
        return _plan(self, tuple(feed_names or ()), fetch_names, feed_shapes=feed_shapes,
                     top_k=top_k)

    def current_block(self) -> Block:
        return self.blocks[_current_block_idx[-1]] if _current_block_idx else self.blocks[0]

    def _create_block(self) -> Block:
        """A new nested block whose parent is the current block: the unit a
        control-flow op runs."""
        blk = Block(self, len(self.blocks), self.current_block().idx)
        self.blocks.append(blk)
        self._version += 1
        return blk

    def _unique_name(self, prefix):
        i = self._name_counter.get(prefix, 0)
        self._name_counter[prefix] = i + 1
        return f"{prefix}_{i}"

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def clone(self, for_test=False):
        """A copy through ``to_dict``; ``for_test`` turns every op's
        ``training`` attribute off, in every block (dropout becomes the
        identity, batch norm reads its running statistics)."""
        prog = Program.from_dict(self.to_dict())
        if for_test:
            for blk in prog.blocks:
                for op in blk.ops:
                    if "training" in op.attrs:
                        op.attrs["training"] = False
        prog._name_counter = dict(self._name_counter)
        return prog

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

    def serialize_to_string(self) -> bytes:
        return json.dumps(self.to_dict()).encode()

    @classmethod
    def parse_from_string(cls, s: bytes):
        return cls.from_dict(json.loads(s.decode()))

    def __repr__(self):
        n_ops = sum(len(b.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={n_ops})"


# -- global default/startup programs + guards --------------------------------

_default_main_program = Program()
_default_startup_program = Program()
_current_block_idx: list = []
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
def block_guard(block):
    """Make ``block`` the current append target (control-flow sub-blocks)."""
    _current_block_idx.append(block.idx)
    try:
        yield block
    finally:
        _current_block_idx.pop()


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


def in_dynamic_mode() -> bool:
    return not _static_mode[0]


def data(name, shape, dtype="float32", lod_level=0):
    """``paddle.static.data``: declare a feed variable (``lod_level`` is
    accepted and not kept, as in the JAX package)."""
    blk = default_main_program().global_block()
    return blk.create_var(name=name, shape=shape, dtype=dtype, is_data=True)


_ops = sys.modules.get(__name__.rpartition(".")[0].rpartition(".")[0] + ".ops")
if _ops is not None and hasattr(_ops, "_bind_static"):
    _ops._bind_static(Variable, _static_mode)
