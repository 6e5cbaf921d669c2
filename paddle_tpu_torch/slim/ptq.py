"""Post-training quantization for static programs (``paddle_tpu/slim/ptq.py``).

Calibrate activation scales by feeding sample batches, quantize the weights
per tensor (abs-max), insert ``quant_dequant_static`` simulation ops, then
lower the calibrated program to a deployable int8 one: real int8 weights,
one ``quantize_static`` per activation and ``mul_int8`` / ``matmul_int8``
contractions. The arithmetic on weights and scales is numpy on the host,
statement for statement the JAX package's, so the same float32 weights and
calibration batches give bit-equal int8 weights in both packages.

The JAX package leaves flight-recorder events here (a zero scale clamped, an
int8 model saved); the port has no monitor yet, so it records none.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..errors import InvalidArgumentError
from ..static import io as static_io
from ..static.executor import global_scope
from ..static.program import OpDesc, Program

__all__ = ["QUANT_METADATA_FILENAME", "quantize_static_program", "rewrite_int8_program",
           "PostTrainingQuantization", "load_quant_metadata"]

_QUANTIZABLE = ("mul", "matmul", "conv2d")

#: scale metadata sidecar written next to the saved int8 program
QUANT_METADATA_FILENAME = "__quant__.json"

# calibration floor: a dead activation (abs-max 0.0) must never produce a 0
# scale, which would dequantize to NaN/inf at serving time
_SCALE_EPS = 1e-8


def _clamped_scale(name, raw):
    """A calibrated scale clamped away from zero. The quantized values of
    an all-zero variable are all 0 anyway, so the clamp is exact."""
    s = float(raw)
    return s if s > _SCALE_EPS else _SCALE_EPS


def _collect_var_abs_max(program, scope, exe, feed_batches, var_names):
    """Run the calibration batches, one ``exe.run`` each fetching every
    listed var, and record each var's abs-max. A var nothing produces
    raises before anything runs."""
    var_names = list(var_names)
    produced = set()
    for blk in program.blocks:
        for op in blk.ops:
            produced.update(op.output_names())
        produced.update(name for name, var in blk.vars.items() if var.is_data)
    for feed in feed_batches:
        produced.update(feed)
    missing = sorted(set(var_names) - produced)
    if missing:
        raise InvalidArgumentError(
            f"calibration vars {missing} are not produced by any op in the program (pruned "
            f"or renamed?); the fetched set must equal the requested set "
            f"({len(var_names)} vars)")
    maxes = {n: 0.0 for n in var_names}
    for feed in feed_batches:
        outs = exe.run(program, feed=feed, fetch_list=var_names, scope=scope)
        for n, v in zip(var_names, outs):
            maxes[n] = max(maxes[n], float(np.max(np.abs(np.asarray(v)))))
    return maxes


def quantize_static_program(program, scope, exe, feed_batches, *, weight_bits=8,
                            activation_bits=8):
    """Calibrate and insert the simulation ops. Mutates ``program``: every
    quantizable op's activation input gets a ``quant_dequant_static`` op
    with its calibrated scale; weight inputs (persistable vars) are
    quant-dequantized in the scope. Returns ``{var_name: scale}``."""
    block = program.global_block()
    act_inputs = []
    weight_inputs = set()
    for op in block.ops:
        if op.type not in _QUANTIZABLE:
            continue
        for n in op.inputs.get("X", []):
            if (block.has_var(n) and block.var(n).persistable) or scope.has(n):
                weight_inputs.add(n)
            else:
                act_inputs.append(n)
    act_inputs = sorted(set(act_inputs))

    scales = _collect_var_abs_max(program, scope, exe, feed_batches, act_inputs)
    scales = {n: _clamped_scale(n, s) for n, s in scales.items()}

    bnt_w = float((1 << (weight_bits - 1)) - 1)
    for n in sorted(weight_inputs):
        w = scope.numpy(n)
        s = _clamped_scale(n, float(np.max(np.abs(w))))
        q = np.round(np.clip(w / s * bnt_w, -bnt_w, bnt_w))
        scope.set(n, (q * s / bnt_w).astype(w.dtype))
        scales[n] = s

    new_ops = []
    renamed = {}
    for op in block.ops:
        if op.type in _QUANTIZABLE:
            new_inputs = {}
            for slot, names in op.inputs.items():
                out_names = []
                for n in names:
                    if n in scales and n not in weight_inputs:
                        if n not in renamed:
                            qn = program._unique_name(f"{n}.quantized")
                            src = block.var(n)
                            block.create_var(name=qn, shape=src.shape, dtype=str(src.dtype))
                            new_ops.append(OpDesc(
                                "quant_dequant_static", {"X": [n]}, {"Out": [qn]},
                                {"scale": float(scales[n]), "bit_length": activation_bits}))
                            renamed[n] = qn
                        out_names.append(renamed[n])
                    else:
                        out_names.append(n)
                new_inputs[slot] = out_names
            op.inputs = new_inputs
        new_ops.append(op)
    block.ops[:] = new_ops
    program._version += 1
    return scales


def rewrite_int8_program(program, scope, scales, *, weight_bits=8, activation_bits=8):
    """Lower a calibrated simulation program to a deployable int8 one.

    Returns ``(new_program, int8_weights)``; the input program is untouched.
    Every quantized weight is stored as a real int8 array in the scope under
    ``<w>@int8`` (exact: the scope value already sits on the int8 grid).
    ``mul`` / ``matmul`` ops whose activation carries a calibrated scale and
    whose second operand is a quantized weight become ``mul_int8`` /
    ``matmul_int8`` fed by one ``quantize_static`` op. Ops with no int8
    compute path (``conv2d``, a product whose weight comes first) keep the
    simulation op for their activation and still ship the int8 weight,
    restored by a ``dequantize_static`` that constant folding collapses at
    load.
    """
    bnt_w = float((1 << (weight_bits - 1)) - 1)
    prog = Program.from_dict(program.to_dict())
    block = prog.global_block()

    qdq_of = {}  # qdq output name -> (base name, scale)
    for op in block.ops:
        if op.type == "quant_dequant_static":
            qdq_of[op.outputs["Out"][0]] = (op.inputs["X"][0], float(op.attrs["scale"]))

    def is_weight(n):
        return n in scales and ((block.has_var(n) and block.var(n).persistable) or scope.has(n))

    int8_ops = {}  # id(op) -> (act_qdq_name, weight_name)
    for op in block.ops:
        if op.type not in ("mul", "matmul"):
            continue
        ins = op.inputs.get("X", [])
        if len(ins) != 2:
            continue
        a, w = ins
        if a in qdq_of and is_weight(w):
            int8_ops[id(op)] = (a, w)

    # a qdq op all of whose consumers went int8 is replaced by
    # quantize_static; mixed consumers keep both
    qdq_consumers = {}  # qdq name -> [total, int8]
    for op in block.ops:
        for n in op.input_names():
            if n in qdq_of:
                stats = qdq_consumers.setdefault(n, [0, 0])
                stats[0] += 1
                if id(op) in int8_ops:
                    stats[1] += 1

    int8_weights = {}

    def quantized_weight(w):
        qname = f"{w}@int8"
        if qname not in int8_weights:
            arr = scope.numpy(w)
            s = scales[w]
            q = np.round(np.clip(arr / s * bnt_w, -bnt_w, bnt_w)).astype(np.int8)
            int8_weights[qname] = q
            scope.set(qname, q)
            block.create_var(name=qname, shape=list(q.shape), dtype="int8", persistable=True)
        return qname

    new_ops = []
    for op in block.ops:
        if op.type == "quant_dequant_static":
            qn = op.outputs["Out"][0]
            base, scale = qdq_of[qn]
            total, as_int8 = qdq_consumers.get(qn, [0, 0])
            if as_int8:
                q8 = f"{base}@q8"
                block.create_var(name=q8, shape=block.var(base).shape, dtype="int8")
                new_ops.append(OpDesc("quantize_static", {"X": [base]}, {"Out": [q8]},
                                      {"scale": scale, "bit_length": activation_bits}))
            if as_int8 < total or total == 0:
                new_ops.append(op)  # non-int8 consumers still need the simulation
            continue

        if id(op) in int8_ops:
            a, w = int8_ops[id(op)]
            base, scale_a = qdq_of[a]
            attrs = dict(op.attrs)
            attrs.update(scale_x=scale_a, scale_y=scales[w], bit_length=activation_bits,
                         y_bit_length=weight_bits)
            new_ops.append(OpDesc(f"{op.type}_int8",
                                  {"X": [f"{base}@q8", quantized_weight(w)]},
                                  dict(op.outputs), attrs))
            continue

        if op.type in _QUANTIZABLE:
            new_inputs = {}
            for slot, names in op.inputs.items():
                out_names = []
                for n in names:
                    if is_weight(n):
                        qname = quantized_weight(n)
                        deq = f"{n}@deq"
                        if not block.has_var(deq):
                            src = block.var(n)
                            block.create_var(name=deq, shape=src.shape, dtype=str(src.dtype))
                            new_ops.append(OpDesc(
                                "dequantize_static", {"X": [qname]}, {"Out": [deq]},
                                {"scale": scales[n], "bit_length": weight_bits,
                                 "dtype": str(src.dtype)}))
                        out_names.append(deq)
                    else:
                        out_names.append(n)
                new_inputs[slot] = out_names
            new_ops.append(OpDesc(op.type, new_inputs, dict(op.outputs), dict(op.attrs)))
            continue

        new_ops.append(op)
    block.ops[:] = new_ops
    prog._version += 1
    return prog, int8_weights


class PostTrainingQuantization:
    """``post_training_quantization.py`` facade over the passes above."""

    def __init__(self, executor, program, feed_batches, scope=None, weight_bits=8,
                 activation_bits=8):
        self._exe = executor
        self._program = program
        self._batches = list(feed_batches)
        self._scope = scope or global_scope()
        self._wbits = weight_bits
        self._abits = activation_bits
        self.scales = None

    def quantize(self):
        self.scales = quantize_static_program(
            self._program, self._scope, self._exe, self._batches,
            weight_bits=self._wbits, activation_bits=self._abits)
        return self._program

    def save_quantized_model(self, dirname, feed_names, fetch_vars):
        """Save the simulation program (float32 weights on the int8 grid)."""
        return static_io.save_inference_model(dirname, feed_names, fetch_vars, self._exe,
                                              main_program=self._program, scope=self._scope)

    def save_int8_model(self, dirname, feed_names, fetch_vars):
        """Save a deployable int8 inference program: real int8 weights and
        per-tensor activation scales (:func:`rewrite_int8_program`), plus a
        ``__quant__.json`` sidecar with the scale metadata (bits, per-var
        scales, int8 weight names). Returns the fetch names."""
        if self.scales is None:
            raise RuntimeError("save_int8_model needs calibrated scales; call quantize() first")
        prog, int8_weights = rewrite_int8_program(
            self._program, self._scope, self.scales, weight_bits=self._wbits,
            activation_bits=self._abits)
        out = static_io.save_inference_model(dirname, feed_names, fetch_vars, self._exe,
                                             main_program=prog, scope=self._scope)
        meta = {"version": 1, "weight_bits": self._wbits, "activation_bits": self._abits,
                "scales": {n: float(s) for n, s in self.scales.items()},
                "int8_weights": sorted(int8_weights)}
        with open(os.path.join(dirname, QUANT_METADATA_FILENAME), "w") as f:
            json.dump(meta, f)
        return out


def load_quant_metadata(dirname):
    """The ``__quant__.json`` sidecar ``save_int8_model`` wrote (None when
    the directory holds no quantized model)."""
    path = os.path.join(dirname, QUANT_METADATA_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
