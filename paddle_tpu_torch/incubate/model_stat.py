"""Program analysis utilities over the port's static ``Program`` (``paddle_tpu/incubate/model_stat.py``).

Reference parity: python/paddle/fluid/contrib/memory_usage_calc.py:46
(memory_usage), op_frequence.py:23 (op_freq_statistic): the JAX package's
dtype table, walk and returned values, over the port's ``Program``. Both
read only the program's descriptions, so they run without a card. The
FLOPs and parameter summary of the reference's model_stat.py is
``paddle.summary(net, input_size)`` (``hapi/model.py``).
"""
from __future__ import annotations

from collections import Counter, OrderedDict

from ..static.program import Program

__all__ = ["memory_usage", "op_freq_statistic"]

_DTYPE_SIZE = {
    "float64": 8, "int64": 8, "uint64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
}


def memory_usage(program, batch_size):
    """Estimate activation/parameter memory of a static program.

    Walks every op output var once, sizes it with negative dims bound to
    ``batch_size``, and returns ``(low, high, unit)`` — the reference's
    0.5x/1.5x band around the raw total (memory_usage_calc.py:110): the
    runtime may both reuse buffers (below) and double-buffer (above).
    """
    if not isinstance(program, Program):
        raise TypeError(
            "Calculating Memory Usage requires Program as its parameter, "
            f"but got {type(program).__name__}")
    if batch_size <= 0:
        raise ValueError("The batch size need to be positive.")

    total = 0.0
    seen = set()
    blk = program.global_block()
    for op in blk.ops:
        for names in op.outputs.values():
            for name in names:
                if name in seen or not blk.has_var(name):
                    continue
                seen.add(name)
                var = blk.var(name)
                shape = list(getattr(var, "shape", None) or [])
                count, neg = 1, 0
                for d in shape:
                    if d is None or int(d) < 0:
                        neg += 1
                        if neg > 1:
                            raise ValueError(
                                f"Var {name} has more than one "
                                "negative dim.")
                        count *= batch_size
                    else:
                        count *= int(d)
                total += count * _DTYPE_SIZE.get(
                    str(getattr(var, "dtype", "float32")), 4)

    low, high = total * 0.5, total * 1.5
    unit = "B"
    for u in ("KB", "MB", "GB"):
        if high < 1024:
            break
        low, high, unit = low / 1024, high / 1024, u
    return low, high, unit


def op_freq_statistic(program):
    """Op-type frequency of a program (op_frequence.py:23): returns
    (uni_op_freq, adj_op_freq) ordered most-common-first — single op
    counts and adjacent-pair counts."""
    if not isinstance(program, Program):
        raise TypeError(
            "The input type should be Program, but got "
            f"{type(program).__name__}")
    uni = Counter()
    adj = Counter()
    ops = program.global_block().ops
    for i, op in enumerate(ops):
        uni[op.type] += 1
        if i + 1 < len(ops):
            adj[f"{op.type}->{ops[i + 1].type}"] += 1
    order = lambda c: OrderedDict(c.most_common())  # noqa: E731
    return order(uni), order(adj)
