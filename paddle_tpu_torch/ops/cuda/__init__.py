"""Hand-written CUDA kernels for Hopper, one module each beside its plain version.

Every wrapper counts its kernel's launches in a module-level integer (one
for each dtype a kernel takes: the bf16 LayerNorm, attention, fused conv
and max-pool backward kernels count apart from the float32 ones, and the
LayerNorm forward's mixed instance apart from both);
:data:`KERNEL_COUNTERS` names them, :func:`launch_counts` reads them all
and :func:`reset_launch_counts` sets them to 0, and the counts beside them
(:data:`OTHER_COUNTERS`: the tensors the momentum launches updated, the
eval conv products and the int8 products that took split-K).
:func:`counts` reads both kinds and :func:`add_counts` adds to them: a
step captured in a CUDA graph (``runtime/compiled.py``) takes back what
its wrappers counted while the capture recorded, and launched nothing,
and adds it again at each replay, which launches those kernels. What the
capture counted is read from a tally of the capture's stream
(:func:`tallied`), so the launches other threads count during a capture
(replicas replaying other graphs) are neither taken back nor booked to
the captured graph, and the backward kernels the autograd engine launches
for a captured train step are.
"""
from __future__ import annotations

import contextlib

from . import (_tally, conv_bn_relu, flash_attention, int8_matmul, layernorm_residual,
               optimizer_update, pool_backward)

__all__ = ["KERNEL_COUNTERS", "OTHER_COUNTERS", "launch_counts", "reset_launch_counts",
           "counts", "add_counts", "tallied"]

#: kernel name -> (the module holding its wrapper, the name of its count)
KERNEL_COUNTERS = {
    "layernorm_residual_fwd": (layernorm_residual, "LAUNCHES"),
    "layernorm_residual_bwd": (layernorm_residual, "BWD_LAUNCHES"),
    "flash_attention_fwd": (flash_attention, "LAUNCHES"),
    "flash_attention_bwd_dq": (flash_attention, "DQ_LAUNCHES"),
    "flash_attention_bwd_dkv": (flash_attention, "DKV_LAUNCHES"),
    "layernorm_residual_fwd_bf16": (layernorm_residual, "BF16_LAUNCHES"),
    "layernorm_residual_bwd_bf16": (layernorm_residual, "BF16_BWD_LAUNCHES"),
    "layernorm_residual_fwd_mixed": (layernorm_residual, "MIXED_LAUNCHES"),
    "flash_attention_fwd_bf16": (flash_attention, "BF16_LAUNCHES"),
    "flash_attention_bwd_dq_bf16": (flash_attention, "BF16_DQ_LAUNCHES"),
    "flash_attention_bwd_dkv_bf16": (flash_attention, "BF16_DKV_LAUNCHES"),
    "conv_bn_relu_mm_affine_relu": (conv_bn_relu, "MM_AFFINE_RELU_LAUNCHES"),
    "conv_bn_relu_mm_stats": (conv_bn_relu, "MM_STATS_LAUNCHES"),
    "conv_bn_relu_centered_sumsq": (conv_bn_relu, "CENTERED_SUMSQ_LAUNCHES"),
    "conv_bn_relu_bn_relu": (conv_bn_relu, "BN_RELU_LAUNCHES"),
    "conv_bn_relu_bn_bwd_partials": (conv_bn_relu, "BN_BWD_PARTIALS_LAUNCHES"),
    "conv_bn_relu_bn_bwd_dco": (conv_bn_relu, "BN_BWD_DCO_LAUNCHES"),
    "conv_bn_relu_mm_affine_relu_bf16": (conv_bn_relu, "BF16_MM_AFFINE_RELU_LAUNCHES"),
    "conv_bn_relu_mm_stats_bf16": (conv_bn_relu, "BF16_MM_STATS_LAUNCHES"),
    "conv_bn_relu_centered_sumsq_bf16": (conv_bn_relu, "BF16_CENTERED_SUMSQ_LAUNCHES"),
    "conv_bn_relu_bn_relu_bf16": (conv_bn_relu, "BF16_BN_RELU_LAUNCHES"),
    "conv_bn_relu_bn_bwd_partials_bf16": (conv_bn_relu, "BF16_BN_BWD_PARTIALS_LAUNCHES"),
    "conv_bn_relu_bn_bwd_dco_bf16": (conv_bn_relu, "BF16_BN_BWD_DCO_LAUNCHES"),
    "momentum_update": (optimizer_update, "LAUNCHES"),
    "int8_matmul": (int8_matmul, "LAUNCHES"),
    "max_pool2d_backward": (pool_backward, "LAUNCHES"),
    "max_pool2d_backward_bf16": (pool_backward, "BF16_LAUNCHES"),
}

#: counts that are not launches, set to 0 with them: (module, name)
OTHER_COUNTERS = ((optimizer_update, "TENSORS"), (conv_bn_relu, "MM_AFFINE_RELU_SPLITS"),
                  (int8_matmul, "SPLITS"))


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in (*KERNEL_COUNTERS.values(), *OTHER_COUNTERS):
        with mod._count_lock:
            setattr(mod, attr, 0)


def _every_counter():
    """count name -> (module, attribute), the launches' and the others'
    (named ``<module>.<attribute>``)."""
    out = dict(KERNEL_COUNTERS)
    for mod, attr in OTHER_COUNTERS:
        out[f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}"] = (mod, attr)
    return out


def counts() -> dict:
    """Every count: the launches of :func:`launch_counts` and the
    :data:`OTHER_COUNTERS`."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _every_counter().items()}


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (names as :func:`counts` gives them) to
    the counts."""
    every = _every_counter()
    for name, n in delta.items():
        if n:
            mod, attr = every[name]
            with mod._count_lock:
                _tally.bump(vars(mod), attr, sign * n)


@contextlib.contextmanager
def tallied(stream=None):
    """Yield a dict that, when the block ends, holds what the block counted
    (names as :func:`counts` gives them): every count bumped on ``stream``
    (a capture's, on the card, whatever thread bumps it), or with no
    stream every count this thread bumped; not what other streams or
    threads counted meanwhile."""
    raw = {}
    if stream is not None:
        _tally._by_stream[stream.cuda_stream] = raw
    else:
        prev = getattr(_tally._local, "tally", None)
        _tally._local.tally = raw
    out = {}
    try:
        yield out
    finally:
        if stream is not None:
            del _tally._by_stream[stream.cuda_stream]
        else:
            _tally._local.tally = prev
        names = {(mod.__name__, attr): name for name, (mod, attr) in _every_counter().items()}
        for key, n in raw.items():
            out[names[key]] = out.get(names[key], 0) + n
