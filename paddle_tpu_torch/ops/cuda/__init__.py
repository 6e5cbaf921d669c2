"""Hand-written CUDA kernels for Hopper, one module each beside its plain version.

Every wrapper counts its kernel's launches in a module-level integer;
:data:`KERNEL_COUNTERS` names them, :func:`launch_counts` reads them all
and :func:`reset_launch_counts` sets them to 0.
"""
from __future__ import annotations

from . import flash_attention, layernorm_residual

__all__ = ["KERNEL_COUNTERS", "launch_counts", "reset_launch_counts"]

#: kernel name -> (the module holding its wrapper, the name of its count)
KERNEL_COUNTERS = {
    "layernorm_residual_fwd": (layernorm_residual, "LAUNCHES"),
    "layernorm_residual_bwd": (layernorm_residual, "BWD_LAUNCHES"),
    "flash_attention_fwd": (flash_attention, "LAUNCHES"),
    "flash_attention_bwd_dq": (flash_attention, "DQ_LAUNCHES"),
    "flash_attention_bwd_dkv": (flash_attention, "DKV_LAUNCHES"),
}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNEL_COUNTERS.values():
        with mod._count_lock:
            setattr(mod, attr, 0)
