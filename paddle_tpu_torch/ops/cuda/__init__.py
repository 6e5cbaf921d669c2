"""Hand-written CUDA kernels for Hopper, one module each beside its plain version.

Every wrapper counts its kernel launches in its module's ``LAUNCHES``;
:func:`launch_counts` reads them all and :func:`reset_launch_counts` sets
them to 0.
"""
from __future__ import annotations

from . import flash_attention, layernorm_residual

__all__ = ["KERNEL_MODULES", "launch_counts", "reset_launch_counts"]

#: kernel name -> the module holding its wrapper and ``LAUNCHES`` count
KERNEL_MODULES = {
    "layernorm_residual_fwd": layernorm_residual,
    "flash_attention_fwd": flash_attention,
}


def launch_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        with mod._count_lock:
            mod.LAUNCHES = 0
