"""int8 x int8 -> int32 matrix product: the CUDA kernel and its plain version.

Replaces ``paddle_tpu/ops/pallas/int8_matmul.py`` ``_pallas_matmul``:
``x [M, K] int8 @ w [K, N] int8 -> [M, N] int32`` with exact 32-bit
accumulation, the contraction of the deployed int8 programs' ``mul_int8``
and ``matmul_int8`` ops. ``csrc/int8_matmul.cu`` runs it on the tensor
cores (``mma.sync.m16n8k32``) from a ring of 64-deep K slabs filled by
``cp.async``, packing ``w``'s K values on the way to the fragments, and
masks ragged edges with zeros, which is exact: any M, K and N, no padded
copies and no size rule (the TPU kernel's ``M*N >= 32*128`` cut-off was its
tiling's). Where the output tiles do not fill the card it splits K
(:func:`_split_k`, the plan the C side makes too) and adds the slices into
a zeroed output by integer atomics, exact in any order. Memory bound at the
serving shapes: the int32 output is four bytes an element.

The plain version is the int32 product on the CPU. The card has no integer
matrix product in PyTorch, so there :func:`_plain_int8_matmul` multiplies
the int8 values in float64 and casts back, exact while ``K * 2**14 <
2**53``; it is the reference the kernel is held against, not a route of
the port.

A tensor on the CPU takes the plain version; a tensor on the card launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from ._tally import bump

__all__ = ["int8_matmul", "LAUNCHES", "SPLITS"]

#: kernel launches since the last reset (counted where the kernel launches)
LAUNCHES = 0
#: launches that split K (each also counts one in ``LAUNCHES``)
SPLITS = 0
_count_lock = threading.Lock()

# the kernel's tiles (csrc/int8_matmul.cu kBM, kBN, kBK): output rows and
# columns a block, and the depth of one slab of K
_TILE_ROWS, _TILE_COLS, _SLAB = 128, 128, 128
# split-K (kWave, kMinSliceSlabs): split when the output tiles are fewer
# than the card's 132 SMs, into at most as many slices as make one block an
# SM (a second block an SM from more slices cost more in zeroing and atomic
# adds than it gained on the H100), none much shallower than
# _MIN_SLICE_SLABS slabs
_WAVE = 132
_MIN_SLICE_SLABS = 2

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1


def _split_k(m, k, n):
    """``(slices, slice_slabs)`` of ``[m, k] @ [k, n]``: one slice when its
    output tiles are at least ``_WAVE``; else as many slices of whole slabs
    as make ``_WAVE`` blocks, but no more than slices of
    ``_MIN_SLICE_SLABS`` slabs would make, and none empty.
    ``csrc/int8_matmul.cu`` ``plan`` is the same."""
    tiles = -(-m // _TILE_ROWS) * -(-n // _TILE_COLS)
    slabs = -(-k // _SLAB)
    want = 1 if tiles >= _WAVE else max(1, min(_WAVE // tiles, -(-slabs // _MIN_SLICE_SLABS)))
    per = -(-slabs // want)
    return -(-slabs // per), per


def _plain_int8_matmul(x, w):
    """The exact product in tensor ops: int32 on the CPU, float64 cast back
    elsewhere (every partial sum is an integer below 2**53)."""
    if x.device.type == "cpu":
        return x.to(torch.int32) @ w.to(torch.int32)
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


@torch.no_grad()
def int8_matmul(x, w):
    """``x [M, K] int8 @ w [K, N] int8 -> [M, N] int32``, exact."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} and w {tuple(w.shape)} are not "
                         f"[M, K] and [K, N]")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {x.dtype} and {w.dtype}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return _plain_int8_matmul(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("int8_matmul: both operands must be on one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("int8_matmul: x and w must be contiguous (row-major)")
    (m, k), n = x.shape, w.shape[1]
    if max(m, k, n) > _INT_MAX:
        raise ValueError(f"int8_matmul: an extent of {(m, k, n)} exceeds 32 bits")
    if m == 0 or n == 0 or k == 0:  # nothing is launched or counted
        return torch.zeros((m, n), dtype=torch.int32, device=x.device)
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        fn = _build.library("int8_matmul").ptt_int8_matmul
        if fn.argtypes is None:
            fn.argtypes = _ARGS
            fn.restype = ctypes.c_int
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_matmul")
    with _count_lock:
        bump(globals(), "LAUNCHES")
        bump(globals(), "SPLITS", int(_split_k(m, k, n)[0] > 1))
    return out
