"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Counterpart of ``paddle_tpu/ops/pallas/_platform.py``: where the JAX package
asks whether it runs on a TPU, the port builds its kernels for the card.
Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` at first use into
``<repo>/build/paddle_tpu_torch/`` and named by a hash of its source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once. PyTorch's own
extension builder is not used: it compiles PyTorch's headers, which costs
minutes a build; the C interface takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["CSRC_DIR", "BUILD_DIR", "KERNEL_SOURCES", "nvcc_path", "library", "build_all",
           "check"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "paddle_tpu_torch")
KERNEL_SOURCES = ("layernorm_residual", "layernorm_residual_bwd", "flash_attention",
                  "flash_attention_bwd")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, the PATH, or ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit on PATH")


def _target(name: str) -> tuple:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def _start(name: str):
    """Start ``nvcc`` for one source; returns (so_path, tmp_path, process),
    with process None when the library is already built."""
    src, so = _target(name)
    if os.path.exists(so):
        return so, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    return so, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(name: str, so: str, tmp, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                           f"{out.decode(errors='replace')}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees the whole library or none


def build_all(names=KERNEL_SOURCES) -> None:
    """Compile every kernel source not built yet, one ``nvcc`` each, all
    running at once."""
    with _lock:
        started = [(n, *_start(n)) for n in names if n not in _libs]
        for name, so, tmp, proc in started:
            _finish(name, so, tmp, proc)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            so, tmp, proc = _start(name)
            _finish(name, so, tmp, proc)
            _libs[name] = ctypes.CDLL(so)
        return _libs[name]


def check(err: int, kernel: str) -> None:
    """Raise when a kernel's C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
