"""Host C++ pieces of the port (``paddle_tpu/_native``): not kernels.

- ``shm_ring.cpp``: the DataLoader's shared-memory transport, one
  single-producer single-consumer byte ring per worker (:class:`ShmRing`);
- ``datafeed.cpp``: the MultiSlot text parser of ``io.InMemoryDataset`` and
  ``io.QueueDataset`` (:func:`multislot_parse`).

Each source is compiled with the host ``g++`` at first use into
``build/paddle_tpu_torch/native/`` beside the package (or
``$PADDLE_TPU_TORCH_NATIVE_CACHE``), named by the hash of the source, and
loaded through ctypes. Without a compiler :func:`available` and
:func:`datafeed_available` are False and the callers take the JAX
package's fallbacks: the ``multiprocessing`` queue, the Python tokenizer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import subprocess
import time

_HERE = os.path.dirname(__file__)
_CACHE = os.environ.get("PADDLE_TPU_TORCH_NATIVE_CACHE") or os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), "build", "paddle_tpu_torch", "native")


def _build(name: str, src_file: str) -> str:
    """Compile a .cpp into a cached shared object; returns the .so path."""
    src_path = os.path.join(_HERE, src_file)
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_CACHE, exist_ok=True)
    so_path = os.path.join(_CACHE, f"{name}-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        src_path, "-o", tmp, "-lrt", "-pthread",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so_path)
    return so_path


class ShmRing:
    """SPSC shared-memory record ring (one per DataLoader worker)."""

    _lib = None

    @classmethod
    def _load(cls):
        if cls._lib is None:
            lib = ctypes.CDLL(_build("shm_ring", "shm_ring.cpp"))
            lib.shmring_open.restype = ctypes.c_void_p
            lib.shmring_open.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
            ]
            lib.shmring_push.restype = ctypes.c_int
            lib.shmring_push.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ]
            lib.shmring_next_size.restype = ctypes.c_int64
            lib.shmring_next_size.argtypes = [ctypes.c_void_p]
            lib.shmring_pop.restype = ctypes.c_int64
            lib.shmring_pop.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ]
            lib.shmring_used.restype = ctypes.c_uint64
            lib.shmring_used.argtypes = [ctypes.c_void_p]
            lib.shmring_close.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ]
            cls._lib = lib
        return cls._lib

    def __init__(self, name=None, capacity=64 << 20, owner=True):
        lib = self._load()
        self.name = name or f"/ptt_ring_{os.getpid()}_{id(self) & 0xFFFF}"
        self.capacity = capacity
        self._owner = owner
        self._handle = lib.shmring_open(
            self.name.encode(), capacity, 1 if owner else 0
        )
        if not self._handle:
            raise OSError(f"shmring_open({self.name}) failed")

    # -- raw bytes ----------------------------------------------------------
    def push_bytes(self, payload: bytes, timeout=30.0):
        lib = self._lib
        deadline = time.monotonic() + timeout
        while True:
            rc = lib.shmring_push(self._handle, payload, len(payload))
            if rc == 0:
                return
            if rc == -2:
                raise ValueError(
                    f"record of {len(payload)} bytes exceeds ring capacity "
                    f"{self.capacity}"
                )
            if time.monotonic() > deadline:
                raise TimeoutError("shm ring full")
            time.sleep(0.0005)

    def pop_bytes(self, timeout=30.0):
        lib = self._lib
        deadline = time.monotonic() + timeout
        while True:
            n = lib.shmring_next_size(self._handle)
            if n >= 0:
                buf = ctypes.create_string_buffer(n)
                got = lib.shmring_pop(self._handle, buf, n)
                if got == n:
                    return buf.raw
            if time.monotonic() > deadline:
                raise TimeoutError("shm ring empty")
            time.sleep(0.0005)

    # -- pickled objects ----------------------------------------------------
    def put(self, obj, timeout=30.0):
        self.push_bytes(pickle.dumps(obj, protocol=4), timeout)

    def get(self, timeout=30.0):
        return pickle.loads(self.pop_bytes(timeout))

    def empty(self):
        return self._lib.shmring_used(self._handle) == 0

    def close(self, unlink=None):
        if self._handle:
            self._lib.shmring_close(
                self._handle, self.name.encode(),
                1 if (self._owner if unlink is None else unlink) else 0,
            )
            self._handle = None

    def __del__(self):
        try:
            self.close(unlink=False)
        except Exception:
            pass


def available() -> bool:
    try:
        ShmRing._load()
        return True
    except Exception:
        return False


_datafeed_lib = [None]


def _load_datafeed():
    if _datafeed_lib[0] is None:
        lib = ctypes.CDLL(_build("datafeed", "datafeed.cpp"))
        LL = ctypes.c_longlong
        lib.pt_multislot_parse.restype = LL
        lib.pt_multislot_parse.argtypes = [
            ctypes.c_char_p, LL,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(LL), LL,
            ctypes.POINTER(LL), LL,
            ctypes.POINTER(ctypes.c_float), LL,
            ctypes.POINTER(LL), ctypes.POINTER(LL),
        ]
        _datafeed_lib[0] = lib
    return _datafeed_lib[0]


def multislot_parse(buf: bytes, slot_is_float):
    """Parse MultiSlot text (data_feed.cc format) via the native parser.

    Returns (counts[n_inst, n_slots] int64, ints int64[], floats float32[]).
    Raises ValueError on malformed input (with the byte offset).
    """
    import numpy as np

    lib = _load_datafeed()
    LL = ctypes.c_longlong
    n_slots = len(slot_is_float)
    sif = (ctypes.c_int * n_slots)(*[1 if f else 0 for f in slot_is_float])
    ti, tf = LL(0), LL(0)
    # pass 1: size
    n_inst = lib.pt_multislot_parse(
        buf, len(buf), sif, n_slots,
        None, 0, None, 0, None, 0,
        ctypes.byref(ti), ctypes.byref(tf),
    )
    if n_inst < 0:
        raise ValueError(
            f"malformed MultiSlot record near byte {-(n_inst + 1)}"
        )
    counts = np.zeros(n_inst * n_slots, np.int64)
    ints = np.zeros(max(1, ti.value), np.int64)
    floats = np.zeros(max(1, tf.value), np.float32)
    rc = lib.pt_multislot_parse(
        buf, len(buf), sif, n_slots,
        counts.ctypes.data_as(ctypes.POINTER(LL)), counts.size,
        ints.ctypes.data_as(ctypes.POINTER(LL)), ints.size,
        floats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), floats.size,
        ctypes.byref(ti), ctypes.byref(tf),
    )
    if rc != n_inst:
        raise ValueError("MultiSlot parse pass mismatch")
    return (counts.reshape(n_inst, n_slots), ints[:ti.value],
            floats[:tf.value])


def datafeed_available() -> bool:
    try:
        _load_datafeed()
        return True
    except Exception:
        return False
