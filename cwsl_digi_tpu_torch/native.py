"""ctypes bindings for the native C++ runtime components (native/).

Provides:
- :class:`NativeRing` — lock-free block ring (reference: ring_buffer_spmc.h)
- :class:`NativeShmSource` — shared-memory IQ reader (reference:
  SharedMemory.cpp) exposing the same ``IQSource`` protocol as sdr/source.py
- :class:`NativePump` — native intake thread shm -> ring (reference:
  Receiver::readIQ)

The library builds on demand with ``make -C native`` (g++); when no
compiler or build fails, callers should fall back to the pure-Python
``sdr.shm.ShmSource`` (same wire layout — they interoperate).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libcwsl_native.so"
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def load(build: bool = True) -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and build:
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise NativeUnavailable(f"cannot build native lib: {e}") from e
    if not _LIB_PATH.exists():
        raise NativeUnavailable(f"{_LIB_PATH} missing")
    lib = ctypes.CDLL(str(_LIB_PATH))
    # signatures
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_add_reader.restype = ctypes.c_int
    lib.ring_add_reader.argtypes = [ctypes.c_void_p]
    lib.ring_push.restype = ctypes.c_int
    lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double]
    lib.ring_pop.restype = ctypes.c_int
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_double]
    lib.ring_write_count.restype = ctypes.c_uint64
    lib.ring_write_count.argtypes = [ctypes.c_void_p]
    lib.ring_pending.restype = ctypes.c_size_t
    lib.ring_pending.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cwsl_shm_open.restype = ctypes.c_void_p
    lib.cwsl_shm_open.argtypes = [ctypes.c_char_p]
    lib.cwsl_shm_close.argtypes = [ctypes.c_void_p]
    lib.cwsl_shm_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.cwsl_shm_read.restype = ctypes.c_int
    lib.cwsl_shm_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_double]
    lib.pump_start.restype = ctypes.c_void_p
    lib.pump_start.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.pump_stop.argtypes = [ctypes.c_void_p]
    lib.pump_blocks.restype = ctypes.c_uint64
    lib.pump_blocks.argtypes = [ctypes.c_void_p]
    lib.pump_dropped.restype = ctypes.c_uint64
    lib.pump_dropped.argtypes = [ctypes.c_void_p]
    lib.rs_ft_decode.restype = ctypes.c_double
    lib.rs_ft_decode.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.rs_ee_decode.restype = ctypes.c_int
    lib.rs_ee_decode.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int]
    lib.rs_encode63.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_int]
    _lib = lib
    return lib


def rs_ft_decode(k: int, syms: np.ndarray, margin: np.ndarray,
                 top_e: np.ndarray, top_tone: np.ndarray, e_sum: np.ndarray,
                 n_tones: int, trials: int, seed: int,
                 accept_thresh: float, early_exit: float = 0.8,
                 fcr: int = 1) -> tuple[np.ndarray, float] | None:
    """Native Franke-Taylor stochastic RS(63,k) list decode.

    Returns (info_symbols, soft_score) or None.  See native/rs_ft.cpp.
    """
    lib = load()
    syms = np.ascontiguousarray(syms, np.int32)
    margin = np.ascontiguousarray(margin, np.float32)
    top_e = np.ascontiguousarray(top_e, np.float32)
    top_tone = np.ascontiguousarray(top_tone, np.int32)
    e_sum = np.ascontiguousarray(e_sum, np.float32)
    out = np.zeros(k, np.int32)
    score = lib.rs_ft_decode(
        k, syms.ctypes.data, margin.ctypes.data, top_e.ctypes.data,
        top_tone.ctypes.data, e_sum.ctypes.data, n_tones, trials,
        seed & 0xFFFFFFFFFFFFFFFF, accept_thresh, early_exit,
        out.ctypes.data, fcr)
    if score <= -1e8:
        return None
    return out.astype(np.int64), float(score)


class NativeRing:
    """Single-producer multi-consumer block ring in native memory."""

    def __init__(self, block_bytes: int, n_blocks: int):
        self._lib = load()
        self.block_bytes = block_bytes
        self.n_blocks = n_blocks
        self._h = self._lib.ring_create(block_bytes, n_blocks)

    def add_reader(self) -> int:
        return self._lib.ring_add_reader(self._h)

    def push(self, data: np.ndarray, timeout: float = 1.0) -> bool:
        data = np.ascontiguousarray(data)
        assert data.nbytes == self.block_bytes
        return self._lib.ring_push(
            self._h, data.ctypes.data_as(ctypes.c_void_p), timeout) == 0

    def pop(self, reader: int, timeout: float = 1.0,
            dtype=np.complex64) -> Optional[np.ndarray]:
        out = np.empty(self.block_bytes // np.dtype(dtype).itemsize, dtype)
        rc = self._lib.ring_pop(self._h, reader,
                                out.ctypes.data_as(ctypes.c_void_p), timeout)
        return out if rc == 0 else None

    def pending(self, reader: int) -> int:
        return self._lib.ring_pending(self._h, reader)

    @property
    def write_count(self) -> int:
        return self._lib.ring_write_count(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeShmSource:
    """IQSource backed by the native shm reader (layout of sdr/shm.py)."""

    def __init__(self, name: str):
        self._lib = load()
        self._h = self._lib.cwsl_shm_open(name.encode())
        if not self._h:
            raise FileNotFoundError(f"shm segment {name!r} not found/invalid")
        sr = ctypes.c_uint32()
        bis = ctypes.c_uint32()
        l0 = ctypes.c_int64()
        nb = ctypes.c_uint32()
        self._lib.cwsl_shm_info(self._h, ctypes.byref(sr), ctypes.byref(bis),
                                ctypes.byref(l0), ctypes.byref(nb))
        self.sample_rate = sr.value
        self.block_size = bis.value
        self.lo_freq = int(l0.value)
        self.num_blocks = nb.value
        self.live = True    # a timeout just means the writer is idle

    def read_block(self, timeout: float = 1.0) -> Optional[np.ndarray]:
        out = np.empty(self.block_size, np.complex64)
        rc = self._lib.cwsl_shm_read(
            self._h, out.ctypes.data_as(ctypes.c_void_p), timeout)
        return out if rc == 0 else None

    def close(self) -> None:
        if self._h:
            self._lib.cwsl_shm_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativePump:
    """Native thread moving shm blocks into a NativeRing with backpressure."""

    def __init__(self, src: NativeShmSource, ring: NativeRing):
        self._lib = load()
        self._h = self._lib.pump_start(src._h, ring._h)
        self.src = src      # keep referents alive
        self.ring = ring

    @property
    def blocks(self) -> int:
        return self._lib.pump_blocks(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.pump_dropped(self._h)

    def stop(self) -> None:
        if self._h:
            self._lib.pump_stop(self._h)
            self._h = None
