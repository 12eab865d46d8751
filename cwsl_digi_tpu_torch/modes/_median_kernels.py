"""Build, bind and launch the hand-written exact median of each row of a
map (``median_rows``): the q-ary modes' sync-map and prior medians, WSPR's
and the GFSK engine's SNR medians.

``csrc/median.cu`` is compiled with ``nvcc`` for ``sm_90a`` and
``--fmad=false`` into a shared library with a plain C interface, at first
use, into ``build/`` beside this file, named by the source's hash
(:mod:`cwsl_digi_tpu_torch.kernel_build`), and loaded with ctypes.
Importing this module builds nothing: the CPU tests import it on machines
with no ``nvcc``.

``gfsk_engine._median_rows`` calls :func:`median_rows` on CUDA tensors.
Every operand is checked before the library is loaded; it raises on
anything the kernel does not take and when the library cannot be built or
a launch is refused: no path here falls back to the plain version
(``gfsk_engine._median_rows_plain``).  It does not sync with the host.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from cwsl_digi_tpu_torch import kernel_build

# limits of median.cu (checked against the library when it is loaded)
WS_WORDS = 4104           # a row's uint32 workspace
ROWS_MAX = 65535

SRC = Path(__file__).parent / "csrc" / "median.cu"
BUILD_DIR = Path(__file__).parent / "build"
EXTRA_FLAGS = ("--fmad=false",)

# launches since the last reset (one per wrapper call; the three passes
# count as one)
launches = {"median_rows": 0}

_lock = threading.Lock()     # guards _lib and the counts
_lib: ctypes.CDLL | None = None
build_log = ""       # nvcc's output for the library in use (ptxas -v)


def build_library() -> Path:
    """Compile the kernel library unless this source's build exists."""
    global build_log
    out, log = kernel_build.build_library(SRC, BUILD_DIR, "median",
                                          EXTRA_FLAGS)
    if log is not None:
        build_log = log
    return out


def load_library() -> ctypes.CDLL:
    """Build (first call) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.median_rows_launch.argtypes = [ll, ll, p, p, p, p]
            lib.median_rows_launch.restype = i
            lib.median_kernel_attrs.argtypes = [p]
            lib.median_kernel_attrs.restype = i
            lib.median_ws_words.restype = i
            if lib.median_ws_words() != WS_WORDS:
                raise RuntimeError("median.cu median_ws_words disagrees")
            _lib = lib
        return _lib


def _check(x: torch.Tensor) -> None:
    """The rows' dtype, contiguity and device."""
    if x.dtype != torch.float32:
        raise ValueError(f"x: dtype {x.dtype}, kernel needs torch.float32")
    if not x.is_contiguous():
        raise ValueError("x: not contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"x: on {x.device}, kernel needs a CUDA device")


def median_rows(x: torch.Tensor) -> torch.Tensor:
    """Launch the median of each row of x [R, N] float32 on PyTorch's
    current stream (three passes): the middle value, or the mean of the two
    middle values for an even N, NaN for a row that holds a NaN, -0.0 read
    as 0.0, as ``gfsk_engine._median_rows_plain``.  Returns [R] float32."""
    if x.dim() != 2:
        raise ValueError("x [R, N] must be 2-D")
    r, n = x.shape
    if not 0 < r <= ROWS_MAX:
        raise ValueError(f"{r} rows: the kernel takes 1 to {ROWS_MAX}")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"{n} values a row: the kernel takes 1 to 2**31 - 1")
    _check(x)
    ws = torch.zeros((r, WS_WORDS), dtype=torch.int32, device=x.device)
    out = torch.empty(r, dtype=torch.float32, device=x.device)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.median_rows_launch(
            r, n, x.data_ptr(), ws.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"median_rows kernel launch failed: CUDA error "
                           f"{err} ({r} rows of {n})")
    with _lock:         # decoders run on the pool's threads
        launches["median_rows"] += 1
    return out


def kernel_attrs(device) -> dict:
    """The kernel's registers a thread, spilled (local) bytes a thread,
    static shared bytes and threads a block at most, as
    ``cudaFuncGetAttributes`` gives them: {"median_rows": {...}}."""
    lib = load_library()
    vals = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = lib.median_kernel_attrs(ctypes.addressof(vals))
    if err != 0:
        raise RuntimeError(f"median_kernel_attrs: CUDA error {err}")
    return {"median_rows": dict(zip(("registers", "local_bytes",
                                     "static_smem_bytes", "max_threads"),
                                    list(vals)))}
