"""Build, bind and launch the hand-written channelizer kernel.

``csrc/channelizer.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``build/``
beside this file (named by the source's hash, so an edited source
rebuilds), and loaded with ctypes.  Importing this module builds nothing:
the CPU tests import it on machines with no ``nvcc``.

:func:`channelize` is the kernel's only wrapper.  It raises on anything the
kernel does not take, and when the library cannot be built or the launch
is refused: no path here falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

TILE_OUT = 256       # outputs per block; must match channelizer.cu

SRC = Path(__file__).parent / "csrc" / "channelizer.cu"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# launches of each kernel since the last reset (one per successful launch)
launches = {"channelize": 0}

_lock = threading.Lock()     # guards _lib and the launch counts
_lib: ctypes.CDLL | None = None
build_log = ""       # nvcc's output for the library in use (ptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA channelizer cannot be built")


def build_library() -> Path:
    """Compile the kernel library unless this source's build exists."""
    global build_log
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libchannelizer_{tag}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build (first call) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.channelize_launch.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_void_p])
            lib.channelize_launch.restype = ctypes.c_int
            lib.channelize_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.channelize_smem_bytes.restype = ctypes.c_int
            lib.channelize_tile_out.restype = ctypes.c_int
            if lib.channelize_tile_out() != TILE_OUT:
                raise RuntimeError("channelizer.cu TILE_OUT disagrees")
            _lib = lib
        return _lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           shape: tuple, device: torch.device) -> None:
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name}: on {x.device}, kernel needs {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, kernel needs {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, kernel needs {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def channelize(iq_ext: torch.Tensor, coarse: torch.Tensor, fine: torch.Tensor,
               rot: torch.Tensor, filt: torch.Tensor, n_out: int,
               out_phase: int, sign: float) -> torch.Tensor:
    """Launch the fused channelizer on PyTorch's current stream.

    iq_ext [FO-BS+n_out*BS] complex64 (raw tail + block), coarse [C, NB]
    and fine [C, BS] complex64 tone tables, rot [n_tiles, C] complex64
    per-tile rotations, filt [FO] float32.  Returns [C, n_out] float32.
    """
    lib = load_library()
    device = iq_ext.device
    c, nb = coarse.shape
    bs = fine.shape[1]
    fo = filt.shape[0]
    nws = fo // bs
    n_tiles = -(-n_out // TILE_OUT)
    n_ext = fo - bs + n_out * bs
    _check("iq_ext", iq_ext, torch.complex64, (n_ext,), device)
    _check("coarse", coarse, torch.complex64, (c, TILE_OUT + nws - 1), device)
    _check("fine", fine, torch.complex64, (c, bs), device)
    _check("rot", rot, torch.complex64, (n_tiles, c), device)
    _check("filt", filt, torch.float32, (nws * bs,), device)
    out = torch.empty((c, n_out), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.channelize_launch(
        iq_ext.data_ptr(), coarse.data_ptr(), fine.data_ptr(), rot.data_ptr(),
        filt.data_ptr(), out.data_ptr(), c, n_ext, n_out, bs, fo,
        int(out_phase), float(sign), stream)
    if err != 0:
        raise RuntimeError(
            f"channelize kernel launch failed: CUDA error {err} (BS={bs}, "
            f"FO={fo}: {lib.channelize_smem_bytes(bs, fo)} B of shared "
            "memory per block)")
    with _lock:     # receivers launch from their own threads
        launches["channelize"] += 1
    return out
