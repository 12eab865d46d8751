"""Build, bind and launch the hand-written channelizer kernel, and lay out
its operands.

``csrc/channelizer.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``build/``
beside this file (named by the source's hash, so an edited source
rebuilds; :mod:`cwsl_digi_tpu_torch.kernel_build`), and loaded with
ctypes.  Importing this module builds nothing: the CPU tests import it on
machines with no ``nvcc``.

:func:`channelize` is the kernel's only wrapper.  It raises on anything the
kernel does not take, and when the library cannot be built or the launch
is refused: no path here falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from cwsl_digi_tpu_torch import kernel_build

N_TILE = 48         # outputs per block; must match channelizer.cu
C_TILE = 16         # channels per block
WARPS = 4           # split of the taps inside a block

SRC = Path(__file__).parent / "csrc" / "channelizer.cu"
BUILD_DIR = Path(__file__).parent / "build"

# launches of each kernel since the last reset (one per successful launch)
launches = {"channelize": 0}

_lock = threading.Lock()     # guards _lib, _smem_allowed and the counts
_lib: ctypes.CDLL | None = None
# device index -> dynamic shared memory the kernel may use there (bytes)
_smem_allowed: dict[int, int] = {}
build_log = ""       # nvcc's output for the library in use (ptxas -v)


def build_library() -> Path:
    """Compile the kernel library unless this source's build exists."""
    global build_log
    out, log = kernel_build.build_library(SRC, BUILD_DIR, "channelizer")
    if log is not None:
        build_log = log
    return out


def load_library() -> ctypes.CDLL:
    """Build (first call) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.channelize_launch.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_void_p])
            lib.channelize_launch.restype = ctypes.c_int
            lib.channelize_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.channelize_smem_bytes.restype = ctypes.c_int
            lib.channelize_allow_smem.argtypes = [ctypes.c_int]
            lib.channelize_allow_smem.restype = ctypes.c_int
            for name in ("channelize_tile_out", "channelize_tile_channels",
                         "channelize_warps"):
                getattr(lib, name).restype = ctypes.c_int
            if (lib.channelize_tile_out(), lib.channelize_tile_channels(),
                    lib.channelize_warps()) != (N_TILE, C_TILE, WARPS):
                raise RuntimeError("channelizer.cu tile sizes disagree")
            _lib = lib
        return _lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           shape: tuple, device: torch.device, align: int = 8) -> None:
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name}: on {x.device}, kernel needs {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, kernel needs {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, kernel needs {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    _check_aligned(name, x, align)


def _check_aligned(name: str, x: torch.Tensor, align: int) -> None:
    """The kernel reads iq_ext and the taps 16 bytes at a time: a view at
    another offset would fault on the card, so it is refused here."""
    if x.data_ptr() % align:
        raise ValueError(f"{name}: data at {x.data_ptr():#x}, kernel needs "
                         f"{align}-byte alignment")


def _allow_smem(lib: ctypes.CDLL, device: torch.device, smem: int) -> None:
    """Raise the kernel's shared-memory limit on ``device`` to ``smem``
    once per larger need (not on every launch: a launch may be captured
    into a CUDA graph).  Under the lock, so receivers on other threads
    never see a limit that is not yet set."""
    with _lock:
        if _smem_allowed.get(device.index, 0) >= smem:
            return
        err = lib.channelize_allow_smem(smem)
        if err != 0:
            raise RuntimeError(
                f"channelize kernel: CUDA error {err} allowing {smem} B of "
                f"shared memory per block on {device}")
        _smem_allowed[device.index] = smem


def pack_taps(g: torch.Tensor) -> torch.Tensor:
    """Modulated taps ``G`` [C, FO] complex -> the kernel's A operand.

    Returns bfloat16 [C_pad/8, FO/16, 32, 16]: for m16 tile ``mt``
    (channels 8*mt .. 8*mt+7), k-step ``ks`` (taps 16*ks .. 16*ks+15) and
    lane ``4*gr + qd``, the mma.m16n8k16 A fragment of rows [Re rows; Im
    rows] of channel 8*mt+gr: registers a0..a3 = (Gr, Gi at taps
    16*ks+2*qd, +1) and (Gr, Gi at taps 16*ks+2*qd+8, +9), each a pair of
    bf16 with the lower tap first; then the same eight values of
    ``G - hi`` (the lo half of the split-bf16 operand).  ``C_pad`` rounds C
    up to C_TILE with zero taps; the split is taken from ``g``'s own
    precision (float64 when complex128)."""
    c, fo = g.shape
    if fo % 16:
        raise ValueError(f"FO={fo} taps: the kernel needs a multiple of 16")
    c_pad = -(-c // C_TILE) * C_TILE
    g = torch.nn.functional.pad(torch.view_as_real(g),
                                (0, 0, 0, 0, 0, c_pad - c))
    hi = g.to(torch.bfloat16)
    lo = (g - hi.to(g.dtype)).to(torch.bfloat16)

    def frag(x):
        # [C_pad, FO, re/im] -> [mt, gr, ks, half, qd, pair, re/im]
        #                    -> [mt, ks, gr, qd, half, re/im, pair]
        x = x.reshape(c_pad // 8, 8, fo // 16, 2, 4, 2, 2)
        x = x.permute(0, 2, 1, 4, 3, 6, 5)
        return x.reshape(c_pad // 8, fo // 16, 32, 8)

    return torch.cat([frag(hi), frag(lo)], dim=-1).contiguous()


def channelize(iq_ext: torch.Tensor, taps: torch.Tensor, coarse: torch.Tensor,
               rot: torch.Tensor, n_out: int, block_size: int,
               out_phase: int, sign: float) -> torch.Tensor:
    """Launch the channelizer GEMM on PyTorch's current stream.

    iq_ext [FO-BS+n_out*BS] complex64 (raw tail + block), taps from
    :func:`pack_taps`, coarse [C, N_TILE] complex64 exp(j*pd*BS*u), rot
    [n_tiles, C] complex64 per-tile rotations exp(j*pd*(A0+t0*BS)).
    Returns [C, n_out] float32.
    """
    lib = load_library()
    device = iq_ext.device
    c = coarse.shape[0]
    bs = block_size
    fo = taps.shape[1] * 16
    if fo % (16 * WARPS) or fo % bs or bs % 2:
        raise ValueError(f"FO={fo}, BS={bs}: the kernel needs FO a multiple "
                         f"of {16 * WARPS} and of BS, and BS even")
    n_tiles = -(-n_out // N_TILE)
    n_ext = fo - bs + n_out * bs
    _check("iq_ext", iq_ext, torch.complex64, (n_ext,), device, 16)
    _check("taps", taps, torch.bfloat16,
           (-(-c // C_TILE) * C_TILE // 8, fo // 16, 32, 16), device, 16)
    _check("coarse", coarse, torch.complex64, (c, N_TILE), device)
    _check("rot", rot, torch.complex64, (n_tiles, c), device)
    out = torch.empty((c, n_out), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):     # the attribute and launch act there
        _allow_smem(lib, device, lib.channelize_smem_bytes(bs, fo))
        err = lib.channelize_launch(
            iq_ext.data_ptr(), taps.data_ptr(), coarse.data_ptr(),
            rot.data_ptr(), out.data_ptr(), c, n_ext, n_out, bs, fo,
            int(out_phase), float(sign), stream)
    if err != 0:
        raise RuntimeError(
            f"channelize kernel launch failed: CUDA error {err} (BS={bs}, "
            f"FO={fo}: {lib.channelize_smem_bytes(bs, fo)} B of shared "
            "memory per block)")
    with _lock:     # receivers launch from their own threads
        launches["channelize"] += 1
    return out
