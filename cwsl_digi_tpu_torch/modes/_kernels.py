"""Build, bind and launch the hand-written LDPC kernels: min-sum BP
(``bp_minsum``) and OSD (``osd``).

``csrc/ldpc.cu`` is compiled with ``nvcc`` for ``sm_90a`` (and
``--fmad=false``, so the kernels' sums round as the plain versions') into a
shared library with a plain C interface, at first use, into ``build/``
beside this file, named by the source's hash
(:mod:`cwsl_digi_tpu_torch.kernel_build`), and loaded with ctypes.
Importing this module builds nothing: the CPU tests import it on machines
with no ``nvcc``.

:func:`bp_minsum` and :func:`osd` are the kernels' only wrappers.  They
check every operand before the library is loaded, raise on anything the
kernels do not take and when the library cannot be built or a launch is
refused: no path here falls back to the plain versions
(``ldpc.BPDecoder.decode_full_plain``, ``osd.osd_decode_plain``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from cwsl_digi_tpu_torch import kernel_build

# limits of ldpc.cu (checked against the library when it is loaded)
BP_MAX_ROW = 8
BP_MAX_COL = 4
BP_MAX_N = 256
BP_MAX_CHECKS = 256
OSD_MAX_K = 128
OSD_MAX_N = 256
OSD_MAX_FLIPS = 3

SRC = Path(__file__).parent / "csrc" / "ldpc.cu"
BUILD_DIR = Path(__file__).parent / "build"
EXTRA_FLAGS = ("--fmad=false",)

# launches of each kernel since the last reset (one per successful launch)
launches = {"bp_minsum": 0, "osd": 0}

_lock = threading.Lock()     # guards _lib, the counts and the column tables
_lib: ctypes.CDLL | None = None
# each generator's column masks for the OSD kernel, built on its first call:
# {(data_ptr, shape, device, version): (generator, table)}; the entry holds
# the generator, so that its memory is not reused while the entry lives
_gen_cols: dict = {}
GEN_COLS_CACHE = 64
build_log = ""       # nvcc's output for the library in use (ptxas -v)


def build_library() -> Path:
    """Compile the kernel library unless this source's build exists."""
    global build_log
    out, log = kernel_build.build_library(SRC, BUILD_DIR, "ldpc",
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
            lib.bp_minsum_launch.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_void_p])
            lib.bp_minsum_launch.restype = ctypes.c_int
            lib.osd_launch.argtypes = ([ctypes.c_void_p] * 6
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
            lib.osd_launch.restype = ctypes.c_int
            lib.bp_minsum_smem_bytes.argtypes = [ctypes.c_int] * 4
            lib.bp_minsum_smem_bytes.restype = ctypes.c_int
            limits = {"bp_minsum_max_row": BP_MAX_ROW,
                      "bp_minsum_max_col": BP_MAX_COL,
                      "bp_minsum_max_n": BP_MAX_N,
                      "bp_minsum_max_checks": BP_MAX_CHECKS,
                      "osd_max_k": OSD_MAX_K, "osd_max_n": OSD_MAX_N,
                      "osd_max_flips": OSD_MAX_FLIPS}
            for name, want in limits.items():
                getattr(lib, name).restype = ctypes.c_int
                if getattr(lib, name)() != want:
                    raise RuntimeError(f"ldpc.cu {name} disagrees")
            _lib = lib
        return _lib


def _check(operands: dict) -> None:
    """{name: (tensor, dtype, shape)}: each operand's dtype, shape and
    contiguity, then that all lie on one CUDA device."""
    for name, (x, dtype, shape) in operands.items():
        if x.dtype != dtype:
            raise ValueError(f"{name}: dtype {x.dtype}, kernel needs {dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, kernel needs "
                             f"{tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    first = next(iter(operands.values()))[0].device
    for name, (x, _, _) in operands.items():
        if x.device != first or x.device.type != "cuda":
            raise ValueError(f"{name}: on {x.device}, kernel needs every "
                             "operand on one CUDA device")


def _count(name: str) -> None:
    with _lock:         # decoders run on the pool's threads
        launches[name] += 1


def bp_minsum(llrs: torch.Tensor, row_cols: torch.Tensor,
              col_slots: torch.Tensor, iters: int, alpha: float
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch normalized min-sum BP on PyTorch's current stream.

    llrs [M, n] float32 (positive = bit 0); row_cols [n_checks, max_row]
    int16 (n in a padded slot) and col_slots [n, max_col] int16 (flat
    index into [n_checks * max_row], -1 padded), from
    ``ldpc.kernel_tables``.  Returns (hard [M, n] int8, parity_ok [M]
    bool, posterior totals [M, n] float32)."""
    device = llrs.device
    if llrs.dim() != 2:
        raise ValueError(f"llrs: shape {tuple(llrs.shape)}, kernel needs "
                         "[M, n]")
    m, n = llrs.shape
    nc, mr = row_cols.shape
    mc = col_slots.shape[1] if col_slots.dim() == 2 else 0
    if not (0 < n <= BP_MAX_N and 0 < nc <= BP_MAX_CHECKS
            and 0 < mr <= BP_MAX_ROW and 0 < mc <= BP_MAX_COL):
        raise ValueError(f"code n={n}, {nc} checks, max_row {mr}, max_col "
                         f"{mc}: the kernel takes n <= {BP_MAX_N}, <= "
                         f"{BP_MAX_CHECKS} checks, max_row <= {BP_MAX_ROW}, "
                         f"max_col <= {BP_MAX_COL}")
    _check({"llrs": (llrs, torch.float32, (m, n)),
            "row_cols": (row_cols, torch.int16, (nc, mr)),
            "col_slots": (col_slots, torch.int16, (n, mc))})
    if iters < 0:
        raise ValueError(f"iters={iters}")
    hard = torch.empty((m, n), dtype=torch.int8, device=device)
    ok = torch.empty((m,), dtype=torch.bool, device=device)
    post = torch.empty((m, n), dtype=torch.float32, device=device)
    if m == 0:
        return hard, ok, post
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.bp_minsum_launch(
            llrs.data_ptr(), row_cols.data_ptr(), col_slots.data_ptr(),
            hard.data_ptr(), ok.data_ptr(), post.data_ptr(), m, n, nc, mr,
            mc, int(iters), float(alpha), stream)
    if err != 0:
        raise RuntimeError(
            f"bp_minsum kernel launch failed: CUDA error {err} (M={m}, "
            f"n={n}, {nc} checks, max_row {mr}, max_col {mc}: "
            f"{lib.bp_minsum_smem_bytes(n, nc, mr, mc)} B of shared memory "
            "per block)")
    _count("bp_minsum")
    return hard, ok, post


def generator_columns(gen: torch.Tensor) -> torch.Tensor:
    """The OSD kernel's column table of the generator gen [k, n] (k <=
    128): [n, 4] int32, column j as a k-bit mask (row i at bit i & 31 of
    word i >> 5), on gen's device.  Made once for each generator tensor
    (a few device operations on its first call) and cached."""
    key = (gen.data_ptr(), tuple(gen.shape), str(gen.device), gen._version)
    with _lock:
        hit = _gen_cols.get(key)
    if hit is not None:
        return hit[1]
    k, n = gen.shape
    bits = torch.nn.functional.pad((gen != 0).T.to(torch.int64),
                                   (0, OSD_MAX_K - k))            # [n, 128]
    shift = torch.arange(32, device=gen.device, dtype=torch.int64)
    words = (bits.reshape(n, OSD_MAX_K // 32, 32) << shift).sum(-1)
    table = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32).contiguous()
    with _lock:
        if len(_gen_cols) >= GEN_COLS_CACHE:
            _gen_cols.pop(next(iter(_gen_cols)))
        _gen_cols[key] = (gen, table)
    return table


def osd(gen: torch.Tensor, llrs: torch.Tensor, pattern_idx: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch OSD on PyTorch's current stream, one warp per word.

    gen [k, n] uint8 0/1 generator (the kernel reads its
    :func:`generator_columns`), llrs [M, n] float32 (positive = bit 0),
    pattern_idx [T, 3] int16: each flip pattern's basis coordinates, -1
    padded (``osd.pattern_index_lists``).  Returns (codewords [M, n]
    int8, soft distance [M] float32, hard errors [M] int32)."""
    device = llrs.device
    if gen.dim() != 2 or llrs.dim() != 2 or pattern_idx.dim() != 2:
        raise ValueError("gen, llrs and pattern_idx must be 2-D")
    k, n = gen.shape
    m = llrs.shape[0]
    t = pattern_idx.shape[0]
    if pattern_idx.shape[1] != OSD_MAX_FLIPS:
        raise ValueError(f"pattern_idx: {pattern_idx.shape[1]} flips a "
                         f"pattern, the kernel takes at most {OSD_MAX_FLIPS}")
    if not (0 < k <= OSD_MAX_K and 0 < n <= OSD_MAX_N and k <= n and t > 0):
        raise ValueError(f"k={k}, n={n}, {t} patterns: the kernel takes "
                         f"k <= {OSD_MAX_K}, n <= {OSD_MAX_N} and at least "
                         "one pattern")
    _check({"llrs": (llrs, torch.float32, (m, n)),
            "gen": (gen, torch.uint8, (k, n)),
            "pattern_idx": (pattern_idx, torch.int16, (t, OSD_MAX_FLIPS))})
    cw = torch.empty((m, n), dtype=torch.int8, device=device)
    dist = torch.empty((m,), dtype=torch.float32, device=device)
    nhard = torch.empty((m,), dtype=torch.int32, device=device)
    if m == 0:
        return cw, dist, nhard
    lib = load_library()
    cols = generator_columns(gen)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.osd_launch(cols.data_ptr(), llrs.data_ptr(),
                             pattern_idx.data_ptr(), cw.data_ptr(),
                             dist.data_ptr(), nhard.data_ptr(), m, k, n, t,
                             stream)
    if err != 0:
        raise RuntimeError(f"osd kernel launch failed: CUDA error {err} "
                           f"(M={m}, k={k}, n={n}, {t} patterns)")
    _count("osd")
    return cw, dist, nhard
