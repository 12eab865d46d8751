"""Build, bind and launch the hand-written kernels of the GFSK decode's sync
search: the sync score with its NMS (``sync_score``), the hybrid top-K
(``sync_select``) and the half-hop refinement (``sync_refine``).

``csrc/sync.cu`` is compiled with ``nvcc`` for ``sm_90a`` and
``--fmad=false`` into a shared library with a plain C interface, at first
use, into ``build/`` beside this file, named by the source's hash
(:mod:`cwsl_digi_tpu_torch.kernel_build`), and loaded with ctypes.
Importing this module builds nothing: the CPU tests import it on machines
with no ``nvcc``.

:func:`sync_candidates` is the stage's wrapper (``gfsk_engine.
sync_candidates`` calls it on CUDA tensors); :func:`sync_score`,
:func:`sync_select` and :func:`sync_refine` launch one kernel each.  Every
operand is checked before the library is loaded; they raise on anything the
kernels do not take and when the library cannot be built or a launch is
refused: no path here falls back to the plain versions
(``gfsk_engine.sync_candidates_plain`` and its three parts).  None syncs
with the host, so each can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from cwsl_digi_tpu_torch import kernel_build

# limits of sync.cu (checked against the library when it is loaded)
MAX_CELLS = 40            # sync cells of a mode
MAX_OS_T = 16             # os_t and os_f: even, for max_pool2d's symmetric
MAX_OS_F = 8              # (os+1)-wide window, and at most these
SELECT_MAX_K = 16384      # each half of the top-K: top_k <= 32768

SRC = Path(__file__).parent / "csrc" / "sync.cu"
BUILD_DIR = Path(__file__).parent / "build"
EXTRA_FLAGS = ("--fmad=false",)

# launches of each kernel since the last reset (one per wrapper call that
# launches it)
launches = {"sync_score": 0, "sync_select": 0, "sync_refine": 0}

_lock = threading.Lock()     # guards _lib and the counts
_lib: ctypes.CDLL | None = None
build_log = ""       # nvcc's output for the library in use (ptxas -v)


def build_library() -> Path:
    """Compile the kernel library unless this source's build exists."""
    global build_log
    out, log = kernel_build.build_library(SRC, BUILD_DIR, "sync", EXTRA_FLAGS)
    if log is not None:
        build_log = log
    return out


def load_library() -> ctypes.CDLL:
    """Build (first call) and bind the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.sync_score_launch.argtypes = [p, p, p, i] + [p] * 5
            lib.sync_score_launch.restype = i
            lib.sync_select_launch.argtypes = [p] * 8
            lib.sync_select_launch.restype = i
            lib.sync_select_plan.argtypes = [p, p]
            lib.sync_select_plan.restype = i
            lib.sync_kernel_attrs.argtypes = [i, i, p]
            lib.sync_kernel_attrs.restype = i
            lib.sync_refine_launch.argtypes = [p, p, p, i] + [p] * 5
            lib.sync_refine_launch.restype = i
            limits = {"sync_max_cells": MAX_CELLS, "sync_max_os_t": MAX_OS_T,
                      "sync_max_os_f": MAX_OS_F,
                      "sync_select_max_k": SELECT_MAX_K}
            for name, want in limits.items():
                getattr(lib, name).restype = i
                if getattr(lib, name)() != want:
                    raise RuntimeError(f"sync.cu {name} disagrees")
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


def grid(spec) -> tuple[int, int]:
    """(n_t0, n_f0): the candidate grid of start hops and base bins."""
    fmin_bin, fmax_bin, _ = spec.bin_range
    return spec.max_hops, fmax_bin - fmin_bin


def _cells(spec, t_mul: int) -> tuple[ctypes.Array, ctypes.Array, int]:
    """The sync cells' row (t_mul * symbol) and column (os_f * tone)
    offsets as C int arrays."""
    rows = [t_mul * int(s) for s, _ in spec.sync_cells]
    cols = [spec.os_f * int(t) for _, t in spec.sync_cells]
    n = len(rows)
    return (ctypes.c_int * n)(*rows), (ctypes.c_int * n)(*cols), n


def _k_checks(k_total: int, n: int) -> None:
    """The selection's limits on top_k and the scores a window."""
    k_nms = k_total // 2
    if not 1 <= k_total - k_nms <= SELECT_MAX_K:
        raise ValueError(f"top_k={k_total}: the kernel takes 1 to "
                         f"{2 * SELECT_MAX_K} ({SELECT_MAX_K} a half)")
    if k_total - k_nms > n:
        raise ValueError(f"top_k={k_total} of {n} scores a window: the "
                         "kernel takes at most the scores a half")
    if n >= 2 ** 31:
        raise ValueError(f"{n} scores a window: the kernel takes fewer than "
                         "2**31")


def _cells_checks(spec) -> None:
    n_cells = len(spec.sync_cells)
    if not 0 < n_cells <= MAX_CELLS:
        raise ValueError(f"{n_cells} sync cells: the kernels take 1 to "
                         f"{MAX_CELLS}")


def _score_checks(spec, power_sync: torch.Tensor, base: torch.Tensor
                  ) -> tuple[tuple[int, int, int, int, int], dict]:
    """(B, H, F, n_t0, n_f0) of a score call and its operands for
    :func:`_check`, the mode's limits checked."""
    if power_sync.dim() != 3 or base.dim() != 3:
        raise ValueError("power_sync [B, H, F] and base [B, 1, 1] must be "
                         "3-D")
    _cells_checks(spec)
    if not (2 <= spec.os_t <= MAX_OS_T and 2 <= spec.os_f <= MAX_OS_F
            and spec.os_t % 2 == 0 and spec.os_f % 2 == 0):
        raise ValueError(f"os_t={spec.os_t}, os_f={spec.os_f}: the kernels "
                         f"take even oversampling, os_t <= {MAX_OS_T} and "
                         f"os_f <= {MAX_OS_F}")
    b, h, f = power_sync.shape
    n_t0, n_f0 = grid(spec)
    max_row = spec.os_t * max(int(s) for s, _ in spec.sync_cells)
    max_col = spec.os_f * max(int(t) for _, t in spec.sync_cells)
    if max_row + n_t0 > h or max_col + n_f0 > f:
        raise ValueError(f"power_sync [{b}, {h}, {f}] holds no {n_t0} x "
                         f"{n_f0} grid at every sync cell")
    if not 0 < b <= 65535:
        raise ValueError(f"{b} windows: the kernel takes 1 to 65535")
    return (b, h, f, n_t0, n_f0), {
        "power_sync": (power_sync, torch.bfloat16, (b, h, f)),
        "base": (base, torch.float32, (b, 1, 1))}


def sync_score(spec, power_sync: torch.Tensor, base: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the sync score and its NMS mask on PyTorch's current stream:
    power_sync [B, H, F] bf16, base [B, 1, 1] float32, as
    ``gfsk_engine.sync_score_plain`` takes them.  Returns (score, nms)
    [B, n_t0, n_f0] float32."""
    dims, operands = _score_checks(spec, power_sync, base)
    _check(operands)
    return _score_launch(spec, power_sync, base, *dims)


def _score_launch(spec, power_sync, base, b, h, f, n_t0, n_f0):
    score = torch.empty((b, n_t0, n_f0), dtype=torch.float32,
                        device=power_sync.device)
    nms = torch.empty_like(score)
    lib = load_library()
    dims = (ctypes.c_int * 7)(b, h, f, n_t0, n_f0, spec.os_t, spec.os_f)
    rows, cols, n_cells = _cells(spec, spec.os_t)
    with torch.cuda.device(power_sync.device):
        err = lib.sync_score_launch(
            ctypes.addressof(dims), ctypes.addressof(rows),
            ctypes.addressof(cols), n_cells, power_sync.data_ptr(),
            base.data_ptr(), score.data_ptr(), nms.data_ptr(),
            torch.cuda.current_stream(power_sync.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sync_score kernel launch failed: CUDA error "
                           f"{err} ({spec.name}, power_sync [{b}, {h}, {f}])")
    _count("sync_score")
    return score, nms


def sync_select(spec, score: torch.Tensor, nms: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the hybrid top-K on PyTorch's current stream: the NMS map's
    ``top_k // 2`` and the raw score's ``top_k - top_k // 2`` per window,
    each in ``torch.sort(stable=True, descending=True)`` order, as
    ``gfsk_engine.sync_select_plain`` picks them from score and nms [B,
    n_t0, n_f0] float32: one launch of thread-block clusters, one a
    window and half, with a pair buffer of [B, 2, p2] int64 allocated
    here as scratch (p2 the least power of two >= the raw half's k).
    Returns (top_val [B, top_k] float32, t0, f0 [B, top_k] int64): top_idx
    // n_f0 and top_idx % n_f0."""
    if score.dim() != 3:
        raise ValueError("score and nms [B, n_t0, n_f0] must be 3-D")
    b, n_t0, n_f0 = score.shape
    _k_checks(spec.top_k, n_t0 * n_f0)
    _check({"score": (score, torch.float32, (b, n_t0, n_f0)),
            "nms": (nms, torch.float32, (b, n_t0, n_f0))})
    return _select_launch(spec, score, nms, b, n_t0 * n_f0, n_f0)


def _pair_stride(k_total: int) -> int:
    """The least power of two >= the raw half's k: the selection's pair
    buffer a (window, half)."""
    return 1 << (k_total - k_total // 2 - 1).bit_length()


def _select_launch(spec, score, nms, b, n, n_f0):
    k = spec.top_k
    dev = score.device
    top_val = torch.empty((b, k), dtype=torch.float32, device=dev)
    t0 = torch.empty((b, k), dtype=torch.int64, device=dev)
    f0 = torch.empty_like(t0)
    pairs = torch.empty(b * 2 * _pair_stride(k), dtype=torch.int64,
                        device=dev)
    lib = load_library()
    dims = (ctypes.c_int * 5)(b, n, n_f0, k // 2, k - k // 2)
    with torch.cuda.device(dev):
        err = lib.sync_select_launch(
            ctypes.addressof(dims), nms.data_ptr(), score.data_ptr(),
            top_val.data_ptr(), t0.data_ptr(), f0.data_ptr(),
            pairs.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sync_select kernel launch failed: CUDA error "
                           f"{err} ({spec.name}, {b} windows of {n} scores, "
                           f"top_k={k})")
    _count("sync_select")
    return top_val, t0, f0


def select_plan(spec, b: int, device) -> dict:
    """How ``sync_select`` cuts a call of ``b`` windows of ``spec``'s grid
    on ``device``: blocks a cluster, threads a block, keys a block, of them
    kept in shared memory, dynamic shared memory bytes, the pair buffer's
    stride, and the clusters of that shape the card holds at once."""
    n_t0, n_f0 = grid(spec)
    k = spec.top_k
    lib = load_library()
    dims = (ctypes.c_int * 5)(b, n_t0 * n_f0, n_f0, k // 2, k - k // 2)
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = lib.sync_select_plan(ctypes.addressof(dims),
                                   ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"sync_select_plan: CUDA error {err}")
    return dict(zip(("cluster", "threads", "keys_a_block", "keys_on_chip",
                     "dynamic_smem_bytes", "pair_stride",
                     "max_active_clusters"), list(out)))


def kernel_attrs(device, n_cells: int = 21) -> dict:
    """Each sync kernel's registers a thread, spilled (local) bytes a
    thread, static shared bytes and threads a block at most, as
    ``cudaFuncGetAttributes`` gives them; ``sync_score`` for os_t = 8, os_f
    = 4 and ``n_cells``."""
    lib = load_library()
    out = {}
    for which, name in enumerate(("sync_select", "sync_score",
                                  "sync_refine")):
        vals = (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            err = lib.sync_kernel_attrs(which, n_cells,
                                        ctypes.addressof(vals))
        if err != 0:
            raise RuntimeError(f"sync_kernel_attrs({name}): CUDA error {err}")
        out[name] = dict(zip(("registers", "local_bytes", "static_smem_bytes",
                              "max_threads"), list(vals)))
    return out


def sync_refine(spec, demod: torch.Tensor, t0: torch.Tensor,
                f0: torch.Tensor) -> torch.Tensor:
    """Launch the half-hop refinement on PyTorch's current stream: demod
    [B, H, F] complex64 (half-hop rows), t0 and f0 [B, K] int64 (the
    candidates on the hop grid), as ``gfsk_engine.sync_refine_plain`` takes
    them.  Returns tt [B, K] int64."""
    if demod.dim() != 3 or t0.dim() != 2:
        raise ValueError("demod [B, H, F] and t0, f0 [B, K] must be 3- and "
                         "2-D")
    b, k = t0.shape
    _check({**_refine_checks(spec, demod, b, k),
            "t0": (t0, torch.int64, (b, k)),
            "f0": (f0, torch.int64, (b, k))})
    return _refine_launch(spec, demod, t0, f0, k)


def _refine_checks(spec, demod: torch.Tensor, b: int, k: int) -> dict:
    """The refinement's limits; demod [b, H, F] complex64 as an operand for
    :func:`_check`."""
    if demod.dim() != 3:
        raise ValueError("demod [B, H, F] must be 3-D")
    h, f = demod.shape[1:]
    _cells_checks(spec)
    n_f0 = grid(spec)[1]
    max_col = spec.os_f * max(int(t) for _, t in spec.sync_cells)
    if max_col + n_f0 > f:
        raise ValueError(f"demod [{demod.shape[0]}, {h}, {f}] holds no "
                         f"{n_f0} base bins at every sync tone")
    if not 0 < b * k < 2 ** 31:
        raise ValueError(f"{b} x {k} candidates: the kernel takes 1 to "
                         "2**31 - 1")
    return {"demod": (demod, torch.complex64, (b, h, f))}


def _refine_launch(spec, demod, t0, f0, k):
    b, h, f = demod.shape
    tt = torch.empty((b, k), dtype=torch.int64, device=demod.device)
    lib = load_library()
    dims = (ctypes.c_int * 4)(b, k, h, f)
    rows, cols, n_cells = _cells(spec, 2 * spec.os_t)
    with torch.cuda.device(demod.device):
        err = lib.sync_refine_launch(
            ctypes.addressof(dims), ctypes.addressof(rows),
            ctypes.addressof(cols), n_cells, demod.data_ptr(), t0.data_ptr(),
            f0.data_ptr(), tt.data_ptr(),
            torch.cuda.current_stream(demod.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sync_refine kernel launch failed: CUDA error "
                           f"{err} ({spec.name}, demod [{b}, {h}, {f}], {k} "
                           "candidates a window)")
    _count("sync_refine")
    return tt


def sync_candidates(spec, power_sync: torch.Tensor, demod: torch.Tensor,
                    base: torch.Tensor, n_hops: int, refine: bool) -> tuple:
    """Launch stages 2-4a of the decode on PyTorch's current stream:
    ``sync_score``, ``sync_select`` and, where ``refine``, ``sync_refine``,
    with the operands of ``gfsk_engine.sync_candidates_plain`` (power_sync
    [B, ph + n_hops + ph, F] bf16, demod [B, H, F'] complex64, base [B, 1,
    1] float32).  Every operand is checked before the first launch.
    Returns (top_val, t0, f0, tt, os_t_eff)."""
    (b, h, f, n_t0, n_f0), operands = _score_checks(spec, power_sync, base)
    if h != n_hops + 2 * spec.pad_hops:
        raise ValueError(f"power_sync has {h} rows, not {n_hops} hops and "
                         f"{spec.pad_hops} of padding each side")
    _k_checks(spec.top_k, n_t0 * n_f0)
    if refine:
        operands.update(_refine_checks(spec, demod, b, spec.top_k))
    _check(operands)
    score, nms = _score_launch(spec, power_sync, base, b, h, f, n_t0, n_f0)
    top_val, t0, f0 = _select_launch(spec, score, nms, b, n_t0 * n_f0, n_f0)
    del score, nms
    if not refine:
        return top_val, t0, f0, t0, spec.os_t
    tt = _refine_launch(spec, demod, t0, f0, spec.top_k)
    return top_val, t0, f0, tt, 2 * spec.os_t
