"""Build, bind and launch the hand-written kernels of JT65's Chase program
around its RS decode: the trials' erasure flags (``chase_erasures``) and
the soft re-encode score with each candidate's best trial
(``chase_score``).  The RS decode between them is
:mod:`._weak_kernels`' ``rs_ee``.

``csrc/chase.cu`` is compiled with ``nvcc`` for ``sm_90a`` and
``--fmad=false`` into a shared library with a plain C interface, at first
use, into ``build/`` beside this file, named by the source's hash
(:mod:`cwsl_digi_tpu_torch.kernel_build`), and loaded with ctypes.
Importing this module builds nothing: the CPU tests import it on machines
with no ``nvcc``.

``rs_device.chase_erasures`` and ``rs_device.chase_score`` call them on
CUDA tensors.  Every operand is checked before the library is loaded; they
raise on anything the kernels do not take and when the library cannot be
built or a launch is refused: no path here falls back to the plain
versions (``rs_device.chase_erasures_plain``,
``rs_device.chase_score_plain``).  Neither syncs with the host.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from cwsl_digi_tpu_torch import kernel_build

# limits of chase.cu (checked against the library when it is loaded)
N_MAX = 64               # symbols a word
T_MAX = 1024             # trials a candidate
DET_MAX = 8              # deterministic trials
SUM_WINDOW = 32          # the erasure weights' row sum's window
SCORE_WARPS = 4          # chase_score: warps a block (a candidate)
SCORE_LANES = 4          # lanes a trial
SCORE_STAGE = 32         # trials a stage of its shared ring
SCORE_RING = 2           # stages in flight

SRC = Path(__file__).parent / "csrc" / "chase.cu"
BUILD_DIR = Path(__file__).parent / "build"
EXTRA_FLAGS = ("--fmad=false",)

# launches of each kernel since the last reset (one per wrapper call that
# launches it)
launches = {"chase_erasures": 0, "chase_score": 0}

_lock = threading.Lock()     # guards _lib and the counts
_lib: ctypes.CDLL | None = None
build_log = ""       # nvcc's output for the library in use (ptxas -v)


def build_library() -> Path:
    """Compile the kernel library unless this source's build exists."""
    global build_log
    out, log = kernel_build.build_library(SRC, BUILD_DIR, "chase",
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
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.chase_erasures_launch.argtypes = [p, ctypes.c_longlong] \
                + [p] * 6
            lib.chase_erasures_launch.restype = i
            lib.chase_score_launch.argtypes = [p, ctypes.c_float,
                                               ctypes.c_float] + [p] * 11
            lib.chase_score_launch.restype = i
            lib.chase_kernel_attrs.argtypes = [i, p]
            lib.chase_kernel_attrs.restype = i
            lib.chase_score_design.argtypes = [i, i, p]
            lib.chase_score_design.restype = i
            lib.chase_score_bulk.argtypes = [p, p, i, i]
            lib.chase_score_bulk.restype = i
            limits = {"chase_n_max": N_MAX, "chase_t_max": T_MAX,
                      "chase_det_max": DET_MAX,
                      "chase_sum_window": SUM_WINDOW,
                      "chase_score_warps": SCORE_WARPS,
                      "chase_score_lanes": SCORE_LANES,
                      "chase_score_stage": SCORE_STAGE,
                      "chase_score_ring": SCORE_RING}
            for name, want in limits.items():
                getattr(lib, name).restype = i
                if getattr(lib, name)() != want:
                    raise RuntimeError(f"chase.cu {name} disagrees")
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


def check_chase(n: int, n_trials: int, n_det: int) -> None:
    """Raise unless the Chase kernels take words of ``n`` symbols,
    ``n_trials`` trials a candidate and ``n_det`` deterministic ones."""
    if not (1 <= n <= N_MAX and 0 <= n_det <= DET_MAX
            and n_det < n_trials <= T_MAX):
        raise ValueError(f"n={n}, {n_trials} trials of which {n_det} "
                         f"deterministic: the Chase kernels take n <= "
                         f"{N_MAX}, at most {T_MAX} trials and {DET_MAX} "
                         "deterministic ones, and one stochastic trial or "
                         "more")


def _check_rows(c: int, t: int, n: int) -> None:
    if not (0 < c and c * t * n < 2 ** 31):
        raise ValueError(f"{c} x {t} x {n} flags: the kernels take 1 to "
                         "2**31 - 1")


def chase_erasures(margin: torch.Tensor, seed: torch.Tensor,
                   base_p: torch.Tensor, depth: torch.Tensor, tiers,
                   n_trials: int, c0: int) -> torch.Tensor:
    """Launch the erasure flags on PyTorch's current stream, a block a
    candidate: margin [C, n] float32, seed a 0-dim int64 tensor on the
    card (its low 32 bits are folded in), base_p [n] and depth [T - n_det]
    float32 (``rs_device.chase_tables_device``), ``tiers`` the n_det
    deterministic trials' erasure counts, c0 the call's first candidate in
    the whole draw.  Returns era [C, T, n] bool, as
    ``rs_device.chase_erasures_plain``.  One launch."""
    if margin.dim() != 2:
        raise ValueError("margin [C, n] must be 2-D")
    c, n = margin.shape
    tiers = [int(f) for f in tiers]
    check_chase(n, n_trials, len(tiers))
    _check_rows(c, n_trials, n)
    if c0 < 0:
        raise ValueError(f"c0={c0}: the first candidate is 0 or more")
    _check({"margin": (margin, torch.float32, (c, n)),
            "seed": (seed, torch.int64, ()),
            "base_p": (base_p, torch.float32, (n,)),
            "depth": (depth, torch.float32, (n_trials - len(tiers),))})
    era = torch.empty((c, n_trials, n), dtype=torch.bool, device=margin.device)
    lib = load_library()
    dims = (ctypes.c_int * (4 + len(tiers)))(c, n_trials, n, len(tiers),
                                             *tiers)
    with torch.cuda.device(margin.device):
        err = lib.chase_erasures_launch(
            ctypes.addressof(dims), c0, margin.data_ptr(), seed.data_ptr(),
            base_p.data_ptr(), depth.data_ptr(), era.data_ptr(),
            torch.cuda.current_stream(margin.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chase_erasures kernel launch failed: CUDA error "
                           f"{err} ({c} candidates x {n_trials} trials)")
    _count("chase_erasures")
    return era


def chase_score(corrected: torch.Tensor, ok: torch.Tensor, era: torch.Tensor,
                top_e: torch.Tensor, top_tone: torch.Tensor,
                e_sum: torch.Tensor, k: int, accept: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Launch the soft score and best-trial selection on PyTorch's current
    stream, a block a candidate, its trials' words and flags staged in
    shared memory by the TMA unit where both slabs are 16-byte aligned
    (:func:`score_bulk`), by the block's byte copies where not:
    corrected [C, T, n] uint8, ok [C, T] bool,
    era [C, T, n] bool, top_e [C, n, 4] float32, top_tone [C, n, 4] int64,
    e_sum [C, n] float32.  Returns (info [C, k] int64, best_score [C]
    float32, best_ok [C] bool), as ``rs_device.chase_score_plain``, and
    the best trial [C] int64.  One launch."""
    if corrected.dim() != 3:
        raise ValueError("corrected [C, T, n] must be 3-D")
    c, t, n = corrected.shape
    if not (1 <= n <= N_MAX and 1 <= t <= T_MAX):
        raise ValueError(f"n={n}, {t} trials: the score kernel takes n <= "
                         f"{N_MAX} and at most {T_MAX} trials")
    _check_rows(c, t, n)
    if not 1 <= k <= n:
        raise ValueError(f"k={k}: the info word takes 1 to n symbols")
    _check({"corrected": (corrected, torch.uint8, (c, t, n)),
            "ok": (ok, torch.bool, (c, t)),
            "era": (era, torch.bool, (c, t, n)),
            "top_e": (top_e, torch.float32, (c, n, 4)),
            "top_tone": (top_tone, torch.int64, (c, n, 4)),
            "e_sum": (e_sum, torch.float32, (c, n))})
    dev = corrected.device
    info = torch.empty((c, k), dtype=torch.int64, device=dev)
    best_score = torch.empty(c, dtype=torch.float32, device=dev)
    best_ok = torch.empty(c, dtype=torch.bool, device=dev)
    best_trial = torch.empty(c, dtype=torch.int64, device=dev)
    lib = load_library()
    dims = (ctypes.c_int * 4)(c, t, n, k)
    # the plain version compares float32 values with these Python floats
    # as float32
    with torch.cuda.device(dev):
        err = lib.chase_score_launch(
            ctypes.addressof(dims), float(np.float32(accept)),
            float(np.float32(0.6 * accept)), corrected.data_ptr(),
            ok.data_ptr(), era.data_ptr(), top_e.data_ptr(),
            top_tone.data_ptr(), e_sum.data_ptr(), info.data_ptr(),
            best_score.data_ptr(), best_ok.data_ptr(), best_trial.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chase_score kernel launch failed: CUDA error "
                           f"{err} ({c} candidates x {t} trials)")
    _count("chase_score")
    return info, best_score, best_ok, best_trial


def score_bulk(corrected: torch.Tensor, era: torch.Tensor) -> bool:
    """Whether ``chase_score`` stages these trials by the TMA unit (both
    bases 16-byte aligned and a candidate's T x n bytes a multiple of 16),
    as the library decides it."""
    _c, t, n = corrected.shape
    return bool(load_library().chase_score_bulk(
        corrected.data_ptr(), era.data_ptr(), t, n))


def score_design(device, n_trials: int, n: int) -> dict:
    """``chase_score``'s layout for ``n_trials`` trials of ``n`` symbols on
    ``device``: warps a block, trials a stage, ring slots, dynamic and
    static shared bytes a block, blocks an SM."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = load_library().chase_score_design(n_trials, n,
                                                ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"chase_score_design: CUDA error {err}")
    return dict(zip(("warps_a_block", "trials_a_stage", "ring_slots",
                     "dynamic_smem_bytes", "static_smem_bytes",
                     "blocks_an_sm"), list(out)))


def kernel_attrs(device) -> dict:
    """Each Chase kernel's registers a thread, spilled (local) bytes a
    thread, static shared bytes and threads a block at most, as
    ``cudaFuncGetAttributes`` gives them."""
    lib = load_library()
    out = {}
    for which, name in enumerate(("chase_erasures", "chase_score")):
        vals = (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            err = lib.chase_kernel_attrs(which, ctypes.addressof(vals))
        if err != 0:
            raise RuntimeError(f"chase_kernel_attrs({name}): CUDA error "
                               f"{err}")
        out[name] = dict(zip(("registers", "local_bytes", "static_smem_bytes",
                              "max_threads"), list(vals)))
    return out
