"""Build, bind and launch the hand-written kernels of the weak modes' two
costliest device stages: WSPR's beam search (``wspr_beam``) and JT65's
errors-and-erasures Reed-Solomon decode (``rs_ee``).

``csrc/weak.cu`` is compiled with ``nvcc`` for ``sm_90a`` and
``--fmad=false`` into a shared library with a plain C interface, at first
use, into ``build/`` beside this file, named by the source's hash
(:mod:`cwsl_digi_tpu_torch.kernel_build`), and loaded with ctypes.
Importing this module builds nothing: the CPU tests import it on machines
with no ``nvcc``.

``wspr._beam_decode`` calls :func:`wspr_beam` on CUDA tensors, and
``rs_device.rs_ee_decode`` and ``rs_device.rs_ee_trials`` (the Chase
program's entry) call :func:`rs_ee`.  ``wspr_beam`` runs in a plan of K
keys a thread (``BEAM_PLANS``: 2W / K threads a candidate), which
:func:`beam_plan` picks from the candidates and the card's SMs; every
plan gives the same bits and metric.  Every operand is checked before the
library is loaded; they raise on anything the kernels do not take and when
the library cannot be built or a launch is refused: no path here falls
back to the plain versions (``wspr._beam_decode_plain``,
``rs_device.rs_ee_decode_plain``).  Neither syncs with the host, so each
can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from cwsl_digi_tpu_torch import kernel_build

# limits of weak.cu (checked against the library when it is loaded)
BEAM_W_MIN = 32           # the beam width: a power of two in this range
BEAM_W_MAX = 1024
BEAM_STEPS = 81           # WSPR's trellis: 50 message and 31 tail bits
BEAM_MSG_BITS = 50
RS_N_MAX = 63             # GF(64) words
# the plans weak.cu builds a beam width in: K, the keys a thread holds of
# the step's 2W expanded entries (and K / 2 of the W survivors), so a
# candidate takes 2W / K threads (32 to 1024)
BEAM_PLANS = {32: (2,), 64: (2, 4), 128: (2, 4), 256: (2, 4), 512: (2, 4),
              1024: (2, 4)}
RS_TABLE_BYTES = 4096 + 5 * 64   # mul, inv, xi, xi_inv, xfcr, roots

SRC = Path(__file__).parent / "csrc" / "weak.cu"
BUILD_DIR = Path(__file__).parent / "build"
EXTRA_FLAGS = ("--fmad=false",)

# launches of each kernel since the last reset (one per wrapper call that
# launches it)
launches = {"wspr_beam": 0, "rs_ee": 0}

_lock = threading.Lock()     # guards _lib and the counts
_lib: ctypes.CDLL | None = None
build_log = ""       # nvcc's output for the library in use (ptxas -v)


def build_library() -> Path:
    """Compile the kernel library unless this source's build exists."""
    global build_log
    out, log = kernel_build.build_library(SRC, BUILD_DIR, "weak", EXTRA_FLAGS)
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
            lib.wspr_beam_launch.argtypes = [i, i, i, p, p, p, p]
            lib.wspr_beam_launch.restype = i
            lib.wspr_beam_smem_bytes.argtypes = [i, i]
            lib.wspr_beam_smem_bytes.restype = i
            lib.wspr_beam_blocks_per_sm.argtypes = [i, i]
            lib.wspr_beam_blocks_per_sm.restype = i
            lib.rs_ee_launch.argtypes = [p] * 7
            lib.rs_ee_launch.restype = i
            lib.rs_ee_blocks_per_sm.argtypes = []
            lib.rs_ee_blocks_per_sm.restype = i
            lib.weak_kernel_attrs.argtypes = [i, i, i, p]
            lib.weak_kernel_attrs.restype = i
            limits = {"weak_beam_w_min": BEAM_W_MIN,
                      "weak_beam_w_max": BEAM_W_MAX,
                      "weak_beam_steps": BEAM_STEPS,
                      "weak_rs_n_max": RS_N_MAX,
                      "weak_rs_table_bytes": RS_TABLE_BYTES}
            for name, want in limits.items():
                getattr(lib, name).restype = i
                if getattr(lib, name)() != want:
                    raise RuntimeError(f"weak.cu {name} disagrees")
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


_sms: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    """The multiprocessors of a CUDA device (asked once a device)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _count(name: str) -> None:
    with _lock:         # decoders run on the pool's threads
        launches[name] += 1


def check_beam_width(w: int) -> None:
    """Raise unless ``wspr_beam`` takes beam width ``w``."""
    if not (BEAM_W_MIN <= w <= BEAM_W_MAX and w & (w - 1) == 0):
        raise ValueError(f"beam_width={w}: the kernel takes a power of two "
                         f"from {BEAM_W_MIN} to {BEAM_W_MAX}")


def beam_plan(n: int, beam_width: int, sms: int) -> int:
    """The keys a thread (K, of ``BEAM_PLANS``) of a ``wspr_beam`` launch
    of ``n`` candidates on a card of ``sms`` multiprocessors: where the
    candidates leave SMs idle (the App's 48), K = 2, the most threads a
    candidate and the shortest chain a step; where they fill the card, K
    = 4, half the shuffles and fewer barriers a candidate (on an H100 the
    faster at the bench's 576 and at 768 of width 1024; K = 8 and 16 were
    slower at every shape)."""
    check_beam_width(beam_width)
    plans = BEAM_PLANS[beam_width]
    return plans[0] if n <= sms else plans[-1]


def beam_chain(beam_width: int, keys: int) -> dict:
    """The dependent steps of one trellis step of a ``wspr_beam`` block
    at ``keys`` a thread: for each of its two bitonic sorts (the tail sort
    of W keys, K / 2 a thread; the top sort of 2W keys, K a thread) the
    compare stages within a thread's registers, between lanes of a warp
    (``__shfl_xor_sync``) and between warps (shared memory behind a block
    barrier); the block barriers (the shared stages, and one after the
    children's metrics and one after the survivors are written); and the
    dependent shared-memory loads of the group search (two binary
    liftings over the W sorted tails)."""
    check_beam_width(beam_width)
    if keys not in BEAM_PLANS[beam_width]:
        raise ValueError(f"keys={keys}: beam width {beam_width} is built "
                         f"for {BEAM_PLANS[beam_width]}")
    out = {}
    for name, nk, kk in (("tail", beam_width, keys // 2),
                         ("top", 2 * beam_width, keys)):
        kinds = {"register": 0, "shuffle": 0, "shared": 0}
        lg = nk.bit_length() - 1
        for lk in range(1, lg + 1):
            for lj in range(lk - 1, -1, -1):
                j = 1 << lj
                kinds["register" if j < kk else "shuffle" if j < 32 * kk
                      else "shared"] += 1
        out[name] = kinds
    lg_w = beam_width.bit_length() - 1
    out["threads"] = 2 * beam_width // keys
    out["stages"] = sum(sum(out[n].values()) for n in ("tail", "top"))
    out["block_barriers"] = out["tail"]["shared"] + out["top"]["shared"] + 2
    out["search_loads"] = 2 * lg_w
    return out


def wspr_beam(llr: torch.Tensor, beam_width: int, keys: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the beam search on PyTorch's current stream: llr [N, 81, 2]
    float32 (positive = coded bit 0), as ``wspr._beam_decode_plain`` takes
    it, one block a candidate in the plan of ``keys`` a thread (default
    :func:`beam_plan`'s).  Returns (best [N] float32, the best path's raw
    metric before the plain version's normalisation, and bits [N, 50]
    int8, the path's message bits)."""
    if llr.dim() != 3:
        raise ValueError("llr [N, 81, 2] must be 3-D")
    check_beam_width(beam_width)
    if keys is not None and keys not in BEAM_PLANS[beam_width]:
        raise ValueError(f"keys={keys}: beam width {beam_width} is built "
                         f"for {BEAM_PLANS[beam_width]}")
    n = llr.shape[0]
    if not 0 < n < 2 ** 31:
        raise ValueError(f"{n} candidates: the kernel takes 1 to 2**31 - 1")
    _check({"llr": (llr, torch.float32, (n, BEAM_STEPS, 2))})
    lib = load_library()
    if keys is None:
        keys = beam_plan(n, beam_width, _sm_count(llr.device))
    best = torch.empty(n, dtype=torch.float32, device=llr.device)
    bits = torch.empty((n, BEAM_MSG_BITS), dtype=torch.int8,
                       device=llr.device)
    with torch.cuda.device(llr.device):
        err = lib.wspr_beam_launch(
            n, beam_width, keys, llr.data_ptr(), best.data_ptr(),
            bits.data_ptr(),
            torch.cuda.current_stream(llr.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wspr_beam kernel launch failed: CUDA error "
                           f"{err} ({n} candidates, beam_width={beam_width},"
                           f" keys={keys})")
    _count("wspr_beam")
    return best, bits


def rs_ee(tables: torch.Tensor, syms: torch.Tensor, era: torch.Tensor,
          nroots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the errors-and-erasures decode on PyTorch's current stream:
    trial (c, t) decodes the word syms [c] (int64 symbols 0..63; the
    kernel reads each mod 64) with the erasure flags era [c, t], for syms
    [C, n] and era [C, T, n] bool, C T < 2**31, a warp a trial;
    ``tables`` is ``rs_device.kernel_tables``'s uint8 block on the device;
    the blocks, as many as the card holds at once, split the trials into
    a contiguous share a warp, so that a candidate's syndromes serve all
    its trials in the share.  Returns (corrected [C, T, n] uint8, ok [C, T] bool), as
    ``rs_device.rs_ee_decode_plain`` computes them for each trial."""
    if syms.dim() != 2 or era.dim() != 3:
        raise ValueError("syms [C, n] and era [C, T, n] must be 2- and 3-D")
    c, n = syms.shape
    t = era.shape[1]
    if not 2 <= n <= RS_N_MAX:
        raise ValueError(f"n={n}: the kernel takes words of 2 to {RS_N_MAX} "
                         "symbols")
    if not 0 < nroots < n:
        raise ValueError(f"nroots={nroots}: the kernel takes 1 to n - 1")
    if not (c > 0 and t > 0 and c * t < 2 ** 31):
        raise ValueError(f"{c} x {t} trials: the kernel takes 1 to 2**31 - 1")
    _check({"syms": (syms, torch.int64, (c, n)),
            "era": (era, torch.bool, (c, t, n)),
            "tables": (tables, torch.uint8, (RS_TABLE_BYTES,))})
    corrected = torch.empty((c, t, n), dtype=torch.uint8, device=syms.device)
    ok = torch.empty((c, t), dtype=torch.bool, device=syms.device)
    lib = load_library()
    dims = (ctypes.c_int * 4)(c, t, n, nroots)
    with torch.cuda.device(syms.device):
        err = lib.rs_ee_launch(
            ctypes.addressof(dims), tables.data_ptr(), syms.data_ptr(),
            era.data_ptr(), corrected.data_ptr(), ok.data_ptr(),
            torch.cuda.current_stream(syms.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rs_ee kernel launch failed: CUDA error {err} "
                           f"({c} x {t} trials of RS({n}, {n - nroots}))")
    _count("rs_ee")
    return corrected, ok


def rs_blocks_per_sm(device) -> int:
    """The ``rs_ee`` blocks an SM of ``device`` holds at once."""
    with torch.cuda.device(device):
        got = load_library().rs_ee_blocks_per_sm()
    if got < 0:
        raise RuntimeError(f"rs_ee_blocks_per_sm: CUDA error {-got}")
    return got


def _plan_keys(beam_width: int, keys: int | None) -> int:
    """``keys``, or the plan of a launch that fills the card."""
    check_beam_width(beam_width)
    if keys is None:
        return BEAM_PLANS[beam_width][-1]
    if keys not in BEAM_PLANS[beam_width]:
        raise ValueError(f"keys={keys}: beam width {beam_width} is built "
                         f"for {BEAM_PLANS[beam_width]}")
    return keys


def beam_smem_bytes(beam_width: int, keys: int | None = None) -> int:
    """Dynamic shared memory of a ``wspr_beam`` block at ``beam_width`` in
    the plan of ``keys`` a thread (default: the last of the width's)."""
    keys = _plan_keys(beam_width, keys)
    return load_library().wspr_beam_smem_bytes(beam_width, keys)


def beam_blocks_per_sm(device, beam_width: int,
                       keys: int | None = None) -> int:
    """The ``wspr_beam`` blocks an SM of ``device`` holds at once at
    ``beam_width`` in the plan of ``keys`` a thread."""
    keys = _plan_keys(beam_width, keys)
    with torch.cuda.device(device):
        got = load_library().wspr_beam_blocks_per_sm(beam_width, keys)
    if got < 0:
        raise RuntimeError(f"wspr_beam_blocks_per_sm: CUDA error {-got}")
    return got


def kernel_attrs(device, beam_width: int = 512,
                 keys: int | None = None) -> dict:
    """Each weak kernel's registers a thread, spilled (local) bytes a
    thread, static shared bytes and threads a block at most, as
    ``cudaFuncGetAttributes`` gives them; ``wspr_beam`` at ``beam_width``
    in the plan of ``keys`` a thread."""
    keys = _plan_keys(beam_width, keys)
    lib = load_library()
    out = {}
    for which, name in enumerate(("wspr_beam", "rs_ee")):
        vals = (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            err = lib.weak_kernel_attrs(which, beam_width, keys,
                                        ctypes.addressof(vals))
        if err != 0:
            raise RuntimeError(f"weak_kernel_attrs({name}): CUDA error {err}")
        out[name] = dict(zip(("registers", "local_bytes", "static_smem_bytes",
                              "max_threads"), list(vals)))
    return out
