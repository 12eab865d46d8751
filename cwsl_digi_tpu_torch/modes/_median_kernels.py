"""Build, bind and launch the hand-written exact median of each row of a
map (``median_rows``): the q-ary modes' sync-map and prior medians, WSPR's
and the GFSK engine's SNR medians.

``csrc/median.cu`` is compiled with ``nvcc`` for ``sm_90a`` and
``--fmad=false`` into a shared library with a plain C interface, at first
use, into ``build/`` beside this file, named by the source's hash
(:mod:`cwsl_digi_tpu_torch.kernel_build`), and loaded with ctypes.
Importing this module builds nothing: the CPU tests import it on machines
with no ``nvcc``.

:func:`median_plan` picks the kernel's plan from a row's length (the
source's header says what each does): ``small``, one block a row with the
row in shared memory; ``mid``, a thread-block cluster a row; ``large``, a
sample, one streaming read and the candidates between the sample's two
keys.

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

import numpy as np
import torch

from cwsl_digi_tpu_torch import kernel_build

# limits and plans of median.cu (checked against the library when it is
# loaded)
WS_WORDS = 8              # a row's uint32 workspace in the large plan
ROWS_MAX = 65535
SAMPLE = 16384            # the large plan's sample a row
MARGIN = 384              # ... its ranks outside the middle ranks' places
FIN_CAP = 256             # keys sorted at the end of a selection
STREAM_CHUNK = 16384      # entries a block of the large plan's stream
KEYS_BLOCK = 8192         # the longest row a block holds alone
KEYS_BLOCK_MID_MAX = 32768   # the most keys a cluster's block holds
MAX_CLUSTER = 16
SMALL_THREADS = 256
MID_THREADS = 512
MID_WAVE_BLOCKS = 132     # mid clusters run best at about a block an SM
ONCHIP_MAX = MAX_CLUSTER * KEYS_BLOCK_MID_MAX   # longest on-chip row
LARGE_CAP_DIV = 8         # the candidate buffer: a row's length / 8
SAMPLE_THREADS = FINISH_THREADS = 512   # the large plan's cluster blocks
SAMPLE_CLUSTER = FINISH_CLUSTER = 8
SAMPLE_SMEM_BYTES = 4 * (SAMPLE // SAMPLE_CLUSTER + 2048)
FINISH_SMEM_BYTES = 4 * 8192
STREAM_THREADS = 256
SMEM_BLOCK_MAX = 232_448
STATIC_SMEM = (9_424, 25_792)     # the small and mid blocks' static bytes
CAND_MAX = 16384          # keys a mid plan's rank 0 goes on alone with
CAND_SHARE = 10           # ... a tenth of a row (a noise row's first
                          # digit at the median holds ~6 %), at least 2048
PLANS = ("small", "mid", "large")
# the library's kernels (median_kernel_attrs' which)
KERNELS = ("onchip_small", "onchip_mid", "large_sample", "large_stream",
           "large_finish")

SRC = Path(__file__).parent / "csrc" / "median.cu"
BUILD_DIR = Path(__file__).parent / "build"
EXTRA_FLAGS = ("--fmad=false",)

# launches since the last reset (one per wrapper call; the large plan's
# three kernels count as one)
launches = {"median_rows": 0}

_lock = threading.Lock()     # guards _lib, _fits16 and the counts
_lib: ctypes.CDLL | None = None
_fits16: dict[int, bool] = {}
build_log = ""       # nvcc's output for the library in use (ptxas -v)


def median_plan(n: int, fits16: bool = True, plan: str | None = None,
                cluster: int = 0, rows: int = 1) -> dict:
    """The plan for ``rows`` rows of ``n`` values.  By default: ``small``
    (one block a row) up to KEYS_BLOCK; ``large`` above ONCHIP_MAX; else
    ``mid``, a cluster of the most blocks (a power of two, at most
    MAX_CLUSTER, MAX_CLUSTER / 2 where the card holds no such cluster,
    ``fits16`` False) whose rows take at most MID_WAVE_BLOCKS blocks (more
    blocks load a row faster, and a cluster costs the same few barriers
    whatever its size; past about a block an SM they queue), but at least
    the fewest that leave at most KEYS_BLOCK_MID_MAX keys a block.
    ``plan`` forces a plan, ``cluster`` the blocks of an on-chip one (1 to
    16, a power of two).
    Returns {"plan", "cluster", "threads", "keys_a_block", "cand",
    "smem_bytes"} (the on-chip plans; cand: the keys a cluster's rank 0
    goes on alone with) or {"plan", "sample", "cap", "chunks"}."""
    if plan not in (None, *PLANS):
        raise ValueError(f"plan {plan!r}: one of {PLANS}")
    if plan == "large" or (plan is None and cluster == 0 and n > ONCHIP_MAX):
        if n <= SAMPLE:
            raise ValueError(f"{n} values a row: the large plan takes more "
                             f"than {SAMPLE}")
        return {"plan": "large", "sample": SAMPLE,
                "cap": -(-n // LARGE_CAP_DIV),
                "chunks": -(-n // STREAM_CHUNK)}
    if cluster:
        c = cluster
    elif plan == "small" or (plan is None and n <= KEYS_BLOCK):
        c = 1
    else:
        top = MAX_CLUSTER if fits16 else MAX_CLUSTER // 2
        least = 2
        while least < top and -(-n // least) > KEYS_BLOCK_MID_MAX:
            least *= 2
        c = top
        while c > least and rows * c > MID_WAVE_BLOCKS:
            c //= 2
    if c not in (1, 2, 4, 8, 16) or (plan == "small" and c != 1) or (
            plan == "mid" and c == 1):
        raise ValueError(f"cluster {c} for plan {plan}")
    kpb = -(-n // c)
    cand = 0 if c == 1 else min(CAND_MAX, max(2048, -(-n // CAND_SHARE)))
    smem = 4 * (kpb + cand)
    if smem + STATIC_SMEM[c > 1] > SMEM_BLOCK_MAX:
        if plan is None and cluster == 0:
            # (a card without 16-block clusters, a row near ONCHIP_MAX)
            return median_plan(n, plan="large")
        raise ValueError(f"{n} values a row: {kpb} keys a block exceed a "
                         f"block's shared memory at {c} blocks a row")
    return {"plan": "small" if c == 1 else "mid", "cluster": c,
            "threads": SMALL_THREADS if c == 1 else MID_THREADS,
            "keys_a_block": kpb, "cand": cand, "smem_bytes": smem}


def sample_positions(n: int) -> np.ndarray:
    """The large plan's sample of a row of n (> SAMPLE): one entry in each
    of SAMPLE strata at a hashed offset (``median.cu`` ``sample_pos``)."""
    j = np.arange(SAMPLE, dtype=np.int64)
    return j * n // SAMPLE + ((j * 2654435761) & 0xFFFFFFFF) % (n // SAMPLE)


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
            lib.median_onchip_launch.argtypes = [ll, ll, i, i, ll, ll, ll, i,
                                                 i, i, i, p, p, p]
            lib.median_onchip_launch.restype = i
            lib.median_large_launch.argtypes = [ll, ll, ll, ll, p, p, p, p,
                                                p]
            lib.median_large_launch.restype = i
            lib.median_kernel_attrs.argtypes = [i, p]
            lib.median_kernel_attrs.restype = i
            lib.median_occupancy.argtypes = [i, i, i, i, p]
            lib.median_occupancy.restype = i
            lib.median_fits16.argtypes = [p]
            lib.median_fits16.restype = i
            for which, want in enumerate(STATIC_SMEM):
                vals = (ctypes.c_int * 4)()
                if lib.median_kernel_attrs(which, ctypes.addressof(vals)) \
                        == 0 and vals[2] > want:
                    raise RuntimeError("median.cu's static shared memory "
                                       "exceeds STATIC_SMEM")
            for fn, want in (("median_ws_words", WS_WORDS),
                             ("median_sample_size", SAMPLE),
                             ("median_margin", MARGIN),
                             ("median_fin_cap", FIN_CAP),
                             ("median_cand_max", CAND_MAX),
                             ("median_stream_chunk", STREAM_CHUNK)):
                getattr(lib, fn).restype = i
                if getattr(lib, fn)() != want:
                    raise RuntimeError(f"median.cu {fn} disagrees")
            _lib = lib
        return _lib


def fits16(device) -> bool:
    """Whether the card holds a 16-block cluster of the mid plan (asked
    once a device)."""
    lib = load_library()
    idx = torch.device(device).index or 0
    with _lock:
        if idx in _fits16:
            return _fits16[idx]
    v = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.median_fits16(ctypes.byref(v))
    if err != 0:
        raise RuntimeError(f"median_fits16: CUDA error {err}")
    with _lock:
        _fits16[idx] = bool(v.value)
    return bool(v.value)


def _check(x: torch.Tensor) -> None:
    """The rows' dtype, layout and device."""
    if x.dtype != torch.float32:
        raise ValueError(f"x: dtype {x.dtype}, kernel needs torch.float32")
    if x.dim() == 2 and not x.is_contiguous():
        raise ValueError("x: not contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"x: on {x.device}, kernel needs a CUDA device")


def median_rows(x: torch.Tensor, plan: str | None = None,
                cluster: int = 0) -> torch.Tensor:
    """Launch the median of each row of x on PyTorch's current stream: the
    middle value, or the mean of the two middle values for an even count,
    NaN for a row that holds a NaN, -0.0 read as 0.0, as
    ``gfsk_engine._median_rows_plain``.  x is float32 [R, N], contiguous,
    or [R, A, B] with any strides (FT8's ``[:, ::4, ::4]`` view of its
    power map; row r is x[r], read where it lies), contiguous in the large
    plan.  ``plan`` and ``cluster`` force a plan (:func:`median_plan`).
    Returns [R] float32."""
    if x.dim() not in (2, 3):
        raise ValueError("x [R, N] must be 2-D, or a 3-D view [R, A, B]")
    r = x.shape[0]
    n = 1
    for s in x.shape[1:]:
        n *= s
    if not 0 < r <= ROWS_MAX:
        raise ValueError(f"{r} rows: the kernel takes 1 to {ROWS_MAX}")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"{n} values a row: the kernel takes 1 to 2**31 - 1")
    large = plan == "large" or (plan is None and cluster == 0
                                and n > ONCHIP_MAX)
    if large and not x.is_contiguous():
        raise ValueError(f"x: a strided view of rows longer than "
                         f"{ONCHIP_MAX}: the large plan needs them "
                         "contiguous")
    _check(x)
    if large:
        p = median_plan(n, plan="large")
    lib = load_library()
    if not large:
        p = median_plan(n, fits16(x.device) if n > KEYS_BLOCK else True,
                        plan, cluster, r)
    out = torch.empty(r, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if large:
            ws = torch.empty((r, WS_WORDS), dtype=torch.int32,
                             device=x.device)
            buf = torch.empty((r, p["cap"]), dtype=torch.int32,
                              device=x.device)
            err = lib.median_large_launch(
                r, n, x.stride(0), p["cap"], x.data_ptr(), ws.data_ptr(),
                buf.data_ptr(), out.data_ptr(), stream)
        else:
            if x.dim() == 2:
                a, b, sa, sb = 1, n, 0, 1
            else:
                a, b = x.shape[1], x.shape[2]
                sa, sb = x.stride(1), x.stride(2)
            err = lib.median_onchip_launch(
                r, n, a, b, x.stride(0), sa, sb, p["cluster"], p["threads"],
                p["keys_a_block"], p["cand"], x.data_ptr(), out.data_ptr(),
                stream)
    if err != 0:
        raise RuntimeError(f"median_rows kernel launch failed: CUDA error "
                           f"{err} ({r} rows of {n}, plan {p})")
    with _lock:         # decoders run on the pool's threads
        launches["median_rows"] += 1
    return out


def _attrs(lib, which: int, device) -> dict:
    vals = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = lib.median_kernel_attrs(which, ctypes.addressof(vals))
    if err != 0:
        raise RuntimeError(f"median_kernel_attrs: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "max_threads"), list(vals)))


def kernel_attrs(device) -> dict:
    """The on-chip kernel's (the mid plan's instance: most launches run
    it) registers a thread, spilled (local) bytes a thread, static shared
    bytes and threads a block at most, as ``cudaFuncGetAttributes`` gives
    them: {"median_rows": {...}}; every kernel's in
    :func:`instance_attrs`."""
    return {"median_rows": _attrs(load_library(), 1, device)}


def instance_attrs(device) -> dict:
    """Every kernel of the library, as :func:`kernel_attrs`: {name in
    KERNELS: {...}}."""
    lib = load_library()
    return {name: _attrs(lib, i, device) for i, name in enumerate(KERNELS)}


def occupancy(device, which: str, threads: int, smem: int,
              cluster: int = 1) -> dict:
    """Blocks of kernel ``which`` (a name of KERNELS) with ``threads`` and
    ``smem`` dynamic shared bytes an SM holds, and for a cluster the
    clusters the card holds at once (``cudaOccupancy...``)."""
    lib = load_library()
    vals = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = lib.median_occupancy(KERNELS.index(which), threads, smem,
                                   cluster, ctypes.addressof(vals))
    if err != 0:
        raise RuntimeError(f"median_occupancy: CUDA error {err}")
    return {"blocks_an_sm": vals[0], "clusters": vals[1]}
