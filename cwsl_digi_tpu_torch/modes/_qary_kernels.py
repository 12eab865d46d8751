"""Build, bind and launch the hand-written kernels of the q-ary modes'
device stages: Q65's GF(64) sum-product decode (``qra_mp``), the q-ary
sync correlation with its top-K (``qary_sync``) and the data symbols' tone
gather with its top-4 (``qary_symbols``).  The median of their maps is
:mod:`._median_kernels`'s.

``csrc/qary.cu`` is compiled with ``nvcc`` for ``sm_90a`` and
``--fmad=false`` into a shared library with a plain C interface, at first
use, into ``build/`` beside this file, named by the source's hash
(:mod:`cwsl_digi_tpu_torch.kernel_build`), and loaded with ctypes.
Importing this module builds nothing: the CPU tests import it on machines
with no ``nvcc``.

``qra.QaryMPDecoder.decode`` calls :func:`qra_mp` on CUDA tensors,
``qary_engine._qary_sync`` :func:`qary_sync` and
``qary_engine._symbol_energies`` :func:`qary_symbols`.  Every operand is
checked before the library is loaded; they raise on anything the kernels
do not take and when the library cannot be built or a launch is refused:
no path here falls back to the plain versions
(``QaryMPDecoder.decode_plain``, ``qary_engine._qary_sync_plain``,
``qary_engine._symbol_energies_plain``).  None syncs with the host.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from cwsl_digi_tpu_torch import kernel_build

# limits of qary.cu (checked against the library when it is loaded)
Q = 64
MP_N_MAX = 64             # code length
MP_NC_MAX = 63            # checks
MP_MR_MAX = 4             # slots a check
MP_COL_MAX = 4            # edges a variable
MP_BLOCKS_SM = 4          # qra_mp blocks an SM the design holds (Q65)
SYNC_TF = 32              # bins a qary_sync strip
SYNC_RING = 256           # rows of a block's ring
SYNC_AHEAD = 8            # windows whose rows load ahead of the sum
SYNC_LIST_CAP = 4096      # candidates a window's merge holds
SYNC_T_MAX = 128          # time offsets
SYNC_S_MAX = 128          # sync symbols
SYNC_K_MAX = 256          # top-K
SYM_TONES = 64            # tones a symbol (qary_symbols takes no other)
SYM_GROUP = 8             # qary_symbols' lanes a row

SRC = Path(__file__).parent / "csrc" / "qary.cu"
BUILD_DIR = Path(__file__).parent / "build"
EXTRA_FLAGS = ("--fmad=false",)

# launches of each kernel since the last reset (one per wrapper call that
# launches it)
launches = {"qra_mp": 0, "qary_sync": 0, "qary_symbols": 0}

_lock = threading.Lock()     # guards _lib and the counts
_lib: ctypes.CDLL | None = None
build_log = ""       # nvcc's output for the library in use (ptxas -v)


def build_library() -> Path:
    """Compile the kernel library unless this source's build exists."""
    global build_log
    out, log = kernel_build.build_library(SRC, BUILD_DIR, "qary", EXTRA_FLAGS)
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
            lib.qra_mp_launch.argtypes = [p] * 7
            lib.qra_mp_launch.restype = i
            lib.qra_mp_table_bytes.argtypes = [i] * 5
            lib.qra_mp_table_bytes.restype = i
            lib.qra_mp_smem_bytes.argtypes = [i] * 2
            lib.qra_mp_smem_bytes.restype = i
            lib.qra_mp_blocks_per_sm.argtypes = [p, p]
            lib.qra_mp_blocks_per_sm.restype = i
            lib.qary_sync_launch.argtypes = [p] * 9
            lib.qary_sync_launch.restype = i
            lib.qary_sync_occupancy.argtypes = [i, i, p]
            lib.qary_sync_occupancy.restype = i
            lib.qary_symbols_launch.argtypes = [p] * 11
            lib.qary_symbols_launch.restype = i
            lib.qary_symbols_design.argtypes = [p]
            lib.qary_symbols_design.restype = i
            lib.qary_kernel_attrs.argtypes = [i, p]
            lib.qary_kernel_attrs.restype = i
            limits = {"qary_mp_n_max": MP_N_MAX, "qary_mp_nc_max": MP_NC_MAX,
                      "qary_mp_mr_max": MP_MR_MAX,
                      "qary_mp_col_max": MP_COL_MAX,
                      "qary_mp_blocks_sm": MP_BLOCKS_SM,
                      "qary_sync_tf": SYNC_TF, "qary_sync_ring": SYNC_RING,
                      "qary_sync_ahead": SYNC_AHEAD,
                      "qary_sync_list_cap": SYNC_LIST_CAP,
                      "qary_sync_t_max": SYNC_T_MAX,
                      "qary_sync_s_max": SYNC_S_MAX,
                      "qary_sync_k_max": SYNC_K_MAX,
                      "qary_symbols_tones": SYM_TONES,
                      "qary_symbols_group": SYM_GROUP}
            for name, want in limits.items():
                getattr(lib, name).restype = i
                if getattr(lib, name)() != want:
                    raise RuntimeError(f"qary.cu {name} disagrees")
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


def mp_table_bytes(n: int, nc: int, mr: int, max_col: int,
                   edges: int) -> int:
    """Bytes of ``qra_mp``'s table block (``QaryMPDecoder.kernel_tables``):
    h_vars and h_coeff [nc mr], fwd and bwd [nc mr 64], col_slots [n
    max_col], gf_mul [64 64], e_slot [edges]."""
    return 2 * nc * mr + 2 * nc * mr * Q + n * max_col + Q * Q + edges


def check_mp_code(n: int, nc: int, mr: int, max_col: int) -> None:
    """Raise unless ``qra_mp`` takes a code of these dimensions."""
    if not (1 <= n <= MP_N_MAX and 1 <= nc <= MP_NC_MAX
            and 1 <= mr <= MP_MR_MAX and 1 <= max_col <= MP_COL_MAX
            and nc * mr <= 255):
        raise ValueError(f"code n={n}, {nc} checks x {mr} slots, {max_col} "
                         f"edges a variable: the kernel takes n <= {MP_N_MAX},"
                         f" at most {MP_NC_MAX} checks of {MP_MR_MAX} slots "
                         f"(255 slots) and {MP_COL_MAX} edges a variable")


def mp_edges(tables: torch.Tensor, code: tuple[int, int, int, int]) -> int:
    """The code's edges (real slots), from the length of its table block:
    the block ends with one byte an edge.  Raises unless ``tables`` is a
    contiguous 1-D uint8 block of 1 to nc mr edges."""
    n, nc, mr, max_col = code
    if tables.dtype != torch.uint8 or tables.dim() != 1:
        raise ValueError(f"tables: {tables.dtype} of {tuple(tables.shape)}, "
                         "kernel needs a 1-D uint8 block")
    if not tables.is_contiguous():
        raise ValueError("tables: not contiguous")
    edges = tables.numel() - mp_table_bytes(n, nc, mr, max_col, 0)
    if not 1 <= edges <= nc * mr:
        raise ValueError(f"tables: shape {tuple(tables.shape)}, kernel "
                         f"needs {mp_table_bytes(n, nc, mr, max_col, 1)} to "
                         f"{mp_table_bytes(n, nc, mr, max_col, nc * mr)} "
                         "bytes")
    return edges


def qra_mp(tables: torch.Tensor, probs: torch.Tensor,
           code: tuple[int, int, int, int], iters: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the sum-product decode on PyTorch's current stream, a block a
    word: ``code`` = (n, nc, mr, max_col), ``tables`` the uint8 block of
    ``QaryMPDecoder.kernel_tables`` on the device, probs [B, n, 64]
    float32.  Returns (hard [B, n] int64, ok [B] bool, conf [B] float32),
    as ``QaryMPDecoder.decode_plain``."""
    n, nc, mr, max_col = code
    check_mp_code(n, nc, mr, max_col)
    if probs.dim() != 3:
        raise ValueError("probs [B, n, 64] must be 3-D")
    if iters < 0:
        raise ValueError(f"iters={iters}: the kernel takes 0 or more")
    b = probs.shape[0]
    if not 0 < b < 2 ** 31:
        raise ValueError(f"{b} words: the kernel takes 1 to 2**31 - 1")
    edges = mp_edges(tables, code)
    _check({"probs": (probs, torch.float32, (b, n, Q)),
            "tables": (tables, torch.uint8,
                       (mp_table_bytes(n, nc, mr, max_col, edges),))})
    hard = torch.empty((b, n), dtype=torch.int64, device=probs.device)
    ok = torch.empty(b, dtype=torch.bool, device=probs.device)
    conf = torch.empty(b, dtype=torch.float32, device=probs.device)
    lib = load_library()
    dims = (ctypes.c_int * 7)(b, n, nc, mr, max_col, edges, iters)
    with torch.cuda.device(probs.device):
        err = lib.qra_mp_launch(
            ctypes.addressof(dims), tables.data_ptr(), probs.data_ptr(),
            hard.data_ptr(), ok.data_ptr(), conf.data_ptr(),
            torch.cuda.current_stream(probs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qra_mp kernel launch failed: CUDA error {err} "
                           f"({b} words, {iters} iterations)")
    _count("qra_mp")
    return hard, ok, conf


def check_sync(n_t0: int, n_sync: int, k: int) -> None:
    """Raise unless ``qary_sync`` takes ``n_t0`` time offsets, ``n_sync``
    sync symbols and top-``k``."""
    if not (1 <= n_t0 <= SYNC_T_MAX and 1 <= n_sync <= SYNC_S_MAX
            and 1 <= k <= SYNC_K_MAX):
        raise ValueError(f"max_hops={n_t0}, {n_sync} sync symbols, top_k={k}"
                         f": the kernel takes at most {SYNC_T_MAX} time "
                         f"offsets, {SYNC_S_MAX} sync symbols and top_k "
                         f"{SYNC_K_MAX}")


def sync_lists(k: int) -> int:
    """The lists (blocks) a window's ``qary_sync`` merge takes at most at
    top-``k``: k candidates of each fit SYNC_LIST_CAP."""
    return max(1, SYNC_LIST_CAP // k)


def sync_pool_cap(k: int) -> int:
    """Candidates a ``qary_sync`` strip's pool holds at most: the block's
    list of ``k`` and the cells of the ``k`` threads whose maxima reach
    the strip's threshold (every thread's where k reaches the block's
    256 threads)."""
    return k + min(k, 256) * 16


def sync_plan(n_f0: int, k: int) -> dict:
    """The ``qary_sync`` launch for windows of ``n_f0`` bins at top-``k``:
    the strips of SYNC_TF bins and the lists (blocks) a window; each block
    takes every ``lists``-th strip."""
    strips = -(-n_f0 // SYNC_TF)
    return {"strips": strips, "lists": min(strips, sync_lists(k))}


def qary_sync(power_sync: torch.Tensor, base: torch.Tensor,
              hops: torch.Tensor, n_t0: int, n_f0: int, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the sync correlation and its top-K on PyTorch's current
    stream: power_sync [B, H, F] float32, base [B] float32 (the map's mean
    times the sync count), hops [S] int32 (the sync symbols' first rows,
    ascending, hops[-1] + n_t0 <= H); the score of (t0, f0) is the sum
    over the hops h, in order, of power_sync[:, h + t0, f0], over base +
    1e-30, for t0 < n_t0 and f0 < n_f0.  Returns (top_val [B, k] float32,
    top_idx [B, k] int64), the stable descending top-k of the scores
    flattened t0-major, as ``qary_engine._qary_sync_plain``.  One
    launch."""
    if power_sync.dim() != 3:
        raise ValueError("power_sync [B, H, F] must be 3-D")
    b, h, f = power_sync.shape
    s = hops.shape[0] if hops.dim() == 1 else 0
    check_sync(n_t0, s, k)
    if not (0 < b <= 65535 and 0 < n_f0 <= f and n_t0 * n_f0 >= k):
        raise ValueError(f"{b} windows, n_f0={n_f0} of {f} bins, {n_t0} x "
                         f"{n_f0} scores for top_k={k}: the kernel takes 1 "
                         "to 65535 windows and top_k at most the scores")
    _check({"power_sync": (power_sync, torch.float32, (b, h, f)),
            "base": (base, torch.float32, (b,)),
            "hops": (hops, torch.int32, (s,))})
    dev = power_sync.device
    plan = sync_plan(n_f0, k)
    cand_key = torch.empty((b, plan["lists"], k), dtype=torch.int64,
                           device=dev)
    cand_val = torch.empty((b, plan["lists"], k), dtype=torch.float32,
                           device=dev)
    top_val = torch.empty((b, k), dtype=torch.float32, device=dev)
    top_idx = torch.empty((b, k), dtype=torch.int64, device=dev)
    lib = load_library()
    dims = (ctypes.c_int * 8)(b, h, f, n_t0, n_f0, s, k, plan["lists"])
    with torch.cuda.device(dev):
        err = lib.qary_sync_launch(
            ctypes.addressof(dims), power_sync.data_ptr(), base.data_ptr(),
            hops.data_ptr(), cand_key.data_ptr(), cand_val.data_ptr(),
            top_val.data_ptr(), top_idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qary_sync kernel launch failed: CUDA error {err}"
                           f" ({b} windows of {n_t0} x {n_f0}, top_k={k})")
    _count("qary_sync")
    return top_val, top_idx


def check_symbols(n_tones: int) -> None:
    """Raise unless ``qary_symbols`` takes symbols of ``n_tones`` tones."""
    if n_tones != SYM_TONES:
        raise ValueError(f"n_tones={n_tones}: qary_symbols takes "
                         f"{SYM_TONES} tones a symbol")


def qary_symbols(power: torch.Tensor, t0: torch.Tensor, f0: torch.Tensor,
                 rows: torch.Tensor, rows_max: int, n_t0: int, n_f0: int,
                 os_f: int, tone0: int, full_e: bool
                 ) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """Launch the tone gather and top-4 on PyTorch's current stream,
    SYM_GROUP lanes a (window, candidate, data symbol), in a grid of the
    blocks the card holds at once: power [B, H, F] float32, t0 / f0
    [B, K] int64 (t0 < n_t0, f0 < n_f0, as the sync search gives them),
    rows [n] int32 (os_t x the data symbols, at most ``rows_max``); tone j
    of symbol s is power[b, t0 + rows[s], f0 + tone0 + os_f j] for j < 64.
    Returns (e [B, K, n, 64] float32 or None without ``full_e``, top_e
    [B, K, n, 4] float32, top_tone [B, K, n, 4] int64, e_sum [B, K, n]
    float32, margin [B, K, n] float32), as
    ``qary_engine._symbol_energies_plain``.  One launch."""
    if power.dim() != 3 or t0.dim() != 2 or rows.dim() != 1:
        raise ValueError("power [B, H, F], t0 / f0 [B, K] and rows [n] must "
                         "be 3-, 2- and 1-D")
    b, h, f = power.shape
    k, n = t0.shape[1], rows.shape[0]
    if not (0 < b and 0 < k and 0 < n and b * k * n < 2 ** 31):
        raise ValueError(f"{b} x {k} x {n} rows: the kernel takes 1 to "
                         "2**31 - 1")
    if not (0 < n_t0 and 0 <= rows_max and n_t0 - 1 + rows_max < h
            and 0 < n_f0 and 0 < os_f and 0 <= tone0
            and n_f0 - 1 + tone0 + (SYM_TONES - 1) * os_f < f):
        raise ValueError(f"t0 < {n_t0} + rows up to {rows_max} of {h}, f0 < "
                         f"{n_f0} + {tone0} + 63 x {os_f} of {f} bins: a "
                         "tone would lie outside the map")
    _check({"power": (power, torch.float32, (b, h, f)),
            "t0": (t0, torch.int64, (b, k)), "f0": (f0, torch.int64, (b, k)),
            "rows": (rows, torch.int32, (n,))})
    dev = power.device
    e = torch.empty((b, k, n, SYM_TONES) if full_e else (1,),
                    dtype=torch.float32, device=dev)
    top_e = torch.empty((b, k, n, 4), dtype=torch.float32, device=dev)
    top_tone = torch.empty((b, k, n, 4), dtype=torch.int64, device=dev)
    e_sum = torch.empty((b, k, n), dtype=torch.float32, device=dev)
    margin = torch.empty((b, k, n), dtype=torch.float32, device=dev)
    lib = load_library()
    dims = (ctypes.c_int * 10)(b, h, f, k, n, n_t0, n_f0, os_f, tone0,
                               int(full_e))
    with torch.cuda.device(dev):
        err = lib.qary_symbols_launch(
            ctypes.addressof(dims), power.data_ptr(), t0.data_ptr(),
            f0.data_ptr(), rows.data_ptr(), e.data_ptr(), top_e.data_ptr(),
            top_tone.data_ptr(), e_sum.data_ptr(), margin.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qary_symbols kernel launch failed: CUDA error "
                           f"{err} ({b} x {k} candidates, {n} symbols)")
    _count("qary_symbols")
    return (e if full_e else None), top_e, top_tone, e_sum, margin


def sync_occupancy(device, k: int, lists: int) -> dict:
    """A ``qary_sync`` block's dynamic shared memory at top-``k`` and
    ``lists`` lists a window, and the blocks an SM of ``device`` holds at
    it."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = load_library().qary_sync_occupancy(k, lists,
                                                 ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"qary_sync_occupancy: CUDA error {err}")
    return {"dynamic_smem_bytes": out[0], "blocks_an_sm": out[1]}


def symbols_design(device) -> dict:
    """``qary_symbols``' layout on ``device``: lanes a row, rows a warp,
    blocks an SM and the grid's cap (the blocks the card holds at once)."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = load_library().qary_symbols_design(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"qary_symbols_design: CUDA error {err}")
    return dict(zip(("lanes_a_row", "rows_a_warp", "blocks_an_sm",
                     "grid_cap"), list(out)))


def mp_smem_bytes(n: int, edges: int) -> int:
    """Dynamic shared memory of a ``qra_mp`` block for a code of ``n``
    variables and ``edges`` edges."""
    return load_library().qra_mp_smem_bytes(n, edges)


def mp_blocks_per_sm(device, code: tuple[int, int, int, int],
                     edges: int) -> int:
    """Resident ``qra_mp`` blocks an SM of ``device`` for this code
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = load_library()
    dims = (ctypes.c_int * 7)(1, *code, edges, 0)
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.qra_mp_blocks_per_sm(ctypes.addressof(dims),
                                       ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"qra_mp_blocks_per_sm: CUDA error {err}")
    return out.value


def kernel_attrs(device) -> dict:
    """Each q-ary kernel's registers a thread, spilled (local) bytes a
    thread, static shared bytes and threads a block at most, as
    ``cudaFuncGetAttributes`` gives them."""
    lib = load_library()
    out = {}
    for which, name in enumerate(("qra_mp", "qary_sync", "qary_symbols")):
        vals = (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            err = lib.qary_kernel_attrs(which, ctypes.addressof(vals))
        if err != 0:
            raise RuntimeError(f"qary_kernel_attrs({name}): CUDA error {err}")
        out[name] = dict(zip(("registers", "local_bytes", "static_smem_bytes",
                              "max_threads"), list(vals)))
    return out
