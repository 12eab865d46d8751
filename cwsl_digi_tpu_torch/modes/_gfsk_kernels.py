"""Build, bind and launch the hand-written GFSK decode kernels: burst
subtraction (``subtract_known``) and the coherent multi-symbol LLRs
(``multisym_llrs``).

``csrc/gfsk.cu`` is compiled with ``nvcc`` for ``sm_90a`` and
``--fmad=false`` (so the synthesis phase and the reference-order cumsums
round as the plain versions') into a shared library with a plain C
interface, at first use, into ``build/`` beside this file, named by the
source's hash (:mod:`cwsl_digi_tpu_torch.kernel_build`), and loaded with
ctypes.  Importing this module builds nothing: the CPU tests import it on
machines with no ``nvcc``.

:func:`subtract_known`, :func:`candidate_llrs` and :func:`multisym_llrs`
are the kernels' only wrappers; the last two are entries of one kernel (the
decode's, from the demod spectrogram, and one from gathered symbol spectra
``csym``).  They check every operand before the library is loaded, raise on
anything the kernels do not take and when the library cannot be built or a
launch is refused: no path here falls back to the plain versions
(``subtract.subtract_known_plain``, ``gfsk_engine.candidate_llrs_plain``,
``gfsk_engine._multisym_llrs_plain``).  None syncs with the host, so each
can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from cwsl_digi_tpu_torch import kernel_build
from cwsl_digi_tpu_torch.constants import WAVE_SR
from cwsl_digi_tpu_torch.modes.gfsk import gaussian_frequency_pulse

# limits of gfsk.cu (checked against the library when it is loaded)
SUB_MAX_BURSTS = 64
SUB_MAX_SYM = 256
SUB_MAX_INFO = 128
SUB_MAX_PAR = 256
SUB_CHUNK = 4096          # samples of one span block; the span must exceed it
LLR_MAX_DATA = 128
LLR_MAX_SYM = 256
LLR_TONES = (4, 8)
LLR_BPS = (2, 3)

SRC = Path(__file__).parent / "csrc" / "gfsk.cu"
BUILD_DIR = Path(__file__).parent / "build"
EXTRA_FLAGS = ("--fmad=false",)

# launches of each kernel since the last reset (one per wrapper call that
# launches; a subtract_known call is one kernel launch after a memset of
# its work queue; candidate_llrs and multisym_llrs launch the one LLR kernel)
launches = {"subtract_known": 0, "multisym_llrs": 0}

_lock = threading.Lock()     # guards _lib, the counts and the table cache
_lib: ctypes.CDLL | None = None
_tables: dict = {}
build_log = ""       # nvcc's output for the library in use (ptxas -v)


def build_library() -> Path:
    """Compile the kernel library unless this source's build exists."""
    global build_log
    out, log = kernel_build.build_library(SRC, BUILD_DIR, "gfsk", EXTRA_FLAGS)
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
            lib.gfsk_sub_scratch.argtypes = [p, p, ctypes.POINTER(
                ctypes.c_longlong)]
            lib.gfsk_sub_scratch.restype = ctypes.c_longlong
            lib.gfsk_subtract_launch.argtypes = [p] * 13 + [i]
            lib.gfsk_subtract_launch.restype = i
            lib.gfsk_trig_differ.argtypes = [p, i, p, p]
            lib.gfsk_trig_differ.restype = i
            lib.gfsk_llr_launch.argtypes = [p] * 11
            lib.gfsk_llr_launch.restype = i
            limits = {"gfsk_sub_max_bursts": SUB_MAX_BURSTS,
                      "gfsk_sub_max_sym": SUB_MAX_SYM,
                      "gfsk_sub_max_info": SUB_MAX_INFO,
                      "gfsk_sub_max_par": SUB_MAX_PAR,
                      "gfsk_sub_chunk": SUB_CHUNK,
                      "gfsk_llr_max_data": LLR_MAX_DATA,
                      "gfsk_llr_max_sym": LLR_MAX_SYM}
            for name, want in limits.items():
                getattr(lib, name).restype = i
                if getattr(lib, name)() != want:
                    raise RuntimeError(f"gfsk.cu {name} disagrees")
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


def _spec_tables(spec, device: torch.device) -> dict[str, torch.Tensor]:
    """The mode's static tables on ``device``, made once (host copies to
    the card cannot be captured in a CUDA graph, so a call makes none)."""
    from cwsl_digi_tpu_torch.modes.gfsk_engine import _neighbor_allowed

    key = (spec, str(device))
    with _lock:
        tabs = _tables.get(key)
    if tabs is not None:
        return tabs
    sps = spec.sps
    pulse = gaussian_frequency_pulse(sps, spec.bt)
    template = np.zeros(spec.n_sym, np.float32)
    for s, tone in spec.sync_cells:
        template[s] = tone
    dnp = np.asarray(spec.data_syms, np.int64)
    allow = np.zeros((4, dnp.size), np.uint8)
    for row, off in enumerate((-1, 1, -2, 2)):
        ok = _neighbor_allowed(spec, dnp + off)
        allow[row] = (ok * (1 << np.arange(spec.n_tones))).sum(axis=1)
    by_sym = {int(s): int(t) for s, t in spec.sync_cells}
    pairs = [(s, by_sym[s], by_sym[s + 1]) for s in sorted(by_sym)
             if s + 1 in by_sym]
    host = {
        "pulse_pad": np.concatenate([np.zeros(sps), pulse, np.zeros(sps)]
                                    ).astype(np.float32),
        "template": template,
        "data_idx": dnp.astype(np.int32),
        "gray": np.asarray(spec.gray_map, np.int32),
        "allow": allow,
        # the consecutive sync pairs of the frequency correction, in the
        # plain version's order: (symbol, its tone, the next symbol's tone)
        "pairs": np.asarray(pairs, np.int32).reshape(-1, 3),
    }
    tabs = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    with _lock:
        _tables[key] = tabs
    return tabs


def subtract_dims(spec, n_windows: int, n_samples: int, k_info: int,
                  n_par: int, n_bursts: int) -> tuple[list[int], list[float]]:
    """The kernel's integer dims and float32 constants of one call; the
    constants are the plain version's Python scalars, which PyTorch rounds
    to float32 where they meet a float32 tensor."""
    hop, sps, n_sym = spec.hop, spec.sps, spec.n_sym
    S = (n_sym + 1) * sps
    n_blk_seg = S // hop
    nb = -(-n_samples // hop)
    nb_pad = nb + 2 * n_blk_seg
    two_pi = 2.0 * np.pi
    hmod = spec.tone_spacing / WAVE_SR
    t_sym = sps / WAVE_SR
    dims = [n_windows, n_samples, nb_pad * hop, hop, sps, n_sym, S,
            n_sym * sps, n_blk_seg, n_blk_seg, nb_pad, k_info, n_par,
            len(spec.data_syms), spec.bits_per_sym, n_bursts, spec.n_tones]
    consts = [two_pi * hmod, two_pi / WAVE_SR, spec.bin_hz,
              two_pi * t_sym, two_pi, t_sym, two_pi * spec.tone_spacing,
              float(WAVE_SR), float(sps)]
    return dims, [float(np.float32(c)) for c in consts]


def subtract_known(spec, audio: torch.Tensor, params: torch.Tensor,
                   gen_parity: torch.Tensor,
                   shifts: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the burst subtraction on PyTorch's current stream.

    audio [B, T] float32, params [B, M, k+3] int32 ([info | t0_hop | f0_bin
    | valid], valid bursts first in every window), gen_parity [k, n-k]
    float32, as ``subtract.subtract_known_plain`` takes them.  Returns the
    [B, T] float32 residual (a view of the padded work buffer, as the
    plain version's).  ``shifts`` (int32 [B, M]), if given, takes each
    fitted burst's integer time shift in samples (a check's view of the
    fit; entries of bursts not fitted are left as they are)."""
    if audio.dim() != 2 or params.dim() != 3 or gen_parity.dim() != 2:
        raise ValueError("audio [B, T], params [B, M, k+3] and gen_parity "
                         "[k, n-k] must be 2-, 3- and 2-D")
    B, T = audio.shape
    k_info, n_par = gen_parity.shape
    n_m = params.shape[1]
    n_sym, sps = spec.n_sym, spec.sps
    S = (n_sym + 1) * sps
    n_data = len(spec.data_syms)
    if n_m > SUB_MAX_BURSTS:
        raise ValueError(f"{n_m} bursts a window: the kernel takes at most "
                         f"{SUB_MAX_BURSTS}")
    if not (2 <= n_sym <= SUB_MAX_SYM and 0 < k_info <= SUB_MAX_INFO
            and n_par <= SUB_MAX_PAR and S > SUB_CHUNK
            and n_data * spec.bits_per_sym <= k_info + n_par
            and B <= 65535 and (1 << spec.bits_per_sym) <= spec.n_tones):
        raise ValueError(f"{spec.name}: n_sym={n_sym}, span {S}, k={k_info}, "
                         f"n-k={n_par}, {B} windows: the kernel takes "
                         f"n_sym <= {SUB_MAX_SYM}, a span above {SUB_CHUNK} "
                         f"samples, k <= {SUB_MAX_INFO}, n-k <= "
                         f"{SUB_MAX_PAR} and at most 65535 windows")
    operands = {"audio": (audio, torch.float32, (B, T)),
                "params": (params, torch.int32, (B, n_m, k_info + 3)),
                "gen_parity": (gen_parity, torch.float32, (k_info, n_par))}
    if shifts is not None:
        operands["shifts"] = (shifts, torch.int32, (B, n_m))
    _check(operands)
    dims, consts = subtract_dims(spec, B, T, k_info, n_par, n_m)
    margin, hop = dims[9], dims[3]
    t_pad_len = -(-T // hop) * hop
    res = torch.nn.functional.pad(audio, (margin * hop,
                                          t_pad_len - T + margin * hop))
    out = res[:, margin * hop : margin * hop + t_pad_len][:, :T]
    if B == 0 or n_m == 0:
        return out
    tabs = _spec_tables(spec, audio.device)
    lib = load_library()
    di = (ctypes.c_int * len(dims))(*dims)
    dc = (ctypes.c_float * len(consts))(*consts)
    n_int = ctypes.c_longlong(0)
    n_float = lib.gfsk_sub_scratch(ctypes.addressof(di), ctypes.addressof(dc),
                                   ctypes.byref(n_int))
    if n_float < 0:
        raise ValueError(f"{spec.name}: the kernel refuses dims {dims}")
    scratch_f = torch.empty(n_float, dtype=torch.float32, device=audio.device)
    scratch_i = torch.empty(n_int.value, dtype=torch.int32,
                            device=audio.device)
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    with torch.cuda.device(audio.device):
        err = lib.gfsk_subtract_launch(
            ctypes.addressof(di), ctypes.addressof(dc), res.data_ptr(),
            params.data_ptr(), gen_parity.data_ptr(),
            tabs["pulse_pad"].data_ptr(), tabs["template"].data_ptr(),
            tabs["data_idx"].data_ptr(), tabs["gray"].data_ptr(),
            scratch_f.data_ptr(), scratch_i.data_ptr(),
            None if shifts is None else shifts.data_ptr(), stream, 0)
    if err != 0:
        raise RuntimeError(f"subtract_known kernel launch failed: CUDA error "
                           f"{err} ({spec.name}, {B} windows, {n_m} bursts)")
    _count("subtract_known")
    return out


def trig_differ(x: torch.Tensor) -> int:
    """How many float32 ``x`` (on the card) get other bits from CUDA's
    ``sincosf`` than from ``sinf`` and ``cosf``.  The subtraction kernel
    takes one ``sincosf`` for each angle; it rounds as separate ``cosf``
    and ``sinf`` calls only if this is 0."""
    _check({"x": (x, torch.float32, (x.numel(),))})
    lib = load_library()
    n = torch.zeros(1, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gfsk_trig_differ(
            x.data_ptr(), x.numel(), n.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"trig check launch failed: CUDA error {err}")
    return int(n.item())


def _llr_spec_checks(spec, n_tones: int, bps: int) -> None:
    """The LLR kernel's limits on the mode."""
    n_data = len(spec.data_syms)
    if n_tones not in LLR_TONES or bps not in LLR_BPS \
            or (1 << bps) > n_tones:
        raise ValueError(f"{n_tones} tones, {bps} bits a symbol: the kernel "
                         f"takes T in {LLR_TONES} and bits_per_sym in "
                         f"{LLR_BPS}, with 2**bits_per_sym <= T")
    if spec.coh4 and n_tones != 4:
        raise ValueError(f"coh4 with T={n_tones}: the kernel's 4-symbol "
                         "windows take T = 4 only")
    if not 0 < n_data <= LLR_MAX_DATA:
        raise ValueError(f"{n_data} data symbols: the kernel takes 1 to "
                         f"{LLR_MAX_DATA}")
    if spec.n_sym > LLR_MAX_SYM:
        raise ValueError(f"{spec.n_sym} symbols: the kernel takes at most "
                         f"{LLR_MAX_SYM}")
    if (n_tones, bps) != (spec.n_tones, spec.bits_per_sym):
        raise ValueError(f"{n_tones} tones with {bps}-bit bitmaps does not "
                         f"fit {spec.name}")


def _llr_launch(spec, src: torch.Tensor, k: int, tt, f0, rot, bitmaps,
                os_t: int, os_f: int, fold_pairs: bool) -> torch.Tensor:
    """One launch of the LLR kernel over src [B, H, F]'s B * k candidates;
    returns [B * k, n_bits] float32."""
    b, h, f = src.shape
    n_data = len(spec.data_syms)
    out = torch.empty((b * k, n_data * spec.bits_per_sym),
                      dtype=torch.float32, device=src.device)
    if b * k == 0:
        return out
    tabs = _spec_tables(spec, src.device)
    n_pairs = tabs["pairs"].shape[0] if fold_pairs else 0
    dims = [b, k, h, f, spec.n_sym, spec.n_tones, n_data, spec.bits_per_sym,
            os_t, os_f, spec.bin_range[0], n_pairs, int(spec.coh4)]
    lib = load_library()
    di = (ctypes.c_int * len(dims))(*dims)

    def ptr(x):
        return None if x is None else x.data_ptr()

    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        err = lib.gfsk_llr_launch(
            ctypes.addressof(di), src.data_ptr(), ptr(tt), ptr(f0), ptr(rot),
            bitmaps.data_ptr(), tabs["data_idx"].data_ptr(),
            tabs["allow"].data_ptr(), tabs["pairs"].data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"LLR kernel launch failed: CUDA error {err} "
                           f"({spec.name}, {b} x {k} candidates, dims {dims})")
    _count("multisym_llrs")
    return out


def candidate_llrs(spec, demod: torch.Tensor, tt: torch.Tensor,
                   f0: torch.Tensor, os_t_eff: int, fold_pairs: bool,
                   bitmaps: torch.Tensor) -> torch.Tensor:
    """Launch the coherent LLRs of every candidate straight from the demod
    spectrogram, on PyTorch's current stream: one launch, a block a
    candidate.

    demod [B, H, F] complex64, tt and f0 [B, K] int64 (start hop and bin),
    os_t_eff the hops between symbols, fold_pairs whether the sync-pair
    residual is folded into the rotation, bitmaps [bps, T] float32, as
    ``gfsk_engine.candidate_llrs_plain`` takes them.  Returns [B, K,
    n_bits] float32, each candidate scaled to std 3."""
    if demod.dim() != 3 or tt.dim() != 2 or bitmaps.dim() != 2:
        raise ValueError("demod [B, H, F], tt and f0 [B, K] and bitmaps "
                         "[bps, T] must be 3-, 2- and 2-D")
    b, h, f = demod.shape
    k = tt.shape[1]
    _llr_spec_checks(spec, bitmaps.shape[1], bitmaps.shape[0])
    if os_t_eff < 1 or -(-h // os_t_eff) < spec.n_sym \
            or -(-f // spec.os_f) < spec.n_tones:
        raise ValueError(f"demod [{b}, {h}, {f}] at {os_t_eff} hops and "
                         f"{spec.os_f} bins a step holds no {spec.n_sym} x "
                         f"{spec.n_tones} block: the kernel needs every "
                         "clamped block inside the padded spectrogram")
    if b * k >= 2 ** 31:
        raise ValueError(f"{b} x {k} candidates: the kernel takes fewer "
                         "than 2**31")
    _check({"demod": (demod, torch.complex64, (b, h, f)),
            "tt": (tt, torch.int64, (b, k)),
            "f0": (f0, torch.int64, (b, k)),
            "bitmaps": (bitmaps, torch.float32, tuple(bitmaps.shape))})
    return _llr_launch(spec, demod, k, tt, f0, None, bitmaps, os_t_eff,
                       spec.os_f, fold_pairs).reshape(b, k, -1)


def multisym_llrs(spec, csym: torch.Tensor, rot: torch.Tensor,
                  bitmaps: torch.Tensor) -> torch.Tensor:
    """Launch the coherent LLRs of gathered symbol spectra on PyTorch's
    current stream: the kernel of :func:`candidate_llrs` on csym read as a
    spectrogram of M windows with unit strides, one candidate each at hop
    and bin 0, with the rotation given.

    csym [M, n_sym, T] complex64, rot [M] complex64, bitmaps [bps, T]
    float32, as ``gfsk_engine._multisym_llrs_plain`` takes them.  Returns
    [M, n_bits] float32, each candidate scaled to std 3."""
    if csym.dim() != 3 or rot.dim() != 1 or bitmaps.dim() != 2:
        raise ValueError("csym [M, n_sym, T], rot [M] and bitmaps [bps, T] "
                         "must be 3-, 1- and 2-D")
    m, n_sym, n_tones = csym.shape
    _llr_spec_checks(spec, n_tones, bitmaps.shape[0])
    if n_sym != spec.n_sym:
        raise ValueError(f"csym [{m}, {n_sym}, {n_tones}] does not fit "
                         f"{spec.name}")
    _check({"csym": (csym, torch.complex64, (m, n_sym, n_tones)),
            "rot": (rot, torch.complex64, (m,)),
            "bitmaps": (bitmaps, torch.float32, tuple(bitmaps.shape))})
    return _llr_launch(spec, csym, 1, None, None, rot, bitmaps, 1, 1, False)
