"""Batched decoder engine for the GFSK sync-array modes (PyTorch).

Counterpart of ``cwsl_digi_tpu/modes/gfsk_engine.py``: every branch of
:func:`decode_program` (the split DFT-matmul ``refine`` branch of FT8, FT4
and JS8; the fused DFT-matmul and the rfft spectrograms of FST4/FST4W with
the sync-pair frequency correction), coherent 1/2/3- and 4-symbol LLRs,
a-priori hypotheses, BP + CRC, OSD and the SNR estimate; then the
multi-pass host wrapper :class:`GFSKDecoder` with on-device subtraction
between passes.

Stages per batch of windows:

  1. Hann sync spectrogram and complex boxcar demod spectrogram: bf16-input
     DFT matmuls (the boxcar at half the hop on the refine branch), or two
     rffts where the DFT matrix would be too large;
  2. sync correlation: one shifted-slice add per known sync cell;
  3. hybrid top-K over (start hop, base bin): half after NMS, half raw;
  4. sub-grid refinement (refine branch) -- stages 2-4a are
     :func:`sync_candidates`, three hand kernels on the card --, strided
     block gather, sync-pair frequency correction, coherent LLRs;
  5. AP hypotheses, min-sum LDPC, CRC and validity gates; OSD fallback.

Where JAX and PyTorch differ, the port follows JAX: ``jnp.median``
averages the two middle values, ``jnp.std`` is the population std,
``jnp.argsort``/``lax.top_k`` keep index order on ties, int32 sums wrap,
``dynamic_slice`` clamps its start, and a bf16-input einsum accumulates and
returns float32.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import WAVE_SR
from cwsl_digi_tpu_torch.convert import tables_to_torch
from cwsl_digi_tpu_torch.device import as_device
from cwsl_digi_tpu_torch.modes import (_gfsk_kernels, _median_kernels,
                                       _sync_kernels)
from cwsl_digi_tpu_torch.modes.base import (DecodeResult, on_device_lock,
                                            window_batch)
from cwsl_digi_tpu_torch.modes.ldpc import BPDecoder
from cwsl_digi_tpu_torch.modes.osd import (flip_patterns, osd_decode,
                                          pattern_index_lists)
from cwsl_digi_tpu_torch.modes.subtract import subtract_known

# device-memory budget per decode_program call; the same budget, and hence
# the same windows-per-call split, as the reference
DEVICE_BYTES_BUDGET = 4_000_000_000

# bound on the largest per-chunk cross tensor in _multisym_llrs_plain
# (bytes): eager PyTorch materializes every intermediate of a chunk
LLR_CHUNK_BYTES = 64_000_000


def device_batch_for(n_hops: int, nfft: int, cap: int,
                     cand_bytes: int = 0) -> int:
    """Windows per device call so the spectrogram working set fits."""
    per_window = n_hops * (nfft // 2 + 1) * (4 + 8 + 8) + cand_bytes
    return max(1, min(cap, DEVICE_BYTES_BUDGET // max(per_window, 1)))


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """Static physical-layer description of one GFSK mode."""

    name: str
    n_sym: int                    # total symbols
    sps: int                      # samples per symbol @ 12 kHz
    n_tones: int
    bits_per_sym: int
    sync_cells: tuple[tuple[int, int], ...]   # (symbol index, tone)
    data_syms: tuple[int, ...]    # symbol indices carrying codeword bits
    gray_map: tuple[int, ...]     # bits value -> tone
    trperiod: float
    signal_start_s: float = 0.5
    fmin_hz: float = 200.0
    fmax_hz: float = 3000.0
    top_k: int = 128
    bp_iters: int = 30
    max_hops: int = 128           # candidate start-time grid
    pad_hops: int = 64
    os_t: int = 4                 # time oversampling (hops per symbol)
    os_f: int = 2                 # freq oversampling (bins per tone step)
    nms: bool = False
    depth: int = 2                # decode passes with signal subtraction
    bt: float = 2.0               # GFSK Gaussian BT (for reconstruction)
    osd_j: int = 16               # OSD candidates per window; 0 disables
    osd_singles: int = 91
    osd_tail2: int = 16
    osd_tail3: int = 8
    osd_nhard_max: int = 42
    osd_dist_frac: float = 0.12
    osd_post: bool = True         # order bits by BP posteriors
    snr_offset_db: float = 0.0
    refine: bool = False          # sub-grid candidate refinement
    refine_freq: bool = False
    coh4: bool = False

    @property
    def hop(self) -> int:
        return self.sps // self.os_t

    @property
    def nfft(self) -> int:
        return self.os_f * self.sps

    @property
    def bin_hz(self) -> float:
        return WAVE_SR / self.nfft

    @property
    def baud(self) -> float:
        return WAVE_SR / self.sps

    @property
    def tone_spacing(self) -> float:
        return self.baud

    @property
    def n_bits(self) -> int:
        return len(self.data_syms) * self.bits_per_sym

    def inverse_gray(self) -> np.ndarray:
        return np.argsort(np.asarray(self.gray_map)).astype(np.int32)

    def tones_from_codeword(self, codeword: np.ndarray) -> np.ndarray:
        """codeword bits -> full symbol/tone sequence (encoder side)."""
        codeword = np.asarray(codeword, np.uint8)
        if codeword.shape != (self.n_bits,):
            raise ValueError(f"codeword must have {self.n_bits} bits")
        vals = codeword.reshape(len(self.data_syms), self.bits_per_sym)
        v = np.zeros(len(self.data_syms), np.int64)
        for b in range(self.bits_per_sym):
            v = v * 2 + vals[:, b]
        gray = np.asarray(self.gray_map)
        tones = np.zeros(self.n_sym, np.int32)
        for s, tone in self.sync_cells:
            tones[s] = tone
        tones[np.asarray(self.data_syms)] = gray[v]
        return tones

    def bitmaps(self) -> np.ndarray:
        """[bits_per_sym, n_tones]: bit j of each tone's Gray value."""
        ig = self.inverse_gray()
        out = np.zeros((self.bits_per_sym, self.n_tones), np.float32)
        for tone in range(self.n_tones):
            v = int(ig[tone])
            for j in range(self.bits_per_sym):
                out[j, tone] = (v >> (self.bits_per_sym - 1 - j)) & 1
        return out

    @property
    def bin_range(self) -> tuple[int, int, int]:
        """(fmin_bin, fmax_bin, n_bins) of the searched/kept spectrum; the
        upper edge is inclusive (+1), as the reference's nfa..nfb."""
        fmin_bin = int(self.fmin_hz / self.bin_hz)
        fmax_bin = int(np.ceil(self.fmax_hz / self.bin_hz)) + 1
        return fmin_bin, fmax_bin, fmax_bin - fmin_bin + self.os_f * self.n_tones


def _neighbor_allowed(spec: ModeSpec, idx: np.ndarray) -> np.ndarray:
    """[n_data, n_tones] True where a neighbor symbol may hold the tone:
    only the known tone for a sync neighbor, any tone for data or edges."""
    known = np.full(spec.n_sym, -1, np.int64)
    for s, t in spec.sync_cells:
        known[s] = t
    out = np.ones((len(idx), spec.n_tones), bool)
    for di, s in enumerate(idx):
        if 0 <= s < spec.n_sym and known[s] >= 0:
            out[di] = False
            out[di, known[s]] = True
    return out


def _multisym_llrs(spec: ModeSpec, csym: torch.Tensor, rot: torch.Tensor,
                   bitmaps: torch.Tensor) -> torch.Tensor:
    """Coherent 1/2/3-symbol (and, with ``spec.coh4``, 4-symbol) max-log
    LLRs, [M, n_bits] normalized per candidate to std 3.

    A CPU tensor runs :func:`_multisym_llrs_plain`; any other launches the
    ``multisym_llrs`` kernel (``csrc/gfsk.cu``, one launch over all M
    candidates), which raises if it cannot (no fallback).
    """
    if csym.device.type == "cpu":
        return _multisym_llrs_plain(spec, csym, rot, bitmaps)
    return _gfsk_kernels.multisym_llrs(spec, csym.contiguous(),
                                       rot.contiguous(), bitmaps.contiguous())


def _multisym_llrs_plain(spec: ModeSpec, csym: torch.Tensor,
                         rot: torch.Tensor, bitmaps: torch.Tensor
                         ) -> torch.Tensor:
    """The plain PyTorch version of :func:`_multisym_llrs` (on any device):
    the kernel's oracle.

    csym [M, n_sym, n_tones] complex64 symbol DFT values, rot [M] complex64
    inter-symbol reference rotation, bitmaps [bits_per_sym, n_tones].
    Returns [M, n_bits] LLRs, normalized per candidate to std 3.  Per data
    symbol: E1 = |C_s|^2, E2p/E2n = best coherent pair with the previous/
    next symbol, E3 = best coherent triple, and with coh4 the best coherent
    4-symbol windows [s-1..s+2] and [s-2..s+1]; neighbors restricted to the
    known tone at sync cells.  |a+b|^2 is expanded so only [T, T(, T(, T))]
    cross tensors exist, in candidate chunks of bounded size.
    """
    m_all, n_sym, n_tones = csym.shape
    dev = csym.device
    data = torch.as_tensor(np.asarray(spec.data_syms, np.int64), device=dev)
    n_data = data.shape[0]
    big = 1e30
    dnp = np.asarray(spec.data_syms, np.int64)
    allow_prev = torch.as_tensor(_neighbor_allowed(spec, dnp - 1), device=dev)
    allow_next = torch.as_tensor(_neighbor_allowed(spec, dnp + 1), device=dev)
    allow_prev2 = torch.as_tensor(_neighbor_allowed(spec, dnp - 2), device=dev)
    allow_next2 = torch.as_tensor(_neighbor_allowed(spec, dnp + 2), device=dev)
    bit0 = bitmaps < 0.5                                     # [nb, T]
    tri_bytes = n_data * n_tones ** (4 if spec.coh4 else 3) * 4
    chunk = int(max(1, min(m_all, LLR_CHUNK_BYTES // max(tri_bytes, 1))))

    def bit_llrs(f):                       # [m, D, T] -> [m, D, nb]
        f_ = f[:, :, None, :]
        b0 = torch.where(bit0, f_, -big).amax(dim=-1)
        b1 = torch.where(~bit0, f_, -big).amax(dim=-1)
        return b0 - b1

    def cross(a, b_, rr):                  # 2 Re(conj(a)[.., i, None] rr b[.., None, j])
        return 2.0 * (a.conj()[:, :, :, None] * (rr * b_[:, :, None, :])).real

    out = []
    for lo in range(0, m_all, chunk):
        c = csym[lo : lo + chunk]
        r_ = rot[lo : lo + chunk][:, None, None, None]
        cpad = torch.nn.functional.pad(c, (0, 0, 1, 1))
        cs = c[:, data]
        cprev = cpad[:, data]
        cnext = cpad[:, data + 2]
        e1s = cs.abs() ** 2
        e1p = cprev.abs() ** 2
        e1n = cnext.abs() ** 2
        x_ps = cross(cprev, cs, r_)
        x_sn = cross(cs, cnext, r_)
        x_pn = cross(cprev, cnext, r_ * r_)
        gp = torch.where(allow_prev[None, :, :, None],
                         e1p[:, :, :, None] + x_ps, -big)
        e2p = e1s + gp.amax(dim=2)
        gn = torch.where(allow_next[None, :, None, :],
                         e1n[:, :, None, :] + x_sn, -big)
        e2n = e1s + gn.amax(dim=3)
        tri = (e1p[:, :, :, None, None] + e1s[:, :, None, :, None]
               + e1n[:, :, None, None, :]
               + x_ps[:, :, :, :, None] + x_sn[:, :, None, :, :]
               + x_pn[:, :, :, None, :])
        tri = torch.where(allow_prev[None, :, :, None, None], tri, -big)
        tri = torch.where(allow_next[None, :, None, None, :], tri, -big)
        e3 = tri.amax(dim=(2, 4))
        l = bit_llrs(e1s) + bit_llrs(e2p) + bit_llrs(e2n) + bit_llrs(e3)
        if spec.coh4:
            cpad2 = torch.nn.functional.pad(c, (0, 0, 2, 2))
            cprev2 = cpad2[:, data]                         # real index s-2
            cnext2 = cpad2[:, data + 4]                     # real index s+2
            e1p2 = cprev2.abs() ** 2
            e1n2 = cnext2.abs() ** 2
            r2_ = r_ * r_
            r3_ = r2_ * r_
            x_p_nn = cross(cprev, cnext2, r3_)              # (s-1, s+2)
            x_s_nn = cross(cs, cnext2, r2_)                 # (s,   s+2)
            x_n_nn = cross(cnext, cnext2, r_)               # (s+1, s+2)
            x_pp_p = cross(cprev2, cprev, r_)               # (s-2, s-1)
            x_pp_s = cross(cprev2, cs, r2_)                 # (s-2, s)
            x_pp_n = cross(cprev2, cnext, r3_)              # (s-2, s+1)
            # window [s-1, s, s+1, s+2]: axes (p, self, n, q)
            w4n = (e1p[:, :, :, None, None, None]
                   + e1s[:, :, None, :, None, None]
                   + e1n[:, :, None, None, :, None]
                   + e1n2[:, :, None, None, None, :]
                   + x_ps[:, :, :, :, None, None]
                   + x_pn[:, :, :, None, :, None]
                   + x_p_nn[:, :, :, None, None, :]
                   + x_sn[:, :, None, :, :, None]
                   + x_s_nn[:, :, None, :, None, :]
                   + x_n_nn[:, :, None, None, :, :])
            w4n = torch.where(allow_prev[None, :, :, None, None, None],
                              w4n, -big)
            w4n = torch.where(allow_next[None, :, None, None, :, None],
                              w4n, -big)
            w4n = torch.where(allow_next2[None, :, None, None, None, :],
                              w4n, -big)
            e4n = w4n.amax(dim=(2, 4, 5))
            del w4n
            # window [s-2, s-1, s, s+1]: axes (q2, p, self, n)
            w4p = (e1p2[:, :, :, None, None, None]
                   + e1p[:, :, None, :, None, None]
                   + e1s[:, :, None, None, :, None]
                   + e1n[:, :, None, None, None, :]
                   + x_pp_p[:, :, :, :, None, None]
                   + x_pp_s[:, :, :, None, :, None]
                   + x_pp_n[:, :, :, None, None, :]
                   + x_ps[:, :, None, :, :, None]
                   + x_pn[:, :, None, :, None, :]
                   + x_sn[:, :, None, None, :, :])
            w4p = torch.where(allow_prev2[None, :, :, None, None, None],
                              w4p, -big)
            w4p = torch.where(allow_prev[None, :, None, :, None, None],
                              w4p, -big)
            w4p = torch.where(allow_next[None, :, None, None, None, :],
                              w4p, -big)
            e4p = w4p.amax(dim=(2, 3, 5))
            del w4p
            l = l + bit_llrs(e4n) + bit_llrs(e4p)
        out.append(l.reshape(l.shape[0], -1))
    llr = torch.cat(out) if len(out) > 1 else out[0]
    # prescale by the peak before the variance (float32 overflow guard)
    peak = llr.abs().amax(dim=-1, keepdim=True)
    llr = llr / (peak + 1e-20)
    std = llr.std(dim=-1, correction=0, keepdim=True)
    return llr / (std + 1e-20) * 3.0


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of bf16-cast inputs with float32 accumulation and output
    (the reference's ``preferred_element_type=float32``): products of bf16
    values are exact in float32, so upcast and multiply in full float32."""
    return torch.matmul(a.to(torch.bfloat16).to(torch.float32),
                        b.to(torch.bfloat16).to(torch.float32))


def _shifted_sum(plane: torch.Tensor, cells, rows: int, cols: int,
                 t_mul: int, f_mul: int) -> torch.Tensor:
    """sum over sync cells of plane[:, t_mul*sym : +rows, f_mul*tone : +cols]
    in float32."""
    acc = None
    for sym, tone in cells:
        h0, b0 = t_mul * sym, f_mul * tone
        s = plane[:, h0 : h0 + rows, b0 : b0 + cols].to(torch.float32)
        acc = s if acc is None else acc + s
    return acc


def _median_rows(x: torch.Tensor) -> torch.Tensor:
    """Median over all but the first axis, averaging the two middle values
    for an even count (``jnp.median``).  On a CUDA tensor one call of the
    ``median_rows`` kernel (``_median_kernels``; it raises where the kernel
    cannot run): a strided 3-D view (FT8's ``[:, ::4, ::4]``) as it lies
    where its rows fit the on-chip plans, anything else as contiguous rows
    (a copy where they are not).  On a CPU tensor
    :func:`_median_rows_plain`."""
    if x.device.type == "cpu":
        return _median_rows_plain(x)
    if (x.dim() == 3 and not x.is_contiguous()
            and x.shape[1] * x.shape[2] <= _median_kernels.ONCHIP_MAX):
        return _median_kernels.median_rows(x)
    return _median_kernels.median_rows(
        x.reshape(x.shape[0], -1).contiguous())


def _median_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """:func:`_median_rows` by a full sort of each row: -0.0 read as 0.0
    (as ``jnp.median``'s sort keys), and NaN for a row that holds a NaN
    (``jnp.median`` without ``nanmedian``'s squashing)."""
    flat = x.reshape(x.shape[0], -1) + 0.0
    n = flat.shape[1]
    srt = flat.sort(dim=1).values
    if n % 2:
        med = srt[:, n // 2]
    else:
        med = 0.5 * (srt[:, n // 2 - 1] + srt[:, n // 2])
    return torch.where(flat.isnan().any(dim=1), torch.nan, med)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: descending, lower index first on
    ties (a stable sort, so the pick does not depend on the backend)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def spectrograms(spec: ModeSpec, audio: torch.Tensor, tabs: dict
                 ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """Stage 1 of :func:`decode_program`: the bf16 Hann sync power map
    [B, ph + hops + ph, n_bins] and the complex boxcar demod spectrogram,
    and whether the refine branch made them.

    - refine branch (``spec.refine`` with a DFT matrix): Hann columns at the
      hop, boxcar columns at half the hop ([B, 2ph + 2hops-1 + 2ph,
      n_bins]), both bf16-input matmuls over the kept bins;
    - fused branch (a DFT matrix, no refine): boxcar re/im and Hann re/im in
      one bf16-input matmul, both at the hop;
    - rfft branch (no DFT matrix: it would exceed ``DFT_MAT_BYTES_MAX``):
      ``rfft(frames * w, n=nfft)`` for each window, then the bin slice.
    """
    b, n_samples = audio.shape
    sps, hop = spec.sps, spec.hop
    n_hops = (n_samples - sps) // hop + 1
    fmin_bin, _, n_bins = spec.bin_range
    ph = spec.pad_hops
    dft_mat = tabs.get("dft_mat")
    frames = audio.unfold(1, sps, hop)                         # [B, hops, sps]

    def pad_hops(x, p):
        return torch.nn.functional.pad(x, (0, 0, p, p))

    if dft_mat is None:
        def spectrum(w):
            x = torch.fft.rfft(frames * w, n=spec.nfft, dim=-1)
            return pad_hops(x[:, :, fmin_bin : fmin_bin + n_bins], ph)

        power_sync = (spectrum(tabs["window"]).abs() ** 2).to(torch.bfloat16)
        return power_sync, spectrum(torch.ones_like(tabs["window"])), False
    if not spec.refine:
        four = _bf16_matmul(frames.reshape(b * n_hops, sps), dft_mat)
        four = four.reshape(b, n_hops, 4, n_bins)
        power_sync = pad_hops(four[:, :, 2] ** 2 + four[:, :, 3] ** 2,
                              ph).to(torch.bfloat16)
        return (power_sync,
                pad_hops(torch.complex(four[:, :, 0], four[:, :, 1]), ph),
                False)
    n_bins_k = dft_mat.shape[1] // 4
    four = _bf16_matmul(frames.reshape(b * n_hops, sps),
                        dft_mat[:, 2 * n_bins_k:])
    four = four.reshape(b, n_hops, 2, n_bins_k)
    power_sync = pad_hops(four[:, :, 0] ** 2 + four[:, :, 1] ** 2,
                          ph).to(torch.bfloat16)
    del four
    n_hops_f = 2 * n_hops - 1
    fd = _bf16_matmul(audio.unfold(1, sps, hop // 2)[:, :n_hops_f]
                      .reshape(b * n_hops_f, sps), dft_mat[:, : 2 * n_bins_k])
    fd = fd.reshape(b, n_hops_f, 2, n_bins_k)
    return (power_sync,
            pad_hops(torch.complex(fd[:, :, 0], fd[:, :, 1]), 2 * ph), True)


def sync_pair_rotation(spec: ModeSpec, csym: torch.Tensor,
                       rot: torch.Tensor) -> torch.Tensor:
    """Fold the sub-bin frequency residual into the combiner's rotation
    ``rot`` [B, K]: the arg of the summed products of consecutive sync-cell
    pairs (known tones) of csym [B, K, n_sym, n_tones]."""
    by_sym = {int(s): int(t) for s, t in spec.sync_cells}
    pairs = [(s, by_sym[s + 1], by_sym[s]) for s in sorted(by_sym)
             if s + 1 in by_sym]
    if not pairs:
        return rot
    dev = csym.device
    p_sym = torch.as_tensor([x[0] for x in pairs], device=dev)
    p_tn = torch.as_tensor([x[2] for x in pairs], device=dev)
    p_tn1 = torch.as_tensor([x[1] for x in pairs], device=dev)
    cs = csym[:, :, p_sym, p_tn]
    cn = csym[:, :, p_sym + 1, p_tn1]
    z = (cs.conj() * cn).sum(dim=-1) * rot
    return rot * torch.exp(-1j * z.angle())


def gather_candidates(spec: ModeSpec, demod: torch.Tensor, tt: torch.Tensor,
                      f0: torch.Tensor, os_t_eff: int) -> torch.Tensor:
    """Stage 4b's strided block gather (``dynamic_slice`` semantics): each
    candidate's [n_sym, n_tones] symbol spectra from demod [B, H, F] at
    start hop tt and bin f0 [B, K], symbols os_t_eff hops and tones os_f
    bins apart, the block start clamped into the spectrogram zero-padded to
    whole strides.  Returns csym [B, K, n_sym, n_tones]."""
    b = demod.shape[0]
    dev = demod.device
    n_hops_src = demod.shape[1]
    hq = -(-n_hops_src // os_t_eff)
    fq = -(-demod.shape[2] // spec.os_f)
    src = torch.nn.functional.pad(
        demod, (0, fq * spec.os_f - demod.shape[2],
                0, hq * os_t_eff - n_hops_src))
    q = (tt // os_t_eff).clamp(0, hq - spec.n_sym)
    p = (f0 // spec.os_f).clamp(0, fq - spec.n_tones)
    hop_idx = (q * os_t_eff + tt % os_t_eff)[:, :, None, None] \
        + os_t_eff * torch.arange(spec.n_sym, device=dev)[:, None]
    bin_idx = (p * spec.os_f + f0 % spec.os_f)[:, :, None, None] \
        + spec.os_f * torch.arange(spec.n_tones, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    return src[bidx, hop_idx, bin_idx]                    # [B, K, S, T]


def candidate_rotation(spec: ModeSpec, csym: torch.Tensor, f0: torch.Tensor,
                       fold_pairs: bool) -> torch.Tensor:
    """The combiner's reference rotation [B, K] of candidates at bin f0:
    exp(-2j pi abs_bin / os_f), with the sync-pair residual folded in when
    ``fold_pairs``."""
    fmin_bin = spec.bin_range[0]
    abs_bin = (f0 + fmin_bin).to(torch.float32)
    rot = torch.exp(-2j * np.pi * abs_bin / spec.os_f)
    if fold_pairs:
        rot = sync_pair_rotation(spec, csym, rot)
    return rot


def candidate_llrs(spec: ModeSpec, demod: torch.Tensor, tt: torch.Tensor,
                   f0: torch.Tensor, os_t_eff: int, fold_pairs: bool,
                   bitmaps: torch.Tensor) -> torch.Tensor:
    """Stage 4b: every candidate's coherent LLRs, [B, K, n_bits] scaled per
    candidate to std 3, from the demod spectrogram [B, H, F] and the
    candidates' start hop tt and bin f0 [B, K].

    A CPU tensor runs :func:`candidate_llrs_plain`; any other launches the
    ``multisym_llrs`` kernel's spectrogram entry (``csrc/gfsk.cu``: one
    launch that gathers each candidate's block, forms its rotation and its
    LLRs), which raises if it cannot (no fallback).
    """
    if demod.device.type == "cpu":
        return candidate_llrs_plain(spec, demod, tt, f0, os_t_eff,
                                    fold_pairs, bitmaps)
    return _gfsk_kernels.candidate_llrs(
        spec, demod.contiguous(), tt.contiguous(), f0.contiguous(), os_t_eff,
        fold_pairs, bitmaps.contiguous())


def candidate_llrs_plain(spec: ModeSpec, demod: torch.Tensor,
                         tt: torch.Tensor, f0: torch.Tensor, os_t_eff: int,
                         fold_pairs: bool, bitmaps: torch.Tensor
                         ) -> torch.Tensor:
    """The plain PyTorch version of :func:`candidate_llrs` (on any device):
    the kernel's oracle.  The block gather, the rotation and the LLRs of
    :func:`_multisym_llrs_plain`."""
    b, k = tt.shape
    csym = gather_candidates(spec, demod, tt, f0, os_t_eff)
    rot = candidate_rotation(spec, csym, f0, fold_pairs)
    llr = _multisym_llrs_plain(
        spec, csym.reshape(b * k, spec.n_sym, spec.n_tones), rot.reshape(-1),
        bitmaps)
    return llr.reshape(b, k, spec.n_bits)


def sync_candidates(spec: ModeSpec, power_sync: torch.Tensor,
                    demod: torch.Tensor, base: torch.Tensor, n_hops: int,
                    refine: bool) -> tuple:
    """Stages 2, 3 and 4a of :func:`decode_program`: the sync score over
    (start hop, base bin), the hybrid top-K (half after NMS, half raw) and,
    where ``refine``, the decision-directed half-hop refinement.

    power_sync [B, ph + n_hops + ph, F] bf16, demod the complex boxcar
    spectrogram (read only where ``refine``), base [B, 1, 1] float32 (the
    real rows' mean times the sync cells).  Returns (top_val [B, K], t0,
    f0, tt [B, K] int64, os_t_eff).

    A CPU tensor runs :func:`sync_candidates_plain`; any other launches the
    ``sync_score``, ``sync_select`` and ``sync_refine`` kernels
    (``csrc/sync.cu``), which raise if they cannot (no fallback) and never
    sync with the host.
    """
    if power_sync.device.type == "cpu":
        return sync_candidates_plain(spec, power_sync, demod, base, n_hops,
                                     refine)
    return _sync_kernels.sync_candidates(
        spec, power_sync.contiguous(),
        demod.contiguous() if refine else demod, base.contiguous(), n_hops,
        refine)


def sync_score_plain(spec: ModeSpec, power_sync: torch.Tensor,
                     base: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 and the NMS of stage 3: the sync score [B, n_t0, n_f0] (one
    shifted-slice add per sync cell, over ``base + 1e-30``) and the score
    where it is the maximum of its (os_t+1) x (os_f+1) neighbourhood, else
    0."""
    n_t0, n_f0 = _sync_kernels.grid(spec)
    acc = _shifted_sum(power_sync, spec.sync_cells, n_t0, n_f0,
                       spec.os_t, spec.os_f)
    score = acc / (base + 1e-30)
    neigh = torch.nn.functional.max_pool2d(
        score[:, None], kernel_size=(spec.os_t + 1, spec.os_f + 1), stride=1,
        padding=(spec.os_t // 2, spec.os_f // 2))[:, 0]
    return score, torch.where(score >= neigh, score, 0.0)


def sync_select_plain(spec: ModeSpec, score: torch.Tensor, nms: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 3's hybrid top-K: ``top_k // 2`` of the NMS map, the rest of
    the raw score, per window: (top_val, top_idx) [B, top_k], flat indices
    into [n_t0 * n_f0]."""
    b = score.shape[0]
    k_nms = spec.top_k // 2
    v1, i1 = _top_k(nms.reshape(b, -1), k_nms)
    v2, i2 = _top_k(score.reshape(b, -1), spec.top_k - k_nms)
    return torch.cat([v1, v2], dim=1), torch.cat([i1, i2], dim=1)


def sync_refine_plain(spec: ModeSpec, demod: torch.Tensor, t0: torch.Tensor,
                      f0: torch.Tensor) -> torch.Tensor:
    """Stage 4a: each candidate's start on the half-hop grid, tt = 2 t0 +
    the offset in -1..1 whose sync cells hold the most boxcar energy
    bf16(|demod|^2) (rows outside the spectrogram read as 0), clamped into
    the spectrogram."""
    b = demod.shape[0]
    dev = demod.device
    n_t0, n_f0 = _sync_kernels.grid(spec)
    powf = torch.nn.functional.pad(
        (demod.abs() ** 2).to(torch.bfloat16), (0, 0, 1, 1))
    n_tf = 2 * n_t0 + 1
    accf = _shifted_sum(powf, spec.sync_cells, n_tf, n_f0,
                        2 * spec.os_t, spec.os_f).reshape(b, n_tf * n_f0)
    del powf
    idx3 = ((2 * t0[:, :, None] + torch.arange(3, device=dev)) * n_f0
            + f0[:, :, None])
    e3 = torch.gather(accf, 1, idx3.reshape(b, -1)).reshape(
        b, spec.top_k, 3)
    delta = e3.argmax(dim=-1) - 1
    return (2 * t0 + delta).clamp(0, demod.shape[1] - 1)


def sync_candidates_plain(spec: ModeSpec, power_sync: torch.Tensor,
                          demod: torch.Tensor, base: torch.Tensor,
                          n_hops: int, refine: bool) -> tuple:
    """The plain PyTorch version of :func:`sync_candidates` (on any
    device): the kernels' oracle.  ``n_hops`` is unused here (the wrapper
    checks the spectrogram's rows against it)."""
    score, nms = sync_score_plain(spec, power_sync, base)
    top_val, top_idx = sync_select_plain(spec, score, nms)
    n_f0 = score.shape[2]
    t0 = top_idx // n_f0
    f0 = top_idx % n_f0
    if refine:
        return (top_val, t0, f0, sync_refine_plain(spec, demod, t0, f0),
                2 * spec.os_t)
    return top_val, t0, f0, t0, spec.os_t


def decode_program(spec: ModeSpec, audio: torch.Tensor, tabs: dict,
                   bp: BPDecoder) -> dict[str, torch.Tensor]:
    """One decode pass over a batch of windows ([B, N] float32 audio).

    ``tabs`` holds the decoder's device tables (see GFSKDecoder): crc_mat
    [n_payload, n_crc], bitmaps, window, dft_mat [sps, 4*n_bins] (absent
    where the rfft branch runs), optional ap_mask/ap_vals [H, n_code].
    Returns per-candidate valid/payload/t0_hop/f0_bin/score/snr, as the
    reference.
    """
    b, n_samples = audio.shape
    dev = audio.device
    n_hops = (n_samples - spec.sps) // spec.hop + 1
    fmin_bin = spec.bin_range[0]
    ph = spec.pad_hops

    # --- 1. spectrograms ----------------------------------------------------
    power_sync, demod, refine = spectrograms(spec, audio, tabs)

    # --- 2-4a. sync correlation, hybrid top-K, half-hop refinement ---------
    real_rows = power_sync[:, ph : ph + n_hops].to(torch.float32)
    base = real_rows.mean(dim=(1, 2), keepdim=True) * len(spec.sync_cells)
    top_val, t0, f0, tt, os_t_eff = sync_candidates(
        spec, power_sync, demod, base, n_hops, refine)

    # --- 4b. strided block gather, rotation and coherent LLRs -------------
    llr = candidate_llrs(spec, demod, tt, f0, os_t_eff,
                         refine or spec.refine_freq, tabs["bitmaps"])
    del demod

    # --- 4c. a-priori hypotheses -------------------------------------------
    k_eff = spec.top_k
    ap_mask = tabs.get("ap_mask")
    if ap_mask is not None:
        ap_vals = tabs["ap_vals"]
        h = ap_mask.shape[0]
        llr = (llr[:, :, None, :] * (1.0 - ap_mask[None, None])
               + 50.0 * (1.0 - 2.0 * ap_vals[None, None]) * ap_mask[None, None])
        llr = llr.reshape(b, spec.top_k * h, spec.n_bits)
        k_eff = spec.top_k * h
        t0 = t0.repeat_interleave(h, dim=1)
        f0 = f0.repeat_interleave(h, dim=1)
        top_val = top_val.repeat_interleave(h, dim=1)

    # --- 5. LDPC + CRC ------------------------------------------------------
    n_code = bp.code.n
    hard, parity_ok, post_llr = bp.decode_full(llr.reshape(b * k_eff, n_code))
    hard = hard.reshape(b, k_eff, n_code)
    parity_ok = parity_ok.reshape(b, k_eff)
    post_llr = post_llr.reshape(b, k_eff, n_code)
    crc_mat = tabs["crc_mat"]
    n_payload, n_crc = crc_mat.shape

    def crc_ok_of(cw):
        pay = cw[:, :, :n_payload].to(torch.float32)
        calc = torch.remainder(pay @ crc_mat, 2.0)
        ok = ((calc - cw[:, :, n_payload : n_payload + n_crc]).abs()
              < 0.5).all(dim=-1)
        return ok, pay

    crc_ok, payload = crc_ok_of(hard)
    has_signal = llr.abs().sum(dim=-1) > 1e-3
    valid = parity_ok & crc_ok & has_signal & (payload > 0.5).any(dim=-1)

    # --- 5b. OSD fallback on the strongest BP failures ----------------------
    if spec.osd_j > 0:
        j = min(spec.osd_j, k_eff)
        prio = torch.where(valid, -torch.inf, top_val)
        _, sel = _top_k(prio, j)
        bj = torch.arange(b, device=dev)[:, None]
        sel_post = post_llr[bj, sel]
        sel_chan = llr[bj, sel]
        osd_in = sel_post if spec.osd_post else sel_chan
        osd_cw, osd_dist, osd_nhard = osd_decode(
            tabs["gen"], osd_in.reshape(b * j, n_code), tabs["patterns"],
            tabs["pattern_idx"])
        osd_cw = osd_cw.reshape(b, j, n_code)
        osd_dist = osd_dist.reshape(b, j)
        osd_nhard = osd_nhard.reshape(b, j)
        osd_crc_ok, osd_payload = crc_ok_of(osd_cw)
        wsum = sel_chan.abs().sum(dim=-1)
        osd_ok = (osd_crc_ok
                  & (osd_nhard <= spec.osd_nhard_max)
                  & (osd_dist <= spec.osd_dist_frac * wsum)
                  & (osd_payload > 0.5).any(dim=-1)
                  & (wsum > 1e-3))
        was_valid = valid[bj, sel]
        osd_ok = osd_ok & ~was_valid
        hard = hard.clone()
        hard[bj, sel] = torch.where(osd_ok[:, :, None], osd_cw, hard[bj, sel])
        valid = valid.clone()
        valid[bj, sel] = was_valid | osd_ok

    # --- SNR estimate -------------------------------------------------------
    noise = _median_rows(real_rows[:, ::4, ::4])
    mean_cell = base[:, :, 0] / len(spec.sync_cells)
    sig = (top_val - 1.0).clamp(min=0.01) * mean_cell
    snr = 10.0 * torch.log10((sig + 1e-30) / (noise[:, None] + 1e-30)) \
        - 10.0 * np.float32(np.log10(2500.0 / spec.tone_spacing)) - 0.6 \
        + np.float32(spec.snr_offset_db)

    return {
        "valid": valid,
        "payload": hard[:, :, : n_payload + n_crc],
        "t0_hop": t0 - spec.pad_hops,
        "f0_bin": f0 + fmin_bin,
        "score": top_val,
        "snr": snr,
    }


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of int64 values to the int32 range."""
    return torch.remainder(x + 2**31, 2**32) - 2**31


def select_subtract_params(m_max: int, payload, valid, score, t0_hop,
                           f0_bin, hash_w) -> torch.Tensor:
    """Pick up to ``m_max`` unique valid decodes per window, strongest
    first: [B, m_max, n_info + 3] int32 = [info | t0_hop | f0_bin | valid].

    Uniqueness is by a payload hash (an int32 dot product that wraps, as
    the reference's int32 einsum; computed in int64 and wrapped, since the
    card has no int32 matmul); ties keep the highest sync score.
    """
    info = payload.to(torch.int64)
    h = _wrap_int32((info * hash_w).sum(-1))
    key_h = torch.where(valid, h, torch.iinfo(torch.int32).max)
    # lexsort((-score, key_h)): hash ascending, then score descending
    o1 = torch.argsort(-score, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(key_h, 1, o1), dim=-1, stable=True)
    order = torch.gather(o1, 1, o2)
    hs = torch.gather(key_h, 1, order)
    vs = torch.gather(valid, 1, order)
    ss = torch.gather(score, 1, order)
    first = torch.cat([torch.ones_like(vs[:, :1]), hs[:, 1:] != hs[:, :-1]],
                      dim=1)
    uniq = vs & first
    _, sel = _top_k(torch.where(uniq, ss, -torch.inf), m_max)
    idx = torch.gather(order, 1, sel)
    okflag = torch.gather(uniq, 1, sel)
    gi = torch.gather(info, 1, idx[:, :, None].expand(-1, -1, info.shape[2]))
    gt = torch.gather(t0_hop.to(torch.int64), 1, idx)
    gf = torch.gather(f0_bin.to(torch.int64), 1, idx)
    return torch.cat([gi, gt[:, :, None], gf[:, :, None],
                      okflag.to(torch.int64)[:, :, None]],
                     dim=-1).to(torch.int32)


def _merge_outs(outs):
    if len(outs) == 1:
        return outs[0]
    return {key: torch.cat([o[key] for o in outs], dim=1) for key in outs[0]}


def _select_and_subtract(spec, sub_max, audio, outs, hash_w, gen_parity):
    """Merge the passes so far, pick the bursts, rebuild the residual."""
    merged = _merge_outs(outs)
    params = select_subtract_params(
        sub_max, merged["payload"], merged["valid"], merged["score"],
        merged["t0_hop"], merged["f0_bin"], hash_w)
    return subtract_known(spec, audio, params, gen_parity)


def _pack_outputs(valid, payload, t0, f0, score, snr) -> torch.Tensor:
    """Pack decode outputs into one uint8 buffer [B, K, ceil(P/8)+10]:
    payload bits 8/byte, then [valid, t0+8192 (2B BE), f0 (3B BE),
    score*16 (2B BE, sat), (snr+64)*256 (2B BE, sat)] — one device->host
    copy for the whole decode."""
    b, k, p = payload.shape
    pad = (-p) % 8
    bits = torch.nn.functional.pad(payload.to(torch.float32), (0, pad))
    w8 = torch.tensor([128.0, 64.0, 32.0, 16.0, 8.0, 4.0, 2.0, 1.0],
                      device=bits.device)
    pay = (bits.reshape(b, k, -1, 8) @ w8).to(torch.uint8)

    def be(v, nbytes):
        v = v.to(torch.int32)
        return torch.stack([(v >> (8 * (nbytes - 1 - i))) & 0xFF
                            for i in range(nbytes)], dim=-1)

    t0q = (t0.to(torch.int32) + 8192).clamp(0, 65535)
    f0q = f0.to(torch.int32).clamp(0, (1 << 24) - 1)
    sq = (score * 16.0).clamp(0.0, 65535.0).to(torch.int32)
    nq = ((snr + 64.0) * 256.0).clamp(0.0, 65535.0).to(torch.int32)
    meta = torch.cat([valid.to(torch.int32)[..., None], be(t0q, 2),
                      be(f0q, 3), be(sq, 2), be(nq, 2)], dim=-1)
    return torch.cat([pay, meta.to(torch.uint8)], dim=-1)


def _parse_packed(packed: np.ndarray, n_p: int) -> dict[str, np.ndarray]:
    """Split the packed uint8 buffer back into output arrays."""
    p8 = -(-n_p // 8)
    pay = np.unpackbits(packed[:, :, :p8], axis=-1)[:, :, :n_p]
    m = packed[:, :, p8:].astype(np.int64)
    return {
        "valid": m[:, :, 0] != 0,
        "payload": pay.astype(np.int8),
        "t0_hop": ((m[:, :, 1] << 8) | m[:, :, 2]) - 8192,
        "f0_bin": (m[:, :, 3] << 16) | (m[:, :, 4] << 8) | m[:, :, 5],
        "score": ((m[:, :, 6] << 8) | m[:, :, 7]).astype(np.float32) / 16.0,
        "snr": ((m[:, :, 8] << 8) | m[:, :, 9]).astype(np.float32)
        / 256.0 - 64.0,
    }


class GFSKDecoder:
    """Host wrapper shared by the sync-array GFSK modes.

    Holds the mode's tables on ``device``.  :meth:`decode` takes host
    audio (peak-scaled to int16, as the audio the reference feeds jt9) or
    a float tensor already on ``device`` (used as is, e.g. windows framed
    straight from the channelizer), runs up to ``depth`` passes with
    subtraction on the device, and returns per-window DecodeResult lists.
    """

    # windows per device call at most (see device_batch_for)
    MAX_DEVICE_BATCH = 64
    # known bursts subtracted per window at most
    SUB_MAX = 16
    # largest DFT matrix (float32 bytes) worth building; above it (the long
    # FST4/FST4W periods) the spectrograms are rffts
    DFT_MAT_BYTES_MAX = 128 << 20

    def __init__(self, spec: ModeSpec, bp: BPDecoder, crc_matrix: np.ndarray,
                 mode, unpack, ap_hypotheses: np.ndarray | None = None,
                 device: torch.device | str | None = None) -> None:
        if spec.depth <= 1 and spec.osd_j:
            spec = dataclasses.replace(spec, osd_j=0)   # jt9 -d 1: no OSD
        self.spec = spec
        self.bp = bp
        self.mode = mode
        self.unpack = unpack
        self.device = as_device(device)
        code = bp.code
        n_info = crc_matrix.shape[0] + crc_matrix.shape[1]
        self._host = {
            "crc_mat": crc_matrix.astype(np.float32),
            "bitmaps": spec.bitmaps(),
            "window": np.hanning(spec.sps).astype(np.float32),
            "data_syms": np.asarray(spec.data_syms, np.int32),
            "gen": np.concatenate([np.eye(code.k, dtype=np.uint8),
                                   code.gen_parity], axis=1),
            "gen_parity": np.asarray(code.gen_parity, np.float32),
            "patterns": flip_patterns(code.k, spec.osd_singles,
                                      spec.osd_tail2,
                                      spec.osd_tail3).astype(np.float32),
            "hash_w": np.random.default_rng(0x5D1F).integers(
                1, 2**31 - 1, size=n_info, dtype=np.int32),
        }
        dft_mat = self._make_dft_mat(self._host["window"])
        if dft_mat is not None:
            self._host["dft_mat"] = dft_mat
        if ap_hypotheses is not None and len(ap_hypotheses):
            hyp = np.asarray(ap_hypotheses)
            mask = np.zeros((hyp.shape[0], code.n), np.float32)
            vals = np.zeros((hyp.shape[0], code.n), np.float32)
            mask[:, : hyp.shape[1]] = (hyp >= 0).astype(np.float32)
            vals[:, : hyp.shape[1]] = np.maximum(hyp, 0).astype(np.float32)
            self._host["ap_mask"] = mask
            self._host["ap_vals"] = vals
        self._tabs = tables_to_torch(self._host, self.device)
        self._tabs["hash_w"] = self._tabs["hash_w"].to(torch.int64)
        # the flip patterns as the OSD kernel takes them (not a reference
        # table, so not in tables())
        self._tabs["pattern_idx"] = torch.from_numpy(pattern_index_lists(
            self._host["patterns"])).to(self.device)
        n_samples = int(round(spec.trperiod * WAVE_SR))
        refine = spec.refine and dft_mat is not None
        if refine and spec.hop % 2:
            raise ValueError(f"{spec.name}: refine needs an even hop")
        n_hops = (n_samples - spec.sps) // spec.hop + 1 + 2 * spec.pad_hops
        if spec.max_hops + spec.os_t * (spec.n_sym - 1) > n_hops:
            raise ValueError(f"{spec.name}: sync search grid exceeds the "
                             "spectrogram; reduce max_hops/pad_hops")
        cand_bytes = spec.top_k * spec.n_sym * spec.n_tones * 8 * 3
        # the refine branch keeps a half-hop demod spectrogram: 2x the hops
        self.max_device_batch = device_batch_for(
            2 * n_hops if refine else n_hops, spec.nfft,
            self.MAX_DEVICE_BATCH, cand_bytes)

    @property
    def spectrogram_branch(self) -> str:
        """Which stage-1 branch decode_program takes: "refine" (split DFT
        matmuls), "dft" (fused DFT matmul) or "rfft"."""
        if "dft_mat" not in self._host:
            return "rfft"
        return "refine" if self.spec.refine else "dft"

    def _make_dft_mat(self, window: np.ndarray) -> np.ndarray | None:
        """[sps, 4*n_bins]: boxcar re/im then Hann re/im DFT columns over
        the kept bins (float64 host trig, cast once); None where the matrix
        would exceed ``DFT_MAT_BYTES_MAX`` (the rfft branch then runs)."""
        spec = self.spec
        fmin_bin, _, n_bins = spec.bin_range
        if spec.sps * 4 * n_bins * 4 > self.DFT_MAT_BYTES_MAX:
            return None
        k = fmin_bin + np.arange(n_bins)
        ang = -2.0 * np.pi * np.outer(np.arange(spec.sps), k) / spec.nfft
        dre, dim = np.cos(ang), np.sin(ang)
        w = window.astype(np.float64)[:, None]
        return np.concatenate([dre, dim, w * dre, w * dim],
                              axis=1).astype(np.float32)

    def tables(self) -> dict[str, torch.Tensor]:
        """Host tables the reference also builds (see ``convert.py``)."""
        t = {k: torch.from_numpy(v) for k, v in self._host.items()}
        bt = self.bp.t
        for name in ("row_cols", "row_mask", "col_slots", "col_mask"):
            t[name] = torch.from_numpy(getattr(bt, name))
        return t

    @functools.cached_property
    def _later_pass_spec(self) -> ModeSpec:
        # later passes search the residual with half the pass-1 budget
        return dataclasses.replace(
            self.spec,
            top_k=min(self.spec.top_k, max(128, self.spec.top_k // 2)))

    @on_device_lock
    def decode_arrays_device(self, audio: torch.Tensor,
                             spec: ModeSpec | None = None
                             ) -> dict[str, torch.Tensor]:
        """Run decode_program over ``audio`` [n, N] on the device, in calls
        of at most ``max_device_batch`` windows."""
        spec = spec or self.spec
        audio = window_batch(audio, self.device)
        chunks = [decode_program(spec, audio[i : i + self.max_device_batch],
                                 self._tabs, self.bp)
                  for i in range(0, audio.shape[0], self.max_device_batch)]
        if len(chunks) == 1:
            return chunks[0]
        return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}

    def _passes(self, audio_dev: torch.Tensor, depth: int) -> np.ndarray:
        """Every decode pass on the device; one packed host copy at the end."""
        work = audio_dev
        outs: list[dict[str, torch.Tensor]] = []
        for p in range(max(1, depth)):
            outs.append(self.decode_arrays_device(
                work, self._later_pass_spec if p else None))
            if p + 1 >= depth:
                break
            if not bool(outs[-1]["valid"].any()):
                # exact early exit: the residual would be unchanged
                break
            work = _select_and_subtract(
                self.spec, self.SUB_MAX, audio_dev, outs,
                self._tabs["hash_w"], self._tabs["gen_parity"])
        m = _merge_outs(outs)
        return _pack_outputs(m["valid"], m["payload"], m["t0_hop"],
                             m["f0_bin"], m["score"], m["snr"]).cpu().numpy()

    @on_device_lock
    def warm_passes(self, n_windows: int, depth: int | None = None) -> None:
        """Run every pass arity :meth:`decode` can reach once on silence
        (allocator pools, library handles), as the reference pre-compiles
        them."""
        depth = depth or self.spec.depth
        n = int(round(self.spec.trperiod * WAVE_SR))
        audio = torch.zeros(n_windows, n, device=self.device)
        outs = [self.decode_arrays_device(audio)]
        for _p in range(1, depth):
            _select_and_subtract(self.spec, self.SUB_MAX, audio, outs,
                                 self._tabs["hash_w"],
                                 self._tabs["gen_parity"])
            outs.append(self.decode_arrays_device(audio,
                                                  self._later_pass_spec))
        m = _merge_outs(outs)
        _pack_outputs(m["valid"], m["payload"], m["t0_hop"], m["f0_bin"],
                      m["score"], m["snr"]).cpu()

    @on_device_lock
    def decode(self, audio, depth: int | None = None):
        """Decode [n, N] (or [N]) windows with multi-pass subtraction."""
        if isinstance(audio, torch.Tensor):
            audio_dev = window_batch(audio, self.device)
        else:
            a = np.asarray(audio, dtype=np.float32)
            if a.ndim == 1:
                a = a[None, :]
            # peak-scaled int16, the audio format the reference feeds jt9
            # (Instance::prepareAudio, source/Instance.cpp:294-338)
            peak = np.abs(a).max(axis=1, keepdims=True)
            scaled = (a * (32000.0 / np.maximum(peak, 1e-30))).astype(np.int16)
            audio_dev = torch.from_numpy(scaled).to(self.device).to(
                torch.float32)
        n_windows = audio_dev.shape[0]
        spec = self.spec
        n_payload = self._host["crc_mat"].shape[0]
        n_info = n_payload + self._host["crc_mat"].shape[1]
        out = _parse_packed(self._passes(audio_dev, depth or spec.depth),
                            n_info)
        # dedup BEFORE unpacking: passes and OSD repeat each signal
        seen: list[dict[bytes, tuple[float, int]]] = [
            dict() for _ in range(n_windows)]
        for wi, k in np.argwhere(out["valid"]):
            key = np.packbits(
                out["payload"][wi, k, :n_payload].astype(np.uint8)).tobytes()
            score = float(out["score"][wi, k])
            prev = seen[wi].get(key)
            if prev is None or score > prev[0]:
                seen[wi][key] = (score, int(k))
        results = []
        for wi in range(n_windows):
            rs = []
            for score, k in seen[wi].values():
                payload = np.asarray(out["payload"][wi, k, :n_payload])
                dt = out["t0_hop"][wi, k] * spec.hop / WAVE_SR \
                    - spec.signal_start_s
                freq = out["f0_bin"][wi, k] * spec.bin_hz
                rs.append(DecodeResult(
                    message=self.unpack(payload),
                    snr_db=round(float(out["snr"][wi, k]), 1),
                    dt_s=round(float(dt), 2),
                    freq_hz=round(float(freq), 1),
                    score=score,
                    mode=self.mode,
                    payload_bits=payload.copy(),
                ))
            results.append(sorted(rs, key=lambda r: -r.score))
        return results

