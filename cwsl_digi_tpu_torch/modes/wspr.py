"""WSPR: 4-FSK beacon mode, 120 s T/R, K=32 r=1/2 convolutional code
(PyTorch).

Counterpart of ``cwsl_digi_tpu/modes/wspr.py``.  Physical layer (public
WSPR parameters): 162 symbols x 8192 samples at 12 kHz, 4-FSK with
``tone = sync_bit + 2*data_bit``; 50 message bits (28-bit callsign, 15-bit
grid, 7-bit power) plus 31 zero tail bits, convolutionally encoded at rate
1/2 with the K=32 Layland-Lushbaugh polynomials and interleaved by 8-bit
bit reversal.  FST4W carries the same message payload (``modes/fst4.py``).

The protocol constants, interleaver, encoder, block-code matrices, message
codec, synthesizer and the host half of :class:`WSPRDecoder` (polish,
acceptance gates, dedup and clustering) are the reference's, copied.  The
device decoder is the port of the reference's:

  1. Hann and boxcar spectrograms (8192-sample frames, 2048 hop,
     16384-point rffts on cuFFT) over the 200 Hz WSPR sub-band;
  2. sync-vector correlation over (t0, f0) and 5 drift hypotheses as
     162 signed shifted-slice sums of a sync-contrast map; top-K;
  3. coherent 1/2/3/4-symbol data LLRs with the sub-bin rotation;
  4. the 81-step beam search with state merging (:func:`_beam_decode`:
     on the card one launch of the ``wspr_beam`` kernel,
     ``csrc/weak.cu``), decision-directed coherent passes, OSD over the
     (162, 50) block code, and the SNR.

The trellis states are uint32 values held in int64 tensors with masks
(``torch.uint32`` lacks most operations on CUDA); sorts and top-K keep
index order on ties, as the reference's do, so the beam keeps the same
survivors and back-pointers.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import Mode, WAVE_SR
from cwsl_digi_tpu_torch.convert import tables_to_torch
from cwsl_digi_tpu_torch.device import as_device
from cwsl_digi_tpu_torch.modes import _weak_kernels
from cwsl_digi_tpu_torch.modes.base import (DecodeResult, on_device_lock,
                                            window_batch)
from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate
from cwsl_digi_tpu_torch.modes.gfsk_engine import (_median_rows, _top_k,
                                                   device_batch_for)
from cwsl_digi_tpu_torch.modes.osd import (flip_patterns, osd_decode,
                                          pattern_index_lists)
from cwsl_digi_tpu_torch.modes.subtract import _cumsum

# ---------------------------------------------------------------------------
# Protocol constants
# ---------------------------------------------------------------------------
NSYM = 162
SPS = 8192
BAUD = WAVE_SR / SPS               # 1.46484375
TONE_SPACING = BAUD
T_R = 120.0
SIGNAL_START_S = 1.0
N_MSG_BITS = 50
N_TAIL = 31
POLY1 = 0xF2D05351
POLY2 = 0xE4613C47

HOP = SPS // 4                     # 2048
NFFT = 2 * SPS                     # 16384 -> 0.7324 Hz bins
BIN_HZ = WAVE_SR / NFFT
FMIN_HZ, FMAX_HZ = 1400.0, 1600.0
PAD_HOPS = 32


from cwsl_digi_tpu_torch.modes.tables import WSPR_SYNC  # noqa: E402

SYNC = np.asarray(WSPR_SYNC, np.int32)
assert SYNC.shape == (NSYM,)


def interleave_map(n: int = NSYM) -> np.ndarray:
    """dest[i] = bit-reversed-index order (wsprd's interleaver)."""
    out = []
    for i in range(256):
        j = int(f"{i:08b}"[::-1], 2)
        if j < n:
            out.append(j)
        if len(out) == n:
            break
    return np.asarray(out, np.int32)     # position of source bit k -> out[k]


INTERLEAVE = interleave_map()


# ---------------------------------------------------------------------------
# Convolutional code (host reference + device tables)
# ---------------------------------------------------------------------------

def _parity32(x: int) -> int:
    return bin(x & 0xFFFFFFFF).count("1") & 1


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """K=32 r=1/2 encoder over bits+tail -> 162 coded bits (pre-interleave)."""
    bits = np.asarray(bits, np.uint8)
    assert bits.shape == (N_MSG_BITS,)
    reg = 0
    out = []
    for b in np.concatenate([bits, np.zeros(N_TAIL, np.uint8)]):
        reg = ((reg << 1) | int(b)) & 0xFFFFFFFF
        out.append(_parity32(reg & POLY1))
        out.append(_parity32(reg & POLY2))
    return np.asarray(out, np.uint8)


@functools.lru_cache(maxsize=None)
def _code_matrices() -> tuple[np.ndarray, np.ndarray]:
    """(G [50,162], R [162,50]) over GF(2) with G @ R = I.

    The conv encoder (zero tail) is linear, so the transmitted 162 coded
    bits form a (162, 50) linear block code: G rows = encodings of unit
    messages, in coded-bit (pre-interleave) order — the order the decode
    program's deinterleaved LLRs use.  R is a right-inverse recovering the
    message from any codeword (``bits = cw @ R mod 2``), built from the row
    ops of a GF(2) elimination.  This is what makes ``wsprd -o`` style
    ordered-statistics decoding (source/DecoderPool.hpp:1023-1026 spawns
    ``wsprd ... -o 5``) applicable to the sequential code.
    """
    eye = np.eye(N_MSG_BITS, dtype=np.uint8)
    G = np.stack([conv_encode(eye[i]) for i in range(N_MSG_BITS)])
    A = G.copy()
    E = np.eye(N_MSG_BITS, dtype=np.uint8)
    r = 0
    pivots = []
    for c in range(A.shape[1]):
        nz = np.nonzero(A[r:, c])[0]
        if len(nz) == 0:
            continue
        p = r + nz[0]
        A[[r, p]] = A[[p, r]]
        E[[r, p]] = E[[p, r]]
        for i in np.nonzero(A[:, c])[0]:
            if i != r:
                A[i] ^= A[r]
                E[i] ^= E[r]
        pivots.append(c)
        r += 1
        if r == N_MSG_BITS:
            break
    assert r == N_MSG_BITS, "generator matrix not full rank"
    # G[:, pivots] = E^-1, so R[pivots, :] = E gives G @ R = I
    R = np.zeros((NSYM, N_MSG_BITS), np.uint8)
    R[np.asarray(pivots)] = E
    assert np.array_equal(G.dot(R) % 2, np.eye(N_MSG_BITS, dtype=np.uint8))
    return G, R


# ---------------------------------------------------------------------------
# Message packing (callsign + grid + power, 50 bits) — the call/grid charsets
# are the protocol tables shared with the FT8 codec (message77.py)
# ---------------------------------------------------------------------------
from cwsl_digi_tpu_torch.modes import legacy72  # noqa: E402


def pack_message(callsign: str, grid: str, dbm: int) -> np.ndarray:
    """Type-1 WSPR payload: [packcall:28][grid15:15][pwr+64:7].

    Bit-exact per G4JNT "The WSPR Coding Process": N1 = packcall,
    M1 = (179-10*lonA-lonD)*180 + 10*latA + latD, N2 = M1*128 + pwr + 64.
    """
    n = legacy72.packcall(callsign)
    if n is None or n >= legacy72.NBASE:
        raise ValueError(f"cannot pack WSPR callsign {callsign!r}")
    m = legacy72.packgrid15(grid)
    if m is None:
        raise ValueError(f"bad grid {grid!r}")
    p = max(0, min(60, int(dbm))) + 64
    bits = (
        [(n >> (27 - i)) & 1 for i in range(28)]
        + [(m >> (14 - i)) & 1 for i in range(15)]
        + [(p >> (6 - i)) & 1 for i in range(7)]
    )
    return np.asarray(bits, np.uint8)


def unpack_message(bits: np.ndarray) -> tuple[str, str, int]:
    bits = np.asarray(bits, np.uint8)
    n = 0
    for b in bits[:28]:
        n = (n << 1) | int(b)
    call = legacy72.unpackcall(n)
    if call is None or n >= legacy72.NBASE:
        raise ValueError("invalid callsign field")
    m = 0
    for b in bits[28:43]:
        m = (m << 1) | int(b)
    grid = legacy72.unpackgrid15(m)
    if grid is None:
        raise ValueError("invalid grid field")
    p = 0
    for b in bits[43:50]:
        p = (p << 1) | int(b)
    ntype = p - 64
    if not 0 <= ntype <= 60:
        raise ValueError("invalid power field (non-type-1 message)")
    return call, grid, ntype


def encode(callsign: str, grid: str, dbm: int) -> np.ndarray:
    """Message -> 162 tone indices."""
    coded = conv_encode(pack_message(callsign, grid, dbm))
    interleaved = np.zeros(NSYM, np.uint8)
    interleaved[INTERLEAVE] = coded
    return (SYNC + 2 * interleaved.astype(np.int32)).astype(np.int32)


def synthesize(callsign: str, grid: str, dbm: int, f0_hz: float = 1500.0,
               amplitude: float = 1.0,
               window_len: int = int(T_R * WAVE_SR),
               start_s: float = SIGNAL_START_S) -> np.ndarray:
    tones = encode(callsign, grid, dbm)
    burst = gfsk_modulate(tones, f0_hz, SPS, WAVE_SR, TONE_SPACING, bt=2.0)
    out = np.zeros(window_len)
    start = int(round(start_s * WAVE_SR))
    n = min(len(burst), window_len - start)
    out[start : start + n] = amplitude * burst[:n]
    return out


# ---------------------------------------------------------------------------
# Device decode program
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WSPRConfig:
    top_k: int = 24
    beam_width: int = 512       # wsprd `cycles` effort analogue
    max_hops: int = 48          # start-time search grid (x 0.17 s)
    # linear drift hypotheses over the burst, Hz end-to-end (wsprd searches
    # +-4 Hz; source invocation DecoderPool.hpp:1023-1026)
    drifts_hz: tuple[float, ...] = (-4.0, -2.0, 0.0, 2.0, 4.0)
    # OSD fallback over the (162, 50) block code (wsprd's -o flag analogue;
    # spawn site source/DecoderPool.hpp:1023-1026); 0 disables
    osd_j: int = 8              # strongest sync candidates to try
    osd_singles: int = 50
    osd_tail2: int = 26
    osd_tail3: int = 14
    # decision-directed coherent refinement: re-encode the best path, fix
    # every neighbor's tone, re-demod each symbol with a +-dd_window
    # coherent sum, decode again.  THE effort lever wsprcycles maps to —
    # beam width / OSD depth / top_k were all measured inert at -31 dB
    # (the LLRs, not the search, are the wall).
    dd_passes: int = 2
    dd_window: int = 4


def _drift_offsets(cfg: WSPRConfig) -> np.ndarray:
    """[D, NSYM] per-symbol bin offsets for each linear drift hypothesis."""
    d = np.asarray(cfg.drifts_hz)[:, None]          # Hz end-to-end
    frac = (np.arange(NSYM)[None, :] / (NSYM - 1)) - 0.5
    return np.round(d * frac / BIN_HZ).astype(np.int32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of 32-bit values in an int64 tensor; the byte sums'
    multiply wraps at 32 bits as the reference's uint32 one does."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _decode_program(cfg: WSPRConfig, audio: torch.Tensor, tabs: dict
                    ) -> dict[str, torch.Tensor]:
    """One decode of a batch of 120 s windows ([B, N] float32 audio).

    ``tabs``: sync [162], interleave [162] (coded bit k -> symbol), window
    [SPS], wspr_gen/wspr_inv and the OSD flip patterns.  Returns the
    reference's outputs: bits/metric of the beam (and the DD passes),
    llr [B, K, 81, 2], score, t0_hop, f0_bin, drift_idx, snr and, with OSD,
    osd_bits/osd_dist/osd_nhard/osd_wsum.
    """
    b, n_samples = audio.shape
    dev = audio.device
    n_hops = (n_samples - SPS) // HOP + 1
    fmin_bin = int(FMIN_HZ / BIN_HZ)
    fmax_bin = int(FMAX_HZ / BIN_HZ)
    n_bins = fmax_bin - fmin_bin + 8
    sync = tabs["sync"].to(torch.int64)
    deinter = tabs["interleave"].to(torch.int64)

    # two windows: tapered for the sync search, boxcar (matched filter for
    # constant tones) for the data demod.  The boxcar spectrogram stays
    # COMPLEX: the demod combines adjacent symbols coherently.
    frames = audio.unfold(1, SPS, HOP)                      # [B, hops, SPS]

    def spectrogram(w):
        x = torch.fft.rfft(frames * w, n=NFFT, dim=-1)
        x = x[:, :, fmin_bin : fmin_bin + n_bins]
        return torch.nn.functional.pad(x, (0, 0, PAD_HOPS, PAD_HOPS))

    power_sync = spectrogram(tabs["window"]).abs() ** 2
    stft = spectrogram(torch.ones_like(tabs["window"]))
    del frames
    power = stft.abs() ** 2

    # sync-contrast map: m[h, f] = P(tone1)+P(tone3) - P(tone0)-P(tone2)
    n_f0 = fmax_bin - fmin_bin
    p = power_sync
    mmap = (p[:, :, 2 : 2 + n_f0] + p[:, :, 6 : 6 + n_f0]
            - p[:, :, 0:n_f0] - p[:, :, 4 : 4 + n_f0])

    n_t0 = cfg.max_hops
    offs = _drift_offsets(cfg)                   # [D, NSYM] static
    n_d = offs.shape[0]
    # headroom so drift-shifted slices stay in range
    max_off = int(np.abs(offs).max())
    n_f0p = n_f0 - 2 * max_off
    scores = []
    for di in range(n_d):
        acc = torch.zeros(b, n_t0, n_f0p, device=dev)
        for i in range(NSYM):
            h0 = 4 * i
            b0 = max_off + int(offs[di, i])
            sl = mmap[:, h0 : h0 + n_t0, b0 : b0 + n_f0p]
            acc = acc + (sl if SYNC[i] > 0 else -sl)
        scores.append(acc)
    score_d = torch.stack(scores, dim=1)         # [B, D, n_t0, n_f0']
    base = power.mean(dim=(1, 2), keepdim=True) * NSYM
    score_d = score_d / (base[:, :, :, None] + 1e-30)

    top_val, top_idx = _top_k(score_d.reshape(b, -1), cfg.top_k)
    d_idx = top_idx // (n_t0 * n_f0p)
    rem = top_idx % (n_t0 * n_f0p)
    t0 = rem // n_f0p
    f0 = rem % n_f0p + max_off                   # back to mmap bin coords

    # per-symbol data LLRs: bit=0 -> tone sync_i, bit=1 -> tone sync_i+2;
    # bins follow the candidate's drift trajectory.  Coherent 1/2/3/4-symbol
    # demod: every WSPR symbol has a known sync chip in the tone LSB, so
    # each neighbor hypothesis is one data bit, and tone spacing = baud
    # makes the inter-symbol reference rotation tone-independent:
    # rot = exp(-2j*pi*abs_bin*SPS/NFFT).
    cand_off = torch.as_tensor(offs, dtype=torch.int64, device=dev)[d_idx]
    sym_hops = t0[:, :, None] + 4 * torch.arange(NSYM, device=dev)
    tone_bins = 2 * sync[:, None] + 4 * torch.arange(2, device=dev)
    bins = f0[:, :, None, None] + cand_off[:, :, :, None] + tone_bins
    bb = torch.arange(b, device=dev)[:, None, None, None]
    cbit = stft[bb, sym_hops[:, :, :, None], bins]          # [B,K,162,2] c64
    del stft
    abs_bin = (f0 + fmin_bin).to(torch.float32)
    rot = torch.exp(-2j * np.pi * abs_bin * (SPS / NFFT))   # [B, K]
    e1 = cbit.abs() ** 2                                    # [B,K,162,2]
    # sub-bin frequency-residual correction from hard-decision pairs (see
    # the reference: tone spacing = baud makes the DFT phase
    # tone-independent)
    hard = e1.argmax(dim=-1)                                # [B,K,162]
    cb = torch.gather(cbit, -1, hard[..., None])[..., 0]
    z = (cb[:, :, :-1].conj() * cb[:, :, 1:]).sum(dim=-1) * rot
    rot = rot * torch.exp(-1j * z.angle())
    r_ = rot[:, :, None, None, None]

    cpad = torch.nn.functional.pad(cbit, (0, 0, 1, 1))
    cprev = cpad[:, :, :NSYM]                               # symbol s-1
    cnext = cpad[:, :, 2:]                                  # symbol s+1
    e1p = cprev.abs() ** 2
    e1n = cnext.abs() ** 2

    def xterm(a, bb2, rr):                 # 2Re(conj(a) rr b): [..., i, j]
        return 2.0 * (a.conj()[..., :, None] * (rr * bb2[..., None, :])).real

    # cross terms [B,K,162,i,j]: i = neighbor bit, j = self bit
    x_ps = xterm(cprev, cbit, r_)
    x_sn = xterm(cbit, cnext, r_).transpose(-1, -2)
    # pair metrics, max-marginalized over the neighbor's data bit
    e2p = e1 + (e1p[..., :, None] + x_ps).amax(dim=-2)
    e2n = e1 + (e1n[..., :, None] + x_sn).amax(dim=-2)
    # triple metric [B,K,162,p,j,n] -> max over (prev, next) bits
    x_pn = xterm(cprev, cnext, r_ * r_)
    x_sn_t = x_sn.transpose(-1, -2)
    tri = (e1p[..., :, None, None] + e1[..., None, :, None]
           + e1n[..., None, None, :]
           + x_ps[..., :, :, None]
           + x_sn_t[..., None, :, :]
           + x_pn[..., :, None, :])
    e3 = tri.amax(dim=(-3, -1))                             # [B,K,162,2]
    # 4-symbol coherent windows: each window maxes over 2^3 = 8 combos
    cpad2 = torch.nn.functional.pad(cbit, (0, 0, 2, 2))
    cprev2 = cpad2[:, :, :NSYM]
    cnext2 = cpad2[:, :, 4:]
    e1p2 = cprev2.abs() ** 2
    e1n2 = cnext2.abs() ** 2
    r2_ = r_ * r_
    r3_ = r2_ * r_
    x_p_nn = xterm(cprev, cnext2, r3_)
    x_s_nn = xterm(cbit, cnext2, r2_)
    x_n_nn = xterm(cnext, cnext2, r_)
    x_pp_p = xterm(cprev2, cprev, r_)
    x_pp_s = xterm(cprev2, cbit, r2_)
    x_pp_n = xterm(cprev2, cnext, r3_)
    # window [s-1, s, s+1, s+2]: axes (..., p, self, n, q)
    w4n = (e1p[..., :, None, None, None] + e1[..., None, :, None, None]
           + e1n[..., None, None, :, None] + e1n2[..., None, None, None, :]
           + x_ps[..., :, :, None, None]
           + x_pn[..., :, None, :, None]
           + x_p_nn[..., :, None, None, :]
           + x_sn_t[..., None, :, :, None]
           + x_s_nn[..., None, :, None, :]
           + x_n_nn[..., None, None, :, :])
    e4n = w4n.amax(dim=(-4, -2, -1))                        # [B,K,162,2]
    # window [s-2, s-1, s, s+1]: axes (..., q2, p, self, n)
    w4p = (e1p2[..., :, None, None, None] + e1p[..., None, :, None, None]
           + e1[..., None, None, :, None] + e1n[..., None, None, None, :]
           + x_pp_p[..., :, :, None, None]
           + x_pp_s[..., :, None, :, None]
           + x_pp_n[..., :, None, None, :]
           + x_ps[..., None, :, :, None]
           + x_pn[..., None, :, None, :]
           + x_sn_t[..., None, None, :, :])
    e4p = w4p.amax(dim=(-4, -3, -1))                        # [B,K,162,2]
    metric_sym = e1 + e2p + e2n + e3 + e4n + e4p
    llr_sym = metric_sym[..., 0] - metric_sym[..., 1]       # [B, K, 162]
    # per-candidate scale normalization (energies are scale-dependent)
    llr_sym = llr_sym / (llr_sym.std(dim=-1, correction=0, keepdim=True)
                         + 1e-20) * 3.0
    llr = llr_sym[:, :, deinter]                            # coded-bit order
    # interleaved pairs: coded bit 2t, 2t+1 for trellis step t
    llr = llr.reshape(b * cfg.top_k, 81, 2)

    bits, metric = _beam_decode(cfg, llr)

    # --- decision-directed coherent refinement passes ---------------------
    # With a full candidate word every tone is hypothesized known, so each
    # symbol is re-demodulated as a +-dd_window coherent sum with its
    # neighbors fixed; the best pass wins per candidate on path metric.
    if cfg.dd_passes > 1:
        g_dev = tabs["wspr_gen"].to(torch.float32)          # [50, 162]
        inter_inv = torch.empty_like(deinter)
        inter_inv[deinter] = torch.arange(NSYM, device=dev)
        phi = rot.angle()                                   # [B, K]
        rot_pow = torch.exp(
            1j * phi[:, :, None] * torch.arange(NSYM, device=dev))
        v = cbit * rot_pow[..., None]                       # [B,K,162,2]
        v_flat = v.reshape(b * cfg.top_k, NSYM, 2)
        w_dd = cfg.dd_window
        lo = torch.as_tensor(np.maximum(np.arange(NSYM) - w_dd, 0),
                             device=dev)
        hi = torch.as_tensor(np.minimum(np.arange(NSYM) + w_dd + 1, NSYM),
                             device=dev)
        for _pass in range(cfg.dd_passes - 1):
            coded = torch.remainder(bits.to(torch.float32) @ g_dev, 2.0)
            d_sym = coded[:, inter_inv].to(torch.int64)
            chosen = torch.gather(v_flat, -1, d_sym[:, :, None])[..., 0]
            csum = _cumsum(torch.nn.functional.pad(chosen, (1, 0)))
            s_win = csum[:, hi] - csum[:, lo]               # [N, 162]
            s_excl = s_win - chosen
            e_dd = (s_excl[:, :, None] + v_flat).abs() ** 2  # [N,162,2]
            llr_dd = e_dd[..., 0] - e_dd[..., 1]
            llr_dd = llr_dd / (llr_dd.std(dim=-1, correction=0, keepdim=True)
                               + 1e-20) * 3.0
            llr_dd = llr_dd[:, deinter].reshape(b * cfg.top_k, 81, 2)
            bits2, metric2 = _beam_decode(cfg, llr_dd)
            better = metric2 > metric
            bits = torch.where(better[:, None], bits2, bits)
            metric = torch.maximum(metric2, metric)

    bits = bits.reshape(b, cfg.top_k, N_MSG_BITS)
    metric = metric.reshape(b, cfg.top_k)

    # OSD fallback (wsprd -o analogue): reliability-ordered re-encoding over
    # the (162, 50) block code on the strongest sync candidates (top-K
    # output is sorted by score, so the first osd_j slots are the strongest)
    osd = {}
    if cfg.osd_j > 0:
        j = min(cfg.osd_j, cfg.top_k)
        llr_j = llr.reshape(b, cfg.top_k, NSYM)[:, :j]
        cw, dist, nhard = osd_decode(
            tabs["wspr_gen"], llr_j.reshape(b * j, NSYM), tabs["patterns"],
            tabs["pattern_idx"])
        osd_bits = torch.remainder(
            cw.to(torch.float32) @ tabs["wspr_inv"].to(torch.float32), 2.0)
        osd = {
            "osd_bits": osd_bits.reshape(b, j, N_MSG_BITS).to(torch.uint8),
            "osd_dist": dist.reshape(b, j),
            "osd_nhard": nhard.reshape(b, j),
            "osd_wsum": llr_j.abs().sum(dim=-1),
        }

    noise = _median_rows(power_sync)
    sig = top_val.abs() * base[:, :, 0] / NSYM
    # +1.8 dB: calibration vs injected signals of known SNR (tools/snr_check)
    snr = 10.0 * torch.log10((sig + 1e-30) / (noise[:, None] + 1e-30)) \
        - 10.0 * np.float32(np.log10(2500.0 / TONE_SPACING)) + 1.8

    return {
        "bits": bits,             # [B, K, 50]
        "metric": metric,         # path metric
        "llr": llr.reshape(b, cfg.top_k, 81, 2),
        "score": top_val,
        "t0_hop": t0 - PAD_HOPS,
        "f0_bin": f0 + fmin_bin,
        "drift_idx": d_idx,       # index into cfg.drifts_hz
        "snr": snr,
        **osd,
    }


def _beam_decode(cfg: WSPRConfig, llr: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-width beam search over the 81-step rate-1/2 trellis.

    llr: [N, 81, 2] float32, positive = coded bit 0.  Returns ([N, 50]
    int8 bits, [N] best path metric normalized by total |llr|).  On a CUDA
    tensor one launch of the ``wspr_beam`` kernel (``_weak_kernels``; it
    raises where the kernel cannot run), on a CPU tensor
    :func:`_beam_decode_plain`; the normalisation is the same torch op on
    both.
    """
    if llr.device.type == "cpu":
        return _beam_decode_plain(cfg, llr)
    best, bits = _weak_kernels.wspr_beam(llr.contiguous(), cfg.beam_width)
    norm = llr.abs().sum(dim=(1, 2)) + 1e-30
    return bits, best / (0.5 * norm)


def _beam_decode_plain(cfg: WSPRConfig, llr: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_beam_decode` in plain PyTorch: a Python loop of batched
    steps; the survivors of each step are the reference's (stable key sort,
    top-K lower index first on ties), so are the back-pointers.
    """
    n = llr.shape[0]
    w = cfg.beam_width
    steps = N_MSG_BITS + N_TAIL
    dev = llr.device

    states = torch.zeros(n, w, dtype=torch.int64, device=dev)   # uint32 values
    metrics = torch.full((n, w), -1e9, dtype=torch.float32, device=dev)
    metrics[:, 0] = 0.0                                         # one live root
    live = torch.zeros(n, w, dtype=torch.float32, device=dev)
    live[:, 0] = 1.0
    parents, chosen_bits = [], []
    for t in range(steps):
        step_llr = llr[:, t]                                    # [N, 2]
        # branch on bit 0 and bit 1
        s0 = (states << 1) & 0xFFFFFFFF
        s1 = s0 | 1

        def out_metric(s):
            b1 = (_popcount32(s & POLY1) & 1).to(torch.float32)
            b2 = (_popcount32(s & POLY2) & 1).to(torch.float32)
            return ((1.0 - 2.0 * b1) * step_llr[:, None, 0]
                    + (1.0 - 2.0 * b2) * step_llr[:, None, 1]) * 0.5

        m0 = metrics + out_metric(s0)
        m1 = metrics + out_metric(s1)
        if t >= N_MSG_BITS:                                     # zero tail
            m1 = m1 - 1e9
        all_states = torch.cat([s0, s1], dim=1)                 # [N, 2W]
        all_live = torch.cat([live, live], dim=1)
        all_metrics = torch.where(all_live > 0, torch.cat([m0, m1], dim=1),
                                  -1e9)

        # State merging (reduced-state Viterbi): future branch metrics
        # depend only on the low 31 register bits, so survivors equal there
        # are duplicates; each key occurs at most twice in the 2W
        # expansion, so one neighbor comparison after a sort suffices.
        key = all_states & 0x7FFFFFFF
        order = torch.argsort(key, dim=1, stable=True)
        k_s = torch.gather(key, 1, order)
        m_s = torch.gather(all_metrics, 1, order)
        same_next = k_s[:, :-1] == k_s[:, 1:]
        # drop the worse of an adjacent equal pair (ties: drop the later)
        drop_lo = torch.nn.functional.pad(
            same_next & (m_s[:, :-1] < m_s[:, 1:]), (0, 1))
        drop_hi = torch.nn.functional.pad(
            same_next & (m_s[:, 1:] <= m_s[:, :-1]), (1, 0))
        m_s = torch.where(drop_lo | drop_hi, -1e9, m_s)

        metrics, top_si = _top_k(m_s, w)
        top_i = torch.gather(order, 1, top_si)
        states = torch.gather(all_states, 1, top_i)
        live = torch.gather(all_live, 1, top_i)
        # back-pointers: parent index (mod W) and chosen bit
        parents.append(top_i % w)
        chosen_bits.append((top_i // w).to(torch.int8))

    # backtrack the best path (index 0 after the final sort)
    idx = metrics.argmax(dim=1)[:, None]                        # [N, 1]
    rev_bits = []
    for t in range(steps - 1, -1, -1):
        rev_bits.append(torch.gather(chosen_bits[t], 1, idx)[:, 0])
        idx = torch.gather(parents[t], 1, idx)
    path = torch.stack(rev_bits[::-1], dim=1)                   # [N, 81]
    norm = llr.abs().sum(dim=(1, 2)) + 1e-30
    best_metric = metrics.amax(dim=1) / (0.5 * norm)
    return path[:, :N_MSG_BITS], best_metric


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------

class WSPRDecoder:
    """The reference's WSPR decoder on ``device`` (default: the card).

    :meth:`decode` takes host audio (used as float32, without rescaling,
    as the reference) or a float tensor already on ``device``; the device
    program runs in calls of at most ``max_device_batch`` windows, and the
    polish, acceptance gates, per-call dedup and 4 Hz clustering run on
    the host as the reference's.
    """

    mode = Mode.WSPR

    def __init__(self, top_k: int | None = None, beam_width: int | None = None,
                 cycles: int | None = None,
                 device: torch.device | str | None = None):
        # wsprd's cycles-per-bit knob (default 3000, config.ini:217-222;
        # wsprd -C at DecoderPool.hpp:1026) maps to search effort as in
        # the reference (see its comment: low cycles buys the same
        # sensitivity cheaper, high cycles search headroom)
        kw: dict = {}
        if cycles is not None and beam_width is None:
            if cycles <= 500:
                kw = dict(beam_width=256, dd_passes=1, osd_j=4)
            elif cycles >= 10_000:
                kw = dict(beam_width=1024, dd_passes=3, dd_window=6,
                          osd_j=16, top_k=32,
                          drifts_hz=tuple(float(d) for d in range(-4, 5)))
            # 3000-class: defaults
        self.cfg = WSPRConfig(**{
            **kw,
            "top_k": top_k or kw.get("top_k", WSPRConfig.top_k),
            "beam_width": beam_width or kw.get("beam_width",
                                               WSPRConfig.beam_width),
        })
        self.device = as_device(device)
        if self.device.type == "cuda":
            # the card's beam search takes powers of two from 32 to 1024
            _weak_kernels.check_beam_width(self.cfg.beam_width)
        g, r = _code_matrices()
        # coded bit k lives at symbol position INTERLEAVE[k], so gathering
        # symbol LLRs with INTERLEAVE yields coded-bit order
        self._host = {
            "sync": SYNC.astype(np.int32),
            "interleave": INTERLEAVE,
            "window": np.hanning(SPS).astype(np.float32),
            "wspr_gen": g,
            "wspr_inv": r,
        }
        if self.cfg.osd_j > 0:
            self._host["patterns"] = flip_patterns(
                N_MSG_BITS, self.cfg.osd_singles, self.cfg.osd_tail2,
                self.cfg.osd_tail3).astype(np.float32)
        self._tabs = tables_to_torch(self._host, self.device)
        if self.cfg.osd_j > 0:
            # the flip patterns as the OSD kernel takes them (not a
            # reference table, so not in tables())
            self._tabs["pattern_idx"] = torch.from_numpy(pattern_index_lists(
                self._host["patterns"])).to(self.device)

    @property
    def spectrogram_branch(self) -> str:
        """The spectrograms are rffts (cuFFT on the card)."""
        return "rfft"

    @property
    def max_device_batch(self) -> int:
        """Windows per device call for 120 s windows."""
        return self._max_device_batch(int(T_R * WAVE_SR))

    @staticmethod
    def _max_device_batch(n_samples: int) -> int:
        n_hops = (n_samples - SPS) // HOP + 1 + 2 * PAD_HOPS
        return device_batch_for(n_hops, NFFT, 64)

    def tables(self) -> dict[str, torch.Tensor]:
        """Host tables the reference also builds (see ``convert.py``)."""
        return {k: torch.from_numpy(v) for k, v in self._host.items()}

    @on_device_lock
    def decode_arrays_device(self, audio) -> dict[str, torch.Tensor]:
        """The device program over ``audio`` [n, N] (host array or tensor
        on ``device``), in calls of at most ``max_device_batch`` windows.
        (The reference pads the last call to a whole batch for one compiled
        shape; no window's result depends on it.)"""
        audio = window_batch(audio, self.device)
        batch = self._max_device_batch(audio.shape[1])
        chunks = [_decode_program(self.cfg, audio[i : i + batch], self._tabs)
                  for i in range(0, audio.shape[0], batch)]
        if len(chunks) == 1:
            return chunks[0]
        return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}

    @on_device_lock
    def decode_arrays(self, audio) -> dict[str, np.ndarray]:
        return {k: v.cpu().numpy()
                for k, v in self.decode_arrays_device(audio).items()}

    @on_device_lock
    def decode(self, audio) -> list[list[DecodeResult]]:
        if not isinstance(audio, torch.Tensor):
            audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        out = self.decode_arrays(audio)
        results = []
        n_osd = out["osd_bits"].shape[1] if "osd_bits" in out else 0

        # Single-bit hill-climb polish: the fixed-width beam occasionally
        # commits an early trellis error and lands on a near-codeword (a
        # 1-2 message-bit miss that still unpacks, e.g. a wrong power
        # field).  The code is linear, so each message-bit flip XORs a
        # precomputed 162-bit pattern into the codeword; one [50,162]
        # matvec scores all flips and the climb takes the best until no
        # flip improves the LLR correlation.  At easy SNR this recovers
        # any 1-bit miss by construction (the true codeword correlates
        # strictly higher), at the cost of 4 matvecs per candidate.
        flip_pat = _code_matrices()[0].astype(np.float64)   # [50, 162]

        def polish(bits: np.ndarray, llr: np.ndarray) -> np.ndarray:
            best = np.asarray(bits, np.uint8).copy()
            coded_signs = 1.0 - 2.0 * conv_encode(best).astype(np.float64)
            for _ in range(4):
                # delta_i = -2 * sum_j pat[i,j] * coded_signs_j * llr_j
                d = -2.0 * (flip_pat @ (coded_signs * llr))
                i = int(np.argmax(d))
                if d[i] <= 1e-12:
                    break
                best[i] ^= 1
                coded_signs = 1.0 - 2.0 * conv_encode(best).astype(np.float64)
            return best

        def accept(score: float, llr: np.ndarray, coded: np.ndarray) -> bool:
            # Validation gates (WSPR has no CRC; wsprd gates on sync +
            # unpack sanity).  Two-tier boundary, recalibrated on the
            # round-5 demod (frequency-residual correction + 4-symbol
            # coherence changed both signal and noise statistics): 6144
            # POLISHED noise beam/OSD candidates over 192 noise windows
            # never exceed sync score 0.221, never reach agree >= 0.90
            # with nhard <= 30 in the same fit (the joint gate is what
            # buys the margin — noise trades agreement against hard
            # errors, true decodes don't).  True decodes at -31 dB:
            # agree med 0.91, score 0.17-0.29.  The old gates (agree
            # 0.925 / score 0.23) were rejecting half the -31 dB misses
            # WITH the true bits already decoded.
            x = (1.0 - 2.0 * coded.astype(np.float32)) * llr
            agree = float(np.sum(np.where(x > 0, np.abs(llr), 0.0))
                          / (np.sum(np.abs(llr)) + 1e-30))
            nhard = int(np.sum(x < 0))
            tier1 = score >= 0.225 and agree >= 0.85 and nhard <= 40
            tier2 = score >= 0.16 and agree >= 0.90 and nhard <= 30
            return tier1 or tier2

        for wi in range(audio.shape[0]):
            seen: dict[str, DecodeResult] = {}
            for k in range(self.cfg.top_k):
                cand_bits = [out["bits"][wi, k]]
                if k < n_osd:
                    # OSD fallback bits (wsprd -o analogue)
                    cand_bits.append(out["osd_bits"][wi, k])
                score = float(out["score"][wi, k])
                llr = out["llr"][wi, k].reshape(162)
                r = None
                for bits in cand_bits:
                    bits = polish(bits, llr)
                    try:
                        call, grid, dbm = unpack_message(bits)
                    except ValueError:
                        continue
                    if accept(score, llr, conv_encode(bits)):
                        r = (bits, call, grid, dbm)
                        break
                if r is None:
                    continue
                bits, call, grid, dbm = r
                text = f"{call} {grid} {dbm}"
                dt = out["t0_hop"][wi, k] * HOP / WAVE_SR - SIGNAL_START_S
                r = DecodeResult(
                    message=text,
                    snr_db=round(float(out["snr"][wi, k]), 1),
                    dt_s=round(float(dt), 2),
                    freq_hz=round(float(out["f0_bin"][wi, k] * BIN_HZ), 2),
                    score=float(out["score"][wi, k]),
                    mode=Mode.WSPR,
                    payload_bits=bits.copy(),
                    drift_hz=float(self.cfg.drifts_hz[out["drift_idx"][wi, k]]),
                )
                prev = seen.get(call)
                if prev is None or r.score > prev.score:
                    seen[call] = r
            # frequency-proximity suppression: sync sidelobes of a strong
            # burst can support a junk beam fit at a nearby (t0, f0); two
            # real WSPR signals closer than ~4 Hz cannot both decode anyway
            # (the 4-FSK occupies ~6 Hz), so keep only the best per cluster
            accepted: list[DecodeResult] = []
            for r in sorted(seen.values(), key=lambda r: -r.score):
                if any(abs(r.freq_hz - a.freq_hz) < 4.0 for a in accepted):
                    continue
                accepted.append(r)
            results.append(accepted)
        return results
