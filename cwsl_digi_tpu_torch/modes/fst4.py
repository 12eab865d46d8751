"""FST4 / FST4W: 4-GFSK slow modes, LDPC(240,101), T/R 60-1800 s —
batched PyTorch decoder.

Counterpart of ``cwsl_digi_tpu/modes/fst4.py``, whose protocol code this
module repeats: the published 160-symbol frame (five 8-symbol blocks of
the sync word (0,1,3,2,1,0,2,3) at symbols 0, 38, 76, 114, 152; 120 data
symbols carry the 240 codeword bits, 2 per Gray-mapped symbol);
LDPC(240,101) with 77 payload + 24 CRC bits (poly 0x864CFB); symbol
lengths 3888/8200/21504/66560/134400 samples for 60/120/300/900/1800 s.
FST4 carries the 77-bit message payload, FST4W the WSPR-style beacon
payload [call|grid|power] (``modes/wspr.py``).

Each period is one ModeSpec on the shared GFSK engine, without the
half-hop refinement but with the sync-pair frequency correction and the
4-symbol coherent metrics; the 300-1800 s periods' DFT matrices exceed
``GFSKDecoder.DFT_MAT_BYTES_MAX``, so their spectrograms are rffts.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import Mode, WAVE_SR
from cwsl_digi_tpu_torch.modes import message77, wspr
from cwsl_digi_tpu_torch.modes.crc import crc_remainder
from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate
from cwsl_digi_tpu_torch.modes.gfsk_engine import GFSKDecoder, ModeSpec
from cwsl_digi_tpu_torch.modes.ldpc import BPDecoder, fst4_code

NSYM = 160
GRAY4 = (0, 1, 3, 2)
CRC24_POLY = 0x864CFB
CRC_BITS = 24
PAYLOAD_BITS = 77

# the single published 8-symbol sync word, repeated in all five blocks
SYNC_WORD = (0, 1, 3, 2, 1, 0, 2, 3)
SYNC_SEQS = tuple((off, SYNC_WORD) for off in (0, 38, 76, 114, 152))
_sync_cells = tuple(
    (off + i, t) for off, seq in SYNC_SEQS for i, t in enumerate(seq)
)
_sync_syms = {s for s, _ in _sync_cells}
DATA_SYMS = tuple(s for s in range(NSYM) if s not in _sync_syms)
assert len(DATA_SYMS) == 120

# samples/symbol per T/R period (WSJT-X FST4 NSPS table)
SPS_BY_PERIOD = {60: 3888, 120: 8200, 300: 21504, 900: 66560, 1800: 134400}

_FST4_MODES = {
    Mode.FST4_60: (60, False), Mode.FST4_120: (120, False),
    Mode.FST4_300: (300, False), Mode.FST4_900: (900, False),
    Mode.FST4_1800: (1800, False),
    Mode.FST4W_120: (120, True), Mode.FST4W_300: (300, True),
    Mode.FST4W_900: (900, True), Mode.FST4W_1800: (1800, True),
}


def fst4_crc(payload77: np.ndarray) -> np.ndarray:
    """24-bit CRC over the payload padded to 82 bits."""
    payload77 = np.asarray(payload77, np.uint8)
    msg = np.concatenate([payload77, np.zeros(5, np.uint8)])
    return crc_remainder(msg, poly=CRC24_POLY, crc_bits=CRC_BITS)


@functools.lru_cache(maxsize=1)
def fst4_crc_matrix() -> np.ndarray:
    m = np.zeros((PAYLOAD_BITS, CRC_BITS), np.uint8)
    for i in range(PAYLOAD_BITS):
        e = np.zeros(PAYLOAD_BITS, np.uint8)
        e[i] = 1
        m[i] = fst4_crc(e)
    return m


@functools.lru_cache(maxsize=None)
def make_spec(mode: Mode) -> ModeSpec:
    period, is_w = _FST4_MODES[mode]
    sps = SPS_BY_PERIOD[period]
    # reference band limits: FST4W 1400-1600 Hz (nfqso=1500, file path
    # "-L 1400 -H 1600", source/DecoderPool.hpp:536-567,1031-1034);
    # FST4 900-1100 Hz (300 s: 700-1100) (source/DecoderPool.hpp:490-534).
    if is_w:
        fmin, fmax = 1400.0, 1600.0
    elif period == 300:
        fmin, fmax = 700.0, 1100.0
    elif period >= 60:
        fmin, fmax = 900.0, 1100.0
    else:
        fmin, fmax = 300.0, 2400.0
    # candidate grid: 60/120 s periods see real dt spreads past +1.3 s
    # (windows are rare, the fine grid is cheap), very long symbols keep
    # a small grid
    max_hops = 96 if period <= 120 else 32
    pad_hops = 48 if period <= 120 else 16
    # The slow modes decode rarely (one window per 1-30 min), so they can
    # afford a much finer search than FT8: 8x time / 4x freq oversampling
    # halves the worst-case sub-bin frequency error (+-1/8 tone spacing),
    # which is what limits the coherent multi-symbol combining for these
    # long symbols (inter-symbol phase error ~ 2*pi*df*T_sym).  900/1800 s
    # keep the coarse grid — their bins are already <0.1 Hz and the frames
    # get enormous.
    fine = period <= 300
    return ModeSpec(
        name=str(mode.value),
        n_sym=NSYM,
        sps=sps,
        n_tones=4,
        bits_per_sym=2,
        sync_cells=_sync_cells,
        data_syms=DATA_SYMS,
        gray_map=GRAY4,
        trperiod=float(period),
        signal_start_s=1.0,
        fmin_hz=fmin,
        fmax_hz=fmax,
        top_k=48 if fine else 32,
        bp_iters=60,
        snr_offset_db=0.6,   # calibrated vs injected SNR (tools/snr_check.py)
        max_hops=max_hops,
        pad_hops=pad_hops,
        os_t=8 if fine else 4,
        os_f=4 if fine else 2,
        osd_j=24,
        bt=1.0,
        # sync-pair frequency-residual correction: the slow bauds lose
        # ~0.8 rad/symbol of coherence to the +-bin/2 grid residual
        # (see ModeSpec.refine_freq); measured FST4W-120 below
        refine_freq=True,
        # 4-symbol coherent windows: T^4 = 256 combos at 4-FSK (cheap);
        # the long-symbol modes are exactly where longer coherence pays
        coh4=True,
    )


# ---------------------------------------------------------------------------
# Payload codecs
# ---------------------------------------------------------------------------

def pack_payload(text: str, is_w: bool) -> np.ndarray:
    if not is_w:
        return message77.pack77(text)
    # FST4W: "CALL GRID PWR" beacon payload
    parts = text.split()
    if len(parts) != 3:
        raise ValueError(f"FST4W message must be 'CALL GRID dBm': {text!r}")
    bits50 = wspr.pack_message(parts[0], parts[1], int(parts[2]))
    return np.concatenate([bits50, np.zeros(PAYLOAD_BITS - 50, np.uint8)])


def unpack_payload(bits77: np.ndarray, is_w: bool) -> str | None:
    if not is_w:
        return message77.unpack77(bits77).text
    try:
        call, grid, dbm = wspr.unpack_message(bits77[:50])
    except ValueError:
        return None
    if np.any(bits77[50:]):
        return None
    return f"{call} {grid} {dbm}"


def encode_message(text: str, mode: Mode) -> np.ndarray:
    period, is_w = _FST4_MODES[mode]
    payload = pack_payload(text, is_w)
    info = np.concatenate([payload, fst4_crc(payload)])
    codeword = fst4_code().encode(info)
    return make_spec(mode).tones_from_codeword(codeword)


def synthesize(text: str, mode: Mode, f0_hz: float = 1000.0,
               amplitude: float = 1.0, start_s: float = 1.0,
               window_len: int | None = None) -> np.ndarray:
    from cwsl_digi_tpu_torch.modes.gfsk import place_burst

    spec = make_spec(mode)
    burst = gfsk_modulate(encode_message(text, mode), f0_hz, spec.sps,
                          WAVE_SR, spec.tone_spacing, bt=1.0)
    if window_len is None:
        window_len = int(spec.trperiod * WAVE_SR)
    return place_burst(burst, window_len, start_s, amplitude)


class FST4Decoder(GFSKDecoder):
    """One decoder per FST4/FST4W variant; tables on ``device``."""

    def __init__(self, mode: Mode | str, top_k: int | None = None,
                 bp_iters: int | None = None, fmax_hz: float | None = None,
                 device: torch.device | str | None = None):
        mode = Mode(mode)
        period, is_w = _FST4_MODES[mode]
        spec = make_spec(mode)
        # FST4W keeps its fixed 1400-1600 Hz band (jt9 -L 1400 -H 1600,
        # DecoderPool.hpp:655-658); -H applies only to the FST4 variants
        if is_w:
            fmax_hz = None
        if top_k or bp_iters or fmax_hz:
            spec = dataclasses.replace(spec, top_k=top_k or spec.top_k,
                                       bp_iters=bp_iters or spec.bp_iters,
                                       fmax_hz=fmax_hz or spec.fmax_hz)
        super().__init__(
            spec,
            BPDecoder(fst4_code(), iters=spec.bp_iters, device=device),
            fst4_crc_matrix(),
            mode,
            unpack=lambda bits: unpack_payload(bits[:PAYLOAD_BITS], is_w)
            or "<bad payload>",
            device=device,
        )
