"""JT65: 65-tone FSK, 60 s T/R, RS(63,12) over GF(64).

The reference invokes ``jt9 -6`` (source/DecoderPool.hpp:648) and parses its
output at source/OutputHandler.cpp:623-695.  Protocol-exact pieces of the
published JT65A format (K1JT, "The JT65 Communications Protocol", QEX 2005),
adapted to the 12 kHz pipeline:

  - 126 symbol intervals x 4464 samples (0.372 s) = 46.9 s in the 60 s slot;
  - sync intervals transmit the sync tone (tone 0), the remaining 63
    intervals carry one GF(64) data symbol each on tone ``2 + graycode(v)``
    (data tones start two tone steps above sync);
  - source encoding: the legacy 72-bit payload [nc1:28][nc2:28][ng:16] with
    packcall/packgrid/free-text exactly as WSJT's packmsg (legacy72.py);
  - channel coding: RS(63,12) with the Karn codec parameters
    (GF(2^6)/0x43, fcr=3, prim=1), interleave63 (7x9 transpose), and
    binary-reflected Gray coding of each 6-bit symbol.

The 126-chip pseudo-random sync vector below is the published one from
K1JT's QEX 2005 protocol description (WSJT ``lib/jt65`` npr; also
reproduced verbatim in many independent open-source JT65 encoders).
Verified structural invariants before embedding: exactly 126 chips and
exactly 63 ones (the 63 remaining slots carry the RS(63,12) channel
symbols) — the same reconstruct-then-verify discipline used for the FT8
LDPC table (modes/tables.py).  A user-supplied
``CWSL_DIGI_TPU_TABLES_DIR/jt65_sync.txt`` (modes/tables_ext.py) still
overrides it, so a bit-exact copy from a WSJT-X source tree can be
dropped in to cross-check with no code change.
"""

from __future__ import annotations

import numpy as np

from cwsl_digi_tpu_torch.constants import Mode, WAVE_SR
from cwsl_digi_tpu_torch.modes import legacy72
from cwsl_digi_tpu_torch.modes.base import DecodeResult  # noqa: F401 (re-export)
from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate
from cwsl_digi_tpu_torch.modes.qary_engine import QaryDecoder, QarySpec
from cwsl_digi_tpu_torch.modes.rs64 import RS63

NSYM = 126
SPS = 4464
T_R = 60.0
TONE_SPACING = WAVE_SR / SPS          # 2.688 Hz
N_DATA = 63
TONE_OFFSET = 2                       # data value 0 -> 2 tone steps above sync


# Published JT65 pseudo-random sync vector (K1JT, QEX 2005; WSJT
# lib/jt65 npr).  1 = sync chip (sync tone), 0 = data slot.
_PUBLISHED_SYNC = np.asarray([
    1, 0, 0, 1, 1, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 1, 0, 1, 0, 0,
    0, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 1,
    0, 1, 1, 0, 1, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 0, 1, 0, 1, 1,
    0, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1,
    1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1,
    0, 1, 0, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 1,
    1, 1, 1, 1, 1, 1], np.int32)
assert _PUBLISHED_SYNC.size == NSYM and int(_PUBLISHED_SYNC.sum()) == 63


def _sync_vector() -> np.ndarray:
    """A user-supplied vector (modes/tables_ext.py — validated: 126 chips,
    exactly 63 ones) overrides the embedded published one."""
    from cwsl_digi_tpu_torch.modes import tables_ext

    ext = tables_ext.jt65_sync()
    return ext if ext is not None else _PUBLISHED_SYNC


SYNC = _sync_vector()
# provenance, not aspiration: False when a user override differs from the
# embedded published vector (advisor round 3)
SYNC_IS_PUBLISHED = bool(np.array_equal(SYNC, _PUBLISHED_SYNC))
SYNC_SYMS = tuple(int(i) for i in np.nonzero(SYNC)[0])
DATA_SYMS = tuple(int(i) for i in np.nonzero(1 - SYNC)[0])
assert len(DATA_SYMS) == N_DATA

# interleave63: the 63 channel symbols fill a Fortran 7x9 array d(0:6,0:8)
# in storage order and are read out transposed (WSJT lib interleave63.f90).
# ILV[s] = transmitted data-slot index of codeword symbol s.
ILV = np.asarray([(s % 7) * 9 + s // 7 for s in range(N_DATA)], np.int64)

# binary-reflected Gray code over 6 bits and its inverse
GRAY = np.asarray([v ^ (v >> 1) for v in range(64)], np.int64)
UNGRAY = np.zeros(64, np.int64)
UNGRAY[GRAY] = np.arange(64)

SPEC = QarySpec(
    name="JT65",
    n_sym=NSYM,
    sps=SPS,
    n_tones=64,
    tone_offset=TONE_OFFSET,
    sync_syms=SYNC_SYMS,
    data_syms=DATA_SYMS,
    trperiod=T_R,
    signal_start_s=1.0,
    fmin_hz=400.0,
    fmax_hz=2000.0,
    snr_offset_db=-1.5,  # calibrated vs injected SNR (tools/snr_check.py)
    top_k=24,
    max_hops=128,
    pad_hops=64,
)

# Karn codec parameters used by the jt9 chain: fcr=3 (roots alpha^3..53)
_RS = RS63(12, fcr=3)


# ---------------------------------------------------------------------------
# 72-bit legacy message codec -> 12 GF(64) symbols
# ---------------------------------------------------------------------------

def pack_message(text: str) -> np.ndarray:
    """Message text -> 12 GF(64) info symbols (MSB-first 6-bit groups of
    the 72-bit [nc1|nc2|ng] payload)."""
    nc1, nc2, ng = legacy72.pack72(text)
    v = (((nc1 << 28) | nc2) << 16) | ng
    syms = [(v >> (6 * (11 - i))) & 63 for i in range(12)]
    return np.asarray(syms, np.int64)


def unpack_message(symbols: np.ndarray) -> str | None:
    v = 0
    for s in symbols:
        v = (v << 6) | int(s)
    ng = v & 0xFFFF
    nc2 = (v >> 16) & 0xFFFFFFF
    nc1 = (v >> 44) & 0xFFFFFFF
    return legacy72.unpack72(nc1, nc2, ng)


def encode_message(text: str) -> np.ndarray:
    """text -> 126 tone indices (0 = sync tone; data at 2+gray(value))."""
    cw = _RS.encode(pack_message(text))
    channel = np.zeros(N_DATA, np.int64)
    channel[ILV] = GRAY[cw]
    tones = np.zeros(NSYM, np.int32)
    tones[list(DATA_SYMS)] = TONE_OFFSET + channel.astype(np.int32)
    return tones


def synthesize(text: str, f0_hz: float = 1270.5, amplitude: float = 1.0,
               window_len: int = int(T_R * WAVE_SR),
               start_s: float = 1.0) -> np.ndarray:
    from cwsl_digi_tpu_torch.modes.gfsk import place_burst

    burst = gfsk_modulate(encode_message(text), f0_hz, SPS, WAVE_SR,
                          TONE_SPACING, bt=2.0)
    return place_burst(burst, window_len, start_s, amplitude)


class JT65Decoder(QaryDecoder):
    mode = Mode.JT65

    def __init__(self, top_k: int | None = None,
                 fmax_hz: float | None = None, device=None):
        import dataclasses as _dc

        spec = SPEC
        if top_k or fmax_hz:
            # fmax_hz ≙ jt9 -H highestdecodefreq (DecoderPool.hpp:636-651)
            spec = _dc.replace(SPEC, top_k=top_k or SPEC.top_k,
                               fmax_hz=fmax_hz or SPEC.fmax_hz)
        super().__init__(spec, _RS, Mode.JT65,
                         unpack=lambda info: unpack_message(info),
                         symbol_perm=ILV, value_demap=UNGRAY, device=device)
