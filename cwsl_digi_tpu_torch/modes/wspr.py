"""WSPR protocol host code: the port's copy of the host part of
``cwsl_digi_tpu/modes/wspr.py``.

Physical layer (public WSPR parameters): 162 symbols x 8192 samples at
12 kHz, 4-FSK with ``tone = sync_bit + 2*data_bit``; 50 message bits
(28-bit callsign, 15-bit grid, 7-bit power) plus 31 zero tail bits,
convolutionally encoded at rate 1/2 with the K=32 Layland-Lushbaugh
polynomials and interleaved by 8-bit bit reversal.

Only the protocol constants, the interleaver, the convolutional encoder,
its block-code matrices, the message codec and the synthesizer are here:
FST4W carries the WSPR message payload (``modes/fst4.py``).  The decode
program (``_decode_program``), the beam search (``_beam_decode``) and
``WSPRDecoder`` arrive with the WSPR slice.
"""

from __future__ import annotations

import functools

import numpy as np

from cwsl_digi_tpu_torch.constants import WAVE_SR
from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate

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
