"""Q65-30: 65-tone FSK, 30 s T/R, (63,13) block code over GF(64).

The reference invokes ``jt9 -3 -p 30`` (source/DecoderPool.hpp:645-647,
params at :478-489) and parses output at source/OutputHandler.cpp:697-779.

Native structure (Q65-30A-like parameters): 85 symbol intervals x 3600
samples (0.3 s) = 25.5 s in the 30 s slot; 22 sync intervals at tone 0,
63 data intervals carrying one GF(64) symbol on tone ``1 + value``.
The 13 info symbols (78 bits) carry the standard 77-bit payload
(message77.py) plus one pad bit, so the whole FT8 message grammar is
available.

Protocol-exact pieces: the 85-symbol frame with the published 22-position
sync pattern (q65.f90 isync), tone layout (sync at tone 0, data at
1+value), and the 77-bit payload codec.

Interop caveat (documented): the real Q65 inner code is QRA(63,13) — a
q-ary repeat-accumulate code whose exact sparse matrix (IV3NWV's
qracodes) could not be reproduced from memory in this zero-egress
environment; this build uses a same-profile sparse GF(64) code
(modes/qra.py) with the same message-passing decoder structure.

Algorithmic reconstruction was attempted and is NOT possible offline:
the published qracodes tables (WSJT-X lib/qra/q65, qra13_64_64_irr_e23)
are the *output* of IV3NWV's randomized irregular-RA design search
(degree profile + random GF(64) edge weights + accumulator permutation,
selected offline for girth/threshold), and only the resulting arrays are
published — there is no deterministic generator to re-run.  The remedy
is the table-driven path: supply the published dense H at runtime via
``CWSL_DIGI_TPU_TABLES_DIR/q65_qra_63_13.txt`` (modes/tables_ext.py;
format in README "Supplying published tables") and encode, decode, and
subtraction all use it with no code change
(tests/test_tables_ext.py proves the full flow with a foreign table).
"""

from __future__ import annotations

import functools

import numpy as np

from cwsl_digi_tpu_torch.constants import Mode, WAVE_SR
from cwsl_digi_tpu_torch.device import as_device
from cwsl_digi_tpu_torch.modes import message77
from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate
from cwsl_digi_tpu_torch.modes.qary_engine import QaryDecoder, QarySpec
from cwsl_digi_tpu_torch.modes.qra import QaryMPDecoder, build_qra_code

NSYM = 85
SPS = 3600
T_R = 30.0
TONE_SPACING = WAVE_SR / SPS          # 3.333 Hz
N_DATA = 63
TONE_OFFSET = 1


# The published Q65 sync pattern: 22 sync symbols in the 85-symbol frame
# (WSJT-X lib/qra/q65/q65.f90 ``isync`` table, 1-based:
# 1,9,12,13,15,22,23,26,27,33,35,38,46,50,55,60,62,66,69,74,76,85).
SYNC_SYMS = tuple(s - 1 for s in
                  (1, 9, 12, 13, 15, 22, 23, 26, 27, 33, 35,
                   38, 46, 50, 55, 60, 62, 66, 69, 74, 76, 85))
DATA_SYMS = tuple(i for i in range(NSYM) if i not in set(SYNC_SYMS))
assert len(DATA_SYMS) == N_DATA

SPEC = QarySpec(
    name="Q65-30",
    n_sym=NSYM,
    sps=SPS,
    n_tones=64,
    tone_offset=TONE_OFFSET,
    sync_syms=SYNC_SYMS,
    data_syms=DATA_SYMS,
    trperiod=T_R,
    signal_start_s=0.5,
    fmin_hz=400.0,
    fmax_hz=2200.0,
    snr_offset_db=-1.6,  # calibrated vs injected SNR (tools/snr_check.py)
    top_k=24,
    max_hops=128,
    pad_hops=64,
    full_e=True,
)

# info-column weight 4 + 60 iterations measured best on the synthetic
# noncoherent 64-FSK channel (tools: /tmp profile sweep; 50% @ Es/N0 4.1 dB)
def _make_code():
    """Published QRA(63,13) when supplied (tables_ext.q65_qra), else the
    documented same-profile stand-in."""
    from cwsl_digi_tpu_torch.modes import tables_ext
    from cwsl_digi_tpu_torch.modes.qra import code_from_dense

    h = tables_ext.q65_qra()
    if h is not None:
        return code_from_dense(h, 13)
    return build_qra_code(63, 13, info_w=4)


_CODE = _make_code()


@functools.lru_cache(maxsize=None)
def _mp(device) -> QaryMPDecoder:
    return QaryMPDecoder(_CODE, iters=60, device=device)


def pack_message(text: str) -> np.ndarray:
    bits77 = message77.pack77(text)
    bits78 = np.concatenate([bits77, np.zeros(1, np.uint8)])
    return np.asarray(
        [message77.int_from_bits(bits78[6 * i : 6 * i + 6]) for i in range(13)],
        np.int64,
    )


def unpack_message(symbols: np.ndarray) -> str | None:
    bits = []
    for s in symbols:
        bits.extend(message77.bits_from_int(int(s), 6))
    try:
        msg = message77.unpack77(np.asarray(bits[:77], np.uint8))
    except (IndexError, ValueError, AssertionError):
        return None
    if msg.text.startswith("<unsupported"):
        return None
    return msg.text


def encode_message(text: str) -> np.ndarray:
    cw = _CODE.encode(pack_message(text))
    tones = np.zeros(NSYM, np.int32)
    tones[list(DATA_SYMS)] = TONE_OFFSET + cw.astype(np.int32)
    return tones


def synthesize(text: str, f0_hz: float = 1000.0, amplitude: float = 1.0,
               window_len: int = int(T_R * WAVE_SR),
               start_s: float = 0.5) -> np.ndarray:
    from cwsl_digi_tpu_torch.modes.gfsk import place_burst

    burst = gfsk_modulate(encode_message(text), f0_hz, SPS, WAVE_SR,
                          TONE_SPACING, bt=2.0)
    return place_burst(burst, window_len, start_s, amplitude)


class Q65Decoder(QaryDecoder):
    mode = Mode.Q65_30

    def __init__(self, top_k: int | None = None,
                 fmax_hz: float | None = None, device=None):
        import dataclasses as _dc

        spec = SPEC
        if top_k or fmax_hz:
            # fmax_hz ≙ jt9 -H highestdecodefreq (DecoderPool.hpp:636-651)
            spec = _dc.replace(SPEC, top_k=top_k or SPEC.top_k,
                               fmax_hz=fmax_hz or SPEC.fmax_hz)
        super().__init__(spec, None, Mode.Q65_30,
                         unpack=lambda info: unpack_message(info),
                         mp=_mp(as_device(device)), device=device)
