"""FT4: 4-GFSK, 7.5 s T/R, LDPC(174,91)+CRC14 — batched PyTorch decoder.

Counterpart of ``cwsl_digi_tpu/modes/ft4.py``.  Physical layer (public
FT4 parameters): 105 symbols x 576 samples at 12 kHz (20.833 baud, tone
spacing = baud), 4-GFSK with Gray map [0,1,3,2]; four 4-symbol sync
sequences at symbol offsets 1, 34, 67, 100 after a leading ramp symbol;
87 data symbols carry the 174 codeword bits, 2 per symbol; the same
LDPC(174,91) + CRC-14 and 77-bit message payload as FT8.  It runs on the
shared GFSK engine's refine branch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import Mode, WAVE_SR
from cwsl_digi_tpu_torch.modes import message77
from cwsl_digi_tpu_torch.modes.crc import ft8_crc, ft8_crc_matrix
from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate, place_burst
from cwsl_digi_tpu_torch.modes.gfsk_engine import GFSKDecoder, ModeSpec
from cwsl_digi_tpu_torch.modes.ldpc import BPDecoder, ft8_code

SPS = 576
NSYM = 105
T_R = 7.5
GRAY = np.array([0, 1, 3, 2], dtype=np.int32)

# Four 4-symbol sync sequences after the leading ramp symbol; symbols 0 and
# 104 are ramp-only and carry neither sync nor data.
SYNC_SEQS = (
    (1, (0, 1, 3, 2)),
    (34, (1, 0, 2, 3)),
    (67, (2, 3, 1, 0)),
    (100, (3, 2, 0, 1)),
)
_sync_cells = tuple(
    (off + i, tone) for off, seq in SYNC_SEQS for i, tone in enumerate(seq)
)
_sync_syms = {s for s, _ in _sync_cells}
_RAMP_SYMS = (0, 104)
DATA_SYM = tuple(
    s for s in range(NSYM)
    if s not in _sync_syms and s not in _RAMP_SYMS
)

SPEC = ModeSpec(
    name="FT4",
    n_sym=NSYM,
    sps=SPS,
    n_tones=4,
    bits_per_sym=2,
    sync_cells=_sync_cells,
    data_syms=DATA_SYM,
    gray_map=tuple(GRAY.tolist()),
    trperiod=T_R,
    signal_start_s=0.5,
    top_k=192,
    bp_iters=30,
    snr_offset_db=-1.0,
    max_hops=320,     # dt search -0.77..+1.15 s (6 ms hops at os_t=8)
    pad_hops=128,
    os_t=8,
    os_f=4,
    refine=True,
    bt=1.0,
)


def encode_payload(payload77: np.ndarray) -> np.ndarray:
    """payload 77 bits -> 105 tone indices."""
    payload77 = np.asarray(payload77, np.uint8)
    info91 = np.concatenate([payload77, ft8_crc(payload77)])
    return SPEC.tones_from_codeword(ft8_code().encode(info91))


def encode_message(text: str) -> np.ndarray:
    return encode_payload(message77.pack77(text))


def synthesize(text: str, f0_hz: float = 1500.0, amplitude: float = 1.0,
               window_len: int = int(T_R * WAVE_SR),
               start_s: float = 0.5) -> np.ndarray:
    """Full 7.5 s window containing one FT4 burst (no noise)."""
    burst = gfsk_modulate(encode_message(text), f0_hz, SPS, WAVE_SR,
                          SPEC.tone_spacing, bt=1.0)
    return place_burst(burst, window_len, start_s, amplitude)


class FT4Decoder(GFSKDecoder):
    """Batched FT4 windows in, DecodeResult lists out; tables on
    ``device``.  ``fmax_hz`` is jt9's -H highest decode frequency."""

    def __init__(self, top_k: int | None = None, bp_iters: int | None = None,
                 depth: int | None = None, fmax_hz: float | None = None,
                 device: torch.device | str | None = None):
        spec = SPEC
        if top_k or bp_iters or depth or fmax_hz:
            spec = dataclasses.replace(SPEC, top_k=top_k or SPEC.top_k,
                                       bp_iters=bp_iters or SPEC.bp_iters,
                                       depth=depth or SPEC.depth,
                                       fmax_hz=fmax_hz or SPEC.fmax_hz)
        super().__init__(
            spec,
            BPDecoder(ft8_code(), iters=spec.bp_iters, device=device),
            ft8_crc_matrix(),
            Mode.FT4,
            unpack=lambda bits: message77.unpack77(bits[:77]).text,
            device=device,
        )
