"""FT8: 8-GFSK, 79 symbols, LDPC(174,91)+CRC14 — batched PyTorch decoder.

Counterpart of ``cwsl_digi_tpu/modes/ft8.py``.  Protocol structure (public
FT8 parameters): 79 symbols of 1920 samples at 12 kHz (6.25 baud, tone
spacing 6.25 Hz, BT 2.0); 7x7 Costas arrays at symbol offsets 0, 36, 72;
58 data symbols carry the 174 codeword bits, 3 per symbol, Gray-mapped.
Message packing, CRC and GFSK synthesis are the port's copies of the
reference's host modules.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cwsl_digi_tpu_torch.constants import Mode, WAVE_SR
from cwsl_digi_tpu_torch.modes import message77
from cwsl_digi_tpu_torch.modes.base import DecodeResult
from cwsl_digi_tpu_torch.modes.crc import ft8_crc, ft8_crc_matrix
from cwsl_digi_tpu_torch.modes.gfsk import gfsk_modulate, place_burst
from cwsl_digi_tpu_torch.modes.gfsk_engine import GFSKDecoder, ModeSpec
from cwsl_digi_tpu_torch.modes.ldpc import BPDecoder, ft8_code

COSTAS = np.array([3, 1, 4, 0, 6, 5, 2], dtype=np.int32)
GRAY = np.array([0, 1, 3, 2, 5, 6, 4, 7], dtype=np.int32)      # 3 bits -> tone
NSYM = 79
SPS = 1920                  # samples/symbol @ 12 kHz
BAUD = WAVE_SR / SPS        # 6.25
TONE_SPACING = BAUD         # Hz
NUM_TONES = 8
T_R = 15.0
SIGNAL_START_S = 0.5

_sync_cells = tuple((off + i, int(t)) for off in (0, 36, 72)
                    for i, t in enumerate(COSTAS))
DATA_SYM = tuple(s for s in range(NSYM)
                 if not (s < 7 or 36 <= s < 43 or s >= 72))

SPEC = ModeSpec(
    name="FT8",
    n_sym=NSYM,
    sps=SPS,
    n_tones=NUM_TONES,
    bits_per_sym=3,
    sync_cells=_sync_cells,
    data_syms=DATA_SYM,
    gray_map=tuple(GRAY.tolist()),
    trperiod=T_R,
    signal_start_s=SIGNAL_START_S,
    top_k=512,
    bp_iters=30,
    max_hops=256,
    pad_hops=128,
    os_t=8,
    os_f=4,
    refine=True,
)


def encode_payload(payload77: np.ndarray) -> np.ndarray:
    """payload 77 bits -> 79 tone indices."""
    payload77 = np.asarray(payload77, np.uint8)
    info91 = np.concatenate([payload77, ft8_crc(payload77)])
    return SPEC.tones_from_codeword(ft8_code().encode(info91))


def encode_message(text: str) -> np.ndarray:
    return encode_payload(message77.pack77(text))


def synthesize(text: str, f0_hz: float = 1500.0, amplitude: float = 1.0,
               window_len: int = int(T_R * WAVE_SR),
               start_s: float = SIGNAL_START_S) -> np.ndarray:
    """Full 15 s window containing one FT8 burst (no noise)."""
    burst = gfsk_modulate(encode_message(text), f0_hz, SPS, WAVE_SR,
                          TONE_SPACING, bt=2.0)
    return place_burst(burst, window_len, start_s, amplitude)


def ap_hypotheses(my_call: str = "", dx_call: str = "") -> np.ndarray:
    """A-priori hypotheses [H, 77]: -1 = bit unknown, 0/1 = forced.  Row 0
    is "no AP"; then "CQ ...", and "MYCALL ..." / "MYCALL DXCALL ..." when
    configured (reference AP flags, source/DecoderPool.hpp:466-469)."""
    rows = [np.full(77, -1, np.int8)]

    def with_c28a(c28: int):
        h = np.full(77, -1, np.int8)
        h[0:28] = message77.bits_from_int(c28, 28)
        h[28] = 0                      # r1a
        h[74:77] = [0, 0, 1]           # i3 = 1 (standard message)
        return h

    rows.append(with_c28a(message77.pack_call28("CQ")))
    if my_call:
        try:
            rows.append(with_c28a(message77.pack_call28(my_call)))
            if dx_call:
                h = with_c28a(message77.pack_call28(my_call))
                h[29:57] = message77.bits_from_int(
                    message77.pack_call28(dx_call), 28)
                h[57] = 0
                rows.append(h)
        except ValueError:
            pass
    return np.stack(rows)


class FT8Decoder(GFSKDecoder):
    """Batched windows in, DecodeResult lists out; tables on ``device``."""

    def __init__(self, top_k: int | None = None, bp_iters: int | None = None,
                 spec: ModeSpec | None = None,
                 ap: np.ndarray | bool | None = None,
                 my_call: str = "", depth: int | None = None,
                 fmax_hz: float | None = None,
                 device: torch.device | str | None = None):
        s = spec or SPEC
        if top_k or bp_iters or depth or fmax_hz:
            s = dataclasses.replace(s, top_k=top_k or s.top_k,
                                    bp_iters=bp_iters or s.bp_iters,
                                    depth=depth or s.depth,
                                    fmax_hz=fmax_hz or s.fmax_hz)
        if ap is True or (ap is None and my_call):
            ap = ap_hypotheses(my_call)
        elif ap is False:
            ap = None
        super().__init__(
            s,
            BPDecoder(ft8_code(), iters=s.bp_iters, device=device),
            ft8_crc_matrix(),
            Mode.FT8,
            unpack=lambda bits: message77.unpack77(bits[:77]).text,
            ap_hypotheses=ap if isinstance(ap, np.ndarray) else None,
            device=device,
        )


def results_from_arrays(out: dict[str, np.ndarray], mode: Mode = Mode.FT8,
                        spec: ModeSpec = SPEC) -> list[list[DecodeResult]]:
    """Validated candidate arrays -> deduped DecodeResult lists (host)."""
    n_windows, top_k = out["valid"].shape
    results: list[list[DecodeResult]] = []
    for wi in range(n_windows):
        seen: dict[bytes, DecodeResult] = {}
        for k in range(top_k):
            if not out["valid"][wi, k]:
                continue
            payload = np.asarray(out["payload"][wi, k, :77])
            key = np.packbits(payload).tobytes()
            dt = out["t0_hop"][wi, k] * spec.hop / WAVE_SR - spec.signal_start_s
            freq = out["f0_bin"][wi, k] * spec.bin_hz
            r = DecodeResult(
                message=message77.unpack77(payload).text,
                snr_db=round(float(out["snr"][wi, k]), 1),
                dt_s=round(float(dt), 2),
                freq_hz=round(float(freq), 1),
                score=float(out["score"][wi, k]),
                mode=mode,
                payload_bits=payload.copy(),
            )
            prev = seen.get(key)
            if prev is None or r.score > prev.score:
                seen[key] = r
        results.append(sorted(seen.values(), key=lambda r: -r.score))
    return results
