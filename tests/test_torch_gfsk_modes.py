"""FT4, JS8, FST4 and FST4W in the port against the JAX package.

- Decode lists on the same seeded windows at a reduced top_k / BP budget
  (the reference's own test settings, ``tests/test_fst4_js8.py``): FT4,
  JS8, FST4-60 on its DFT branch and forced onto the rfft branch (a
  subclass with ``DFT_MAT_BYTES_MAX = 0`` on both sides), FST4W-120.  Each
  JAX reference decodes its windows unpadded (``max_device_batch`` = the
  window count).  Tolerances (``test_torch_parity.py``): the same messages
  per window, SNR within 0.5 dB, frequency within one bin and dt within
  one hop of the mode.
- The committed ``ft4_m15db``, ``js8_m18db`` and ``fst4_60_m23db``
  fixtures through the port's default decoders.
- The modes' protocol code (specs, codes, CRCs, encoders, the JS8 frame
  grammar and ``classify``) against the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cwsl_digi_tpu.modes import fst4 as jfst4
from cwsl_digi_tpu.modes import ft4 as jft4
from cwsl_digi_tpu.modes import js8 as jjs8
from cwsl_digi_tpu.modes import ldpc as jldpc
from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr
from cwsl_digi_tpu.utils.wav import read_wav
from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes import fst4, ft4, ft8, js8, jt65, ldpc, q65
from cwsl_digi_tpu_torch.modes import wspr
from cwsl_digi_tpu_torch.modes.base import get_decoder, warmup_window
from test_torch_parity import assert_same_batch_decodes

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
MANIFEST = {e["file"]: e for e in json.loads(
    (FIXTURES / "manifest.json").read_text())}


class _JaxRfft(jfst4.FST4Decoder):
    DFT_MAT_BYTES_MAX = 0


class _Rfft(fst4.FST4Decoder):
    DFT_MAT_BYTES_MAX = 0


def _noisy(clean: np.ndarray, snr_db: float, seed: int) -> np.ndarray:
    return add_noise_at_snr(clean, snr_db, 12_000,
                            np.random.default_rng(seed))


def _ft4_windows() -> np.ndarray:
    w0 = (jft4.synthesize("K1ABC W9XYZ EN37", 1200.0)
          + 0.5 * jft4.synthesize("CQ W2AXR FN13", 2000.0, start_s=0.3)
          + 0.3 * jft4.synthesize("G4ABC K1ABC RR73", 700.0, start_s=0.9))
    w1 = jft4.synthesize("CQ DL7ACA JO40", 1500.0, start_s=0.2)
    return np.stack([_noisy(w0, -8.0, 1), _noisy(w1, -14.0, 2)])


def _js8_windows() -> np.ndarray:
    w0 = (jjs8.synthesize("KN4CRD: HB EN50", 800.0)
          + 0.6 * jjs8.synthesize("HELLO WORLD", 1900.0, start_s=0.9))
    w1 = jjs8.synthesize("W2AXR: K1ABC SNR -12", 1300.0, start_s=0.2)
    return np.stack([_noisy(w0, -10.0, 3), _noisy(w1, -15.0, 4)])


def _fst4_60_window() -> np.ndarray:
    w = (jfst4.synthesize("K1ABC W9XYZ -15", jfst4.Mode.FST4_60, 1000.0)
         + 0.5 * jfst4.synthesize("CQ W2AXR FN13", jfst4.Mode.FST4_60,
                                  1060.0, start_s=1.3))
    return _noisy(w, -16.0, 5)[None]


def _fst4w_120_window() -> np.ndarray:
    w = jfst4.synthesize("W2AXR FN13 30", jfst4.Mode.FST4W_120, 1500.0)
    return _noisy(w, -20.0, 6)[None]


# name -> (windows, JAX decoder, port decoder, spec of the tolerances)
CASES = {
    "FT4": (_ft4_windows,
            lambda: jft4.FT4Decoder(top_k=64, bp_iters=25),
            lambda: ft4.FT4Decoder(top_k=64, bp_iters=25, device="cpu")),
    "JS8": (_js8_windows,
            lambda: jjs8.JS8Decoder(top_k=32, bp_iters=25),
            lambda: js8.JS8Decoder(top_k=32, bp_iters=25, device="cpu")),
    "FST4-60-dft": (
        _fst4_60_window,
        lambda: jfst4.FST4Decoder(jfst4.Mode.FST4_60, top_k=16, bp_iters=30),
        lambda: fst4.FST4Decoder(Mode.FST4_60, top_k=16, bp_iters=30,
                                 device="cpu")),
    "FST4-60-rfft": (
        _fst4_60_window,
        lambda: _JaxRfft(jfst4.Mode.FST4_60, top_k=16, bp_iters=30),
        lambda: _Rfft(Mode.FST4_60, top_k=16, bp_iters=30, device="cpu")),
    "FST4W-120": (
        _fst4w_120_window,
        lambda: jfst4.FST4Decoder(jfst4.Mode.FST4W_120, top_k=16,
                                  bp_iters=30),
        lambda: fst4.FST4Decoder(Mode.FST4W_120, top_k=16, bp_iters=30,
                                 device="cpu")),
}
BRANCH = {"FT4": "refine", "JS8": "refine", "FST4-60-dft": "dft",
          "FST4-60-rfft": "rfft", "FST4W-120": "dft"}
N_DECODES = {"FT4": 3, "JS8": 3, "FST4-60-dft": 2, "FST4-60-rfft": 2,
             "FST4W-120": 1}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_lists_match_jax(case):
    windows, make_ref, make_port = CASES[case]
    wins = windows()
    ref = make_ref()
    ref.max_device_batch = len(wins)
    want = ref.decode(wins)
    dec = make_port()
    assert dec.spectrogram_branch == BRANCH[case]
    assert dec.max_device_batch == make_ref().max_device_batch
    got = dec.decode(wins)
    assert sum(len(w) for w in want) >= N_DECODES[case]
    assert_same_batch_decodes(got, want, dec.spec)


@pytest.mark.parametrize("name", ["ft4_m15db.wav", "js8_m18db.wav",
                                  "fst4_60_m23db.wav"])
def test_fixture_decodes(name):
    entry = MANIFEST[name]
    audio, sr = read_wav(FIXTURES / name)
    assert sr == 12_000
    dec = get_decoder(entry["mode"], device="cpu")
    results = dec.decode(np.asarray(audio, np.float32)[None])[0]
    msgs = [r.message for r in results]
    assert entry["message"] in msgs, msgs
    r = next(r for r in results if r.message == entry["message"])
    assert abs(r.freq_hz - entry["f0_hz"]) < 3.0
    assert abs(r.snr_db - entry["snr_db"]) < 4.0


def test_js8_does_not_decode_ft8():
    """JS8 shares FT8's Costas sync; its own LDPC/CRC keeps an FT8 burst
    from decoding as JS8 (the counterpart of the reference's
    ``test_js8_decode_and_ft8_isolation``)."""
    audio = _noisy(ft8.synthesize("CQ W2AXR FN13", 1500.0), 10.0, 3)
    dec = js8.JS8Decoder(top_k=32, bp_iters=25, device="cpu")
    assert dec.decode(audio[None])[0] == []
    own = dec.decode(js8.synthesize("HELLO WORLD", 1500.0)[None])[0]
    assert [r.message for r in own] == ["HELLO WORLD"]


@pytest.mark.parametrize("mode", list(Mode))
def test_specs_and_encoders_match_jax(mode):
    """Every mode's spec (WSPR: its decoder config), encoder and code
    tables equal the JAX package's; the warm-up window is the
    reference's."""
    from cwsl_digi_tpu.modes import base as jbase
    from cwsl_digi_tpu.modes import ft8 as jft8
    from cwsl_digi_tpu.modes import jt65 as jjt65
    from cwsl_digi_tpu.modes import q65 as jq65
    from cwsl_digi_tpu.modes import wspr as jwspr

    jmode = jfst4.Mode(mode.value)
    if mode == Mode.WSPR:
        pspec, jspec = wspr.WSPRConfig(), jwspr.WSPRConfig()
        np.testing.assert_array_equal(wspr.encode("W2AXR", "FN13", 30),
                                      jwspr.encode("W2AXR", "FN13", 30))
    elif mode in (Mode.JT65, Mode.Q65_30):
        pmod, jmod = {Mode.JT65: (jt65, jjt65),
                      Mode.Q65_30: (q65, jq65)}[mode]
        pspec, jspec = pmod.SPEC, jmod.SPEC
        np.testing.assert_array_equal(pmod.encode_message("CQ W2AXR FN13"),
                                      jmod.encode_message("CQ W2AXR FN13"))
    elif mode in (Mode.FT8, Mode.FT4, Mode.JS8):
        pmod, jmod = {Mode.FT8: (ft8, jft8), Mode.FT4: (ft4, jft4),
                      Mode.JS8: (js8, jjs8)}[mode]
        pspec, jspec = pmod.SPEC, jmod.SPEC
        text = "KN4CRD: HB EN50" if mode == Mode.JS8 else "CQ W2AXR FN13"
        np.testing.assert_array_equal(pmod.encode_message(text),
                                      jmod.encode_message(text))
    else:
        pspec, jspec = fst4.make_spec(mode), jfst4.make_spec(jmode)
        text = ("W2AXR FN13 30" if "FST4W" in mode.value
                else "CQ W2AXR FN13")
        np.testing.assert_array_equal(fst4.encode_message(text, mode),
                                      jfst4.encode_message(text, jmode))
    assert dataclasses.asdict(pspec) == dataclasses.asdict(jspec)
    if getattr(pspec, "trperiod", 120.0) <= 120:          # WSPR: 120 s
        np.testing.assert_array_equal(warmup_window(mode),
                                      jbase.warmup_window(jmode))


def test_codes_and_crcs_match_jax():
    for pc, jc in [(ldpc.fst4_code(), jldpc.fst4_code()),
                   (js8.js8_code(), jjs8.js8_code())]:
        np.testing.assert_array_equal(pc.h, jc.h)
        np.testing.assert_array_equal(pc.gen_parity, jc.gen_parity)
        word = pc.encode(np.random.default_rng(pc.n).integers(0, 2, pc.k))
        assert not pc.syndrome(word).any()
    # the FST4 stand-in's check rows have irregular weights (5 and 6):
    # the BP tables pad the short rows
    t = ldpc.build_bp_tables(ldpc.fst4_code().h)
    assert sorted(set(t.row_mask.sum(axis=1).tolist())) == [5.0, 6.0]
    np.testing.assert_array_equal(fst4.fst4_crc_matrix(),
                                  jfst4.fst4_crc_matrix())
    np.testing.assert_array_equal(js8.js8_crc_matrix(), jjs8.js8_crc_matrix())
    np.testing.assert_array_equal(
        ldpc.make_ldpc_code(60, 30, seed=3).h, jldpc.make_ldpc_code(60, 30,
                                                                     seed=3).h)


@pytest.mark.parametrize("which", ["ft8", "fst4"])
def test_get_bp_decoder_matches_jax(which):
    pd, jd = ldpc.get_bp_decoder(which, iters=7, device="cpu"), \
        jldpc.get_bp_decoder(which, iters=7)
    assert pd.iters == jd.iters == 7
    np.testing.assert_array_equal(pd.code.h, jd.code.h)
    for name in ("row_cols", "row_mask", "col_slots", "col_mask"):
        np.testing.assert_array_equal(getattr(pd.t, name), getattr(jd.t, name))


JS8_TEXTS = ["KN4CRD: HB EN50", "KN4CRD: CQ EN50", "KN4CRD: J1Y SNR -12",
             "KN4CRD: J1Y QUERY MSGS", "KN4CRD: J1Y HEARING",
             "VE3/KN4CRD: HB", "W2AXR: K1ABC SNR?", "W2AXR: K1ABC 73",
             "W2AXR: K1ABC BLAHBLAH", "HELLO WORLD?", "CQ CQ CQ",
             "TO THE SEA AT TEN", "CQCQ K1ABC", "KN4CRD> VE3ABC> HELLO",
             "CQ CQ DE K1ABC K1ABC PSE REPLY ON 7078"]


def test_js8_frame_grammar_and_classify_match_jax():
    for text in JS8_TEXTS:
        bits = js8.pack_payload(text)
        np.testing.assert_array_equal(bits, jjs8.pack_payload(text))
        assert js8.unpack_payload(bits) == jjs8.unpack_payload(bits)
        assert dataclasses.asdict(js8.classify(text)) == \
            dataclasses.asdict(jjs8.classify(text))
        for pf, jf in zip(js8.pack_text_frames(text),
                          jjs8.pack_text_frames(text), strict=True):
            np.testing.assert_array_equal(pf, jf)
    rng = np.random.default_rng(87)
    for bits in rng.integers(0, 2, (64, 75), dtype=np.uint8):
        assert js8.unpack_payload(bits) == jjs8.unpack_payload(bits)


@pytest.mark.parametrize("mode", [Mode.WSPR, Mode.JT65, Mode.Q65_30])
def test_other_engines_still_refused(mode):
    """WSPR, JT65 and Q65-30, the engines the GFSK slice left out, are
    refused no longer: each constructs on the CPU and decodes the warm-up
    message from its own warm-up window (JT65's noiseless window also
    yields a sidelobe decode, in the reference as here)."""
    dec = get_decoder(mode, device="cpu")
    assert dec.mode == mode
    want = "K1ABC FN42 37" if mode == Mode.WSPR else "K1ABC W9XYZ EN37"
    assert want in [r.message for r in
                    dec.decode(warmup_window(mode)[None])[0]]
