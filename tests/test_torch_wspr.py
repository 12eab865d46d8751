"""WSPR in the port against the JAX package.

- The device program's outputs on the same seeded windows: candidates
  (t0, f0, drift) identical, LLRs within 1e-3 (they are normalized to std
  3), scores and SNRs within rounding;
- ``_beam_decode`` fed the same LLRs: bits identical, path metric within
  1e-5 relative (ties among the first steps' dead beams are kept in the
  reference's order, so are the back-pointers);
- decode lists equal to the reference's (messages identical, SNR within
  0.5 dB, frequency within one 0.73 Hz bin, dt within one 0.17 s hop) on
  the committed ``wspr_m28db`` fixture, where the reference decodes a
  false message at the true signal's frequency and the port must too, and
  on seeded windows at a reduced top_k and beam width: -20 and -26 dB with
  +-2 Hz drift, two signals 80 Hz apart, noise only;
- the manifest message decodes on a synthesized -24 dB window;
- the receiver frames WSPR's 120 s windows on even UTC minutes, as the
  JAX receiver does.

The JAX references decode unpadded (window counts below their device
batch).
"""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwsl_digi_tpu.config import load_config as jload_config
from cwsl_digi_tpu.modes import wspr as jwspr
from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr
from cwsl_digi_tpu.runtime.decoderpool import DecoderPool as JaxPool
from cwsl_digi_tpu.runtime.receiver import Receiver as JaxReceiver
from cwsl_digi_tpu.sdr.source import open_source as jopen_source
from cwsl_digi_tpu.utils.wav import read_wav
from cwsl_digi_tpu_torch.config import load_config
from cwsl_digi_tpu_torch.modes import wspr
from cwsl_digi_tpu_torch.runtime.decoderpool import DecoderPool
from cwsl_digi_tpu_torch.runtime.receiver import Receiver
from cwsl_digi_tpu_torch.sdr.source import open_source
from test_torch_parity import WSPRTolerance, assert_same_batch_decodes

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
MANIFEST = {e["file"]: e for e in json.loads(
    (FIXTURES / "manifest.json").read_text())}


def _drifted(call: str, grid: str, dbm: int, f0: float, drift_hz: float
             ) -> np.ndarray:
    """A clean WSPR window whose tones drift linearly by ``drift_hz`` end
    to end over the burst (the analytic signal times a frequency ramp)."""
    clean = jwspr.synthesize(call, grid, dbm, f0)
    n = len(clean)
    h = np.zeros(n)
    h[0], h[1 : n // 2], h[n // 2] = 1.0, 2.0, 1.0
    analytic = np.fft.ifft(np.fft.fft(clean) * h)
    t = np.arange(n) / 12_000 - jwspr.SIGNAL_START_S
    burst_s = jwspr.NSYM * jwspr.SPS / 12_000
    phase = 2 * np.pi * drift_hz * (t ** 2 / (2 * burst_s) - t / 2)
    return np.real(analytic * np.exp(1j * phase))


def _seeded_windows() -> np.ndarray:
    rng = np.random.default_rng(162)
    w0 = add_noise_at_snr(_drifted("K1ABC", "FN42", 37, 1460.0, 2.0), -20.0,
                          12_000, rng)
    w1 = add_noise_at_snr(_drifted("W2AXR", "FN13", 30, 1520.0, -2.0), -26.0,
                          12_000, rng)
    two = (jwspr.synthesize("G4ABC", "IO91", 23, 1450.0)
           + jwspr.synthesize("VE3XYZ", "EN93", 40, 1530.0))
    w2 = add_noise_at_snr(two, -19.0, 12_000, rng)
    w3 = rng.standard_normal(len(w0))
    return np.stack([w0, w1, w2, w3]).astype(np.float32)


SMALL = dict(top_k=12, beam_width=128)
SEEDED_MESSAGES = [["K1ABC FN42 37"], ["W2AXR FN13 30"],
                   ["G4ABC IO91 23", "VE3XYZ EN93 40"], []]


@pytest.fixture(scope="module")
def seeded():
    """Both packages' arrays and decode lists of the seeded windows."""
    wins = _seeded_windows()
    jd, pd = jwspr.WSPRDecoder(**SMALL), wspr.WSPRDecoder(**SMALL,
                                                          device="cpu")
    assert len(wins) <= pd.max_device_batch          # unpadded
    return {"want_arrays": jd.decode_arrays(wins), "want": jd.decode(wins),
            "got_arrays": pd.decode_arrays(torch.from_numpy(wins)),
            "got": pd.decode(torch.from_numpy(wins)), "cfg": pd.cfg}


def test_decode_program_matches_jax(seeded):
    want, got = seeded["want_arrays"], seeded["got_arrays"]
    assert set(got) == set(want)
    for key in ("t0_hop", "f0_bin", "drift_idx"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["llr"], want["llr"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-5)
    np.testing.assert_allclose(got["snr"], want["snr"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["osd_wsum"], want["osd_wsum"], rtol=1e-5)


def test_beam_decode_matches_jax(seeded):
    """The reference's LLRs through both beam searches at the decoder's
    beam width and at 512, signal and noise candidates alike."""
    llr = seeded["want_arrays"]["llr"].reshape(-1, 81, 2)
    for cfg in (seeded["cfg"], wspr.WSPRConfig()):
        jcfg = jwspr.WSPRConfig(**{f: getattr(cfg, f)
                                   for f in cfg.__dataclass_fields__})
        bj, mj = jwspr._beam_decode(jcfg, jnp.asarray(llr))
        bp, mp = wspr._beam_decode(cfg, torch.from_numpy(llr))
        np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
        np.testing.assert_allclose(mp.numpy(), np.asarray(mj), rtol=1e-5)


def test_seeded_decode_lists_match_jax(seeded):
    want, got = seeded["want"], seeded["got"]
    assert [sorted(r.message for r in w) for w in want] == SEEDED_MESSAGES
    assert_same_batch_decodes(got, want, WSPRTolerance)
    drifts = [r.drift_hz for r in got[0] + got[1]]
    assert drifts == [r.drift_hz for r in want[0] + want[1]]


def test_fixture_decode_list_matches_jax():
    """The default decoders on ``wspr_m28db``: the port decodes what the
    reference decodes, its false decode at the true signal's frequency
    included."""
    audio, sr = read_wav(FIXTURES / "wspr_m28db.wav")
    assert sr == 12_000
    audio = np.asarray(audio, np.float32)[None]
    want = jwspr.WSPRDecoder().decode(audio)
    got = wspr.WSPRDecoder(device="cpu").decode(audio)
    assert [r.message for r in want[0]] == ["L8TUM RD32 30"]
    assert abs(want[0][0].freq_hz - MANIFEST["wspr_m28db.wav"]["f0_hz"]) < 1
    assert_same_batch_decodes(got, want, WSPRTolerance)


def test_manifest_message_decodes_on_synthesized_window():
    """The fixture's manifest message at -24 dB on a synthesized window
    decodes through the default decoder."""
    entry = MANIFEST["wspr_m28db.wav"]
    call, grid, dbm = entry["message"].split()
    clean = wspr.synthesize(call, grid, int(dbm), entry["f0_hz"])
    audio = add_noise_at_snr(clean, -24.0, 12_000,
                             np.random.default_rng(24)).astype(np.float32)
    res = wspr.WSPRDecoder(device="cpu").decode(audio)[0]
    assert [r.message for r in res] == [entry["message"]]
    assert abs(res[0].freq_hz - entry["f0_hz"]) < 1.5


def test_cycles_map_to_the_reference_configs():
    for cycles in (None, 300, 3000, 20_000):
        jd = jwspr.WSPRDecoder(cycles=cycles)
        pd = wspr.WSPRDecoder(cycles=cycles, device="cpu")
        assert pd.cfg.__dict__ == jd.cfg.__dict__
        np.testing.assert_array_equal(wspr._drift_offsets(pd.cfg),
                                      jwspr._drift_offsets(jd.cfg))


def test_popcount_wraps_as_uint32():
    rng = np.random.default_rng(32)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x01010101]
    want = np.asarray(jwspr._popcount32(jnp.asarray(x.astype(np.uint32))))
    got = wspr._popcount32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("anchor", [1_760_000_000.0, 1_760_000_015.0,
                                    1_760_000_045.0, 1_760_000_105.0])
def test_receiver_frames_wspr_on_even_minutes(anchor):
    """WSPR's 120 s windows (and JT65's, Q65-30's, FT8's) start where the
    JAX receiver starts them for the same anchor: the first even UTC
    minute at or after it."""
    over = [f"decoders.decoder={d}" for d in (
        "14095600 WSPR", "14076000 JT65", "14079500 Q65-30", "14074000 FT8")]
    spec = "synthetic:?sr=48000&lo=14080000"
    jrx = JaxReceiver(jopen_source(spec), jload_config(None, over).decoders,
                      JaxPool(decoder_factory=lambda m: None),
                      utc_anchor=anchor)
    prx = Receiver(open_source(spec), load_config(None, over).decoders,
                   DecoderPool(decoder_factory=lambda m: None),
                   utc_anchor=anchor, device="cpu")
    for mode, rows in jrx._mode_rows.items():
        pm = next(m for m in prx._mode_rows if m.value == mode.value)
        assert prx._mode_rows[pm] == rows
        assert prx._epoch0[pm] == jrx._epoch0[mode]
        assert prx._skip[pm] == jrx._skip[mode]
        assert prx._win_len[pm] == jrx._win_len[mode]
    wspr_mode = next(m for m in prx._mode_rows if m.value == "WSPR")
    assert prx._epoch0[wspr_mode] % 120 == 0
    assert prx._win_len[wspr_mode] == 120 * 12_000
