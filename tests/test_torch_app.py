"""The slice end to end and at full SPEC, against one JAX reference decode.

A crowded FT8 channel in seeded 48 kHz IQ goes through the JAX
channelizer and the JAX ``FT8Decoder`` at full SPEC (top_k 512, 30 BP
iterations, OSD, AP seeded from the operator call, decodedepth 3).  Then:

- the port's ``FT8Decoder`` at the same settings decodes the same audio;
- the port's ``App`` replays the IQ (config -> receiver -> channelizer ->
  framing -> pool -> FT8 decoder -> spots).

Both must give the reference's decode list: the decoder within the
tolerances of ``test_torch_parity.py`` (the same messages, SNR within
0.5 dB, frequency within one bin, dt within one hop), the App's spots
within 2 Hz and 1 dB (its audio
comes from the port's channelizer, within 1e-4 of the reference's).
"""

from __future__ import annotations

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwsl_digi_tpu.dsp.channelizer import BatchChannelizer as JaxChannelizer
from cwsl_digi_tpu.modes import ft8 as jft8
from cwsl_digi_tpu.modes.gfsk import gfsk_modulate_iq
from cwsl_digi_tpu.report.spot import extract_spot
from cwsl_digi_tpu_torch.config import load_config
from cwsl_digi_tpu_torch.modes import ft8
from cwsl_digi_tpu_torch.runtime.app import App
from test_torch_parity import assert_same_decodes

torch.set_num_threads(1)

FS, LO, DIAL = 48_000, 14_077_000, 14_074_000
DECODER_KW = dict(my_call="W2AXR", depth=3, fmax_hz=3000.0)
# (message, audio Hz, amplitude, start s) against the 0.01-per-component
# noise: about +10, -4, -7, -10, -12 and -16 dB in 2.5 kHz; the weakest is
# a CQ, which the AP hypotheses cover
BURSTS = [("CQ W2AXR FN13", 1500.0, 0.01, 0.5),
          ("W2AXR K1ABC -09", 700.0, 0.002, 0.8),
          ("CQ DL7ACA JO40", 1100.0, 0.0014, 1.0),
          ("G4ABC VE3XYZ EN93", 1850.0, 0.001, 0.6),
          ("K1ABC W9XYZ RR73", 2300.0, 0.0008, 0.3),
          ("CQ F5ABC JN18", 2650.0, 0.0005, 0.4)]


def _iq() -> np.ndarray:
    """16 s of seeded 48 kHz IQ with the FT8 bursts in one channel."""
    rng = np.random.default_rng(0)
    n = FS * 16
    iq = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for text, f0, amp, start in BURSTS:
        b = amp * gfsk_modulate_iq(jft8.encode_message(text),
                                   DIAL + f0 - LO, jft8.SPS * 4, FS,
                                   jft8.SPEC.tone_spacing)
        s = int(start * FS)
        iq[s : s + len(b)] += b
    return iq.astype(np.complex64)


@pytest.fixture(scope="module")
def reference():
    """The IQ, its JAX-channelized window and the JAX full-SPEC decode of
    it, fed device-resident like the receiver's windows."""
    iq = _iq()
    audio = np.array(JaxChannelizer(FS, [DIAL - LO]).process_window(
        iq[: 15 * FS]))
    ref = jft8.FT8Decoder(**DECODER_KW)
    # decode the one window unpadded: the reference pads a partial device
    # batch to 8 windows, eight times the work for the same decode list
    # (windows are decoded independently)
    ref.max_device_batch = 1
    want = ref.decode(jnp.asarray(audio))[0]
    assert len(want) >= 5
    return iq, audio, want


def test_full_spec_decode_list_matches_jax(reference):
    _, audio, want = reference
    got = ft8.FT8Decoder(**DECODER_KW, device="cpu").decode(
        torch.from_numpy(audio))[0]
    assert_same_decodes(got, want)


def test_app_ft8_replay_matches_jax(reference, tmp_path):
    iq, _, want = reference
    np.save(tmp_path / "band.npy", iq)
    ini = tmp_path / "app.ini"
    ini.write_text(f"""
[radio]
source=file:{tmp_path / 'band.npy'}?sr={FS}&lo={LO}
[operator]
callsign=W2AXR
gridsquare=FN13
[decoders]
decoder={DIAL} FT8
[wsjtx]
keepwav=true
temppath={tmp_path}/wavs
[logging]
loglevel=2
logimmediately=true
decodesfile={tmp_path}/decodes.txt
""")
    app = App(load_config(ini), max_runtime_s=120, device="cpu")
    spots, devices = [], []
    orig_handle, orig_push = app.spots.handle, app.pool.push

    def capture(res, **kw):
        s = orig_handle(res, **kw)
        if s:
            spots.append(s)
        return s

    def push(job):
        devices.append((job.audio.device.type, tuple(job.audio.shape)))
        orig_push(job)

    app.spots.handle = capture
    app.pool.push = push
    runner = threading.Thread(target=app.run, daemon=True)
    runner.start()
    deadline = time.monotonic() + 100
    while app.pool.count_decoded_windows < 1 and time.monotonic() < deadline:
        time.sleep(0.2)
    app._terminate = True
    runner.join(timeout=30)
    assert not runner.is_alive()
    assert devices == [("cpu", (1, 180_000))]

    want_spots = [s for s in (extract_spot(r, DIAL) for r in want)
                  if s is not None]
    assert {"W2AXR", "K1ABC", "W9XYZ"} <= {s.callsign for s in want_spots}
    got = {s.callsign: s for s in spots}
    assert sorted(got) == sorted(s.callsign for s in want_spots)
    for s in want_spots:
        g = got[s.callsign]
        assert g.message == s.message
        assert abs(g.freq_hz - s.freq_hz) <= 2
        assert abs(g.snr_db - s.snr_db) <= 1
        assert g.base_freq_hz == DIAL
    txt = (tmp_path / "decodes.txt").read_text()
    assert "CQ W2AXR FN13" in txt
    assert any("FT8" in w.name for w in (tmp_path / "wavs").glob("*.wav"))
