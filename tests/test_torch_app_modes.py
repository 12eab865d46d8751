"""The port's App with FT4 and JS8 decoder lines on a seeded file replay,
against a JAX reference decode of the same windows.

16 s of 48 kHz IQ carry FT4 bursts in both 7.5 s FT4 windows and JS8
bursts in the 15 s JS8 window.  The reference channelizes the IQ with the
JAX channelizer, cuts the windows at the UTC boundaries and decodes them
with the JAX decoders built as the reference App builds them
(``decodedepth`` 1, ``highestdecodefreq`` 3000); each decodes its windows
unpadded.  The port's App must frame the windows on the same boundaries
(FT4 at 0 and 7.5 s, JS8 at 0 s of a 15 s anchor) and report the
reference's spots, JS8's from its sender grammar: the same messages,
frequency within 2 Hz, SNR within 1 dB (the App's audio comes from the
port's channelizer, within 1e-4 of the reference's).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from cwsl_digi_tpu.dsp.channelizer import BatchChannelizer as JaxChannelizer
from cwsl_digi_tpu.modes import ft4 as jft4
from cwsl_digi_tpu.modes import js8 as jjs8
from cwsl_digi_tpu.modes.gfsk import gfsk_modulate_iq
from cwsl_digi_tpu.report.spot import extract_spot
from cwsl_digi_tpu_torch.config import load_config
from cwsl_digi_tpu_torch.runtime.app import App

torch.set_num_threads(1)

FS, LO = 48_000, 14_074_000
JS8_DIAL, FT4_DIAL = 14_070_000, 14_080_000
FMAX = 3000.0
# (mode module, dial, message, audio Hz, amplitude, start s) against the
# 0.01-per-component noise: about -4 to -12 dB in 2.5 kHz
BURSTS = [(jft4, FT4_DIAL, "CQ W2AXR FN13", 1000.0, 0.002, 0.5),
          (jft4, FT4_DIAL, "K1ABC W9XYZ EN37", 1800.0, 0.001, 0.8),
          (jft4, FT4_DIAL, "G4ABC K1ABC RR73", 1400.0, 0.0015, 7.8),
          (jjs8, JS8_DIAL, "KN4CRD: HB EN50", 1200.0, 0.0015, 0.5),
          (jjs8, JS8_DIAL, "W2AXR: K1ABC SNR -12", 2100.0, 0.001, 1.0)]


def _iq() -> np.ndarray:
    rng = np.random.default_rng(11)
    n = FS * 16
    iq = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for mod, dial, text, f0, amp, start in BURSTS:
        b = amp * gfsk_modulate_iq(mod.encode_message(text), dial + f0 - LO,
                                   mod.SPS * FS // 12_000, FS,
                                   mod.SPEC.tone_spacing, bt=mod.SPEC.bt)
        s = int(start * FS)
        iq[s : s + len(b)] += b
    return iq.astype(np.complex64)


def _reference(iq: np.ndarray) -> list:
    """The JAX package's spots of the same windows."""
    audio = np.array(JaxChannelizer(
        FS, [JS8_DIAL - LO, FT4_DIAL - LO]).process_window(iq[: 15 * FS]))
    ft4_dec = jft4.FT4Decoder(depth=1, fmax_hz=FMAX)
    js8_dec = jjs8.JS8Decoder(fmax_hz=FMAX)
    ft4_dec.max_device_batch = 2
    js8_dec.max_device_batch = 1
    results = [(r, FT4_DIAL) for w in ft4_dec.decode(audio[1].reshape(2, -1))
               for r in w]
    results += [(r, JS8_DIAL) for r in js8_dec.decode(audio[:1])[0]]
    return [s for s in (extract_spot(r, dial) for r, dial in results)
            if s is not None]


def test_app_ft4_js8_replay_matches_jax(tmp_path):
    iq = _iq()
    want = _reference(iq)
    assert sorted(s.message for s in want) == sorted(b[2] for b in BURSTS)
    np.save(tmp_path / "band.npy", iq)
    ini = tmp_path / "app.ini"
    ini.write_text(f"""
[radio]
source=file:{tmp_path / 'band.npy'}?sr={FS}&lo={LO}
[operator]
callsign=W2AXR
gridsquare=FN13
[decoders]
decoder={JS8_DIAL} JS8
decoder={FT4_DIAL} FT4
[wsjtx]
decodedepth=1
highestdecodefreq={int(FMAX)}
[logging]
loglevel=2
logimmediately=true
""")
    app = App(load_config(ini), max_runtime_s=120, device="cpu")
    spots, jobs = [], []
    orig_handle, orig_push = app.spots.handle, app.pool.push

    def capture(res, **kw):
        s = orig_handle(res, **kw)
        if s:
            spots.append(s)
        return s

    def push(job):
        jobs.append((job.mode.value, job.epoch_time, job.audio.device.type,
                     tuple(job.audio.shape)))
        orig_push(job)

    app.spots.handle = capture
    app.pool.push = push
    runner = threading.Thread(target=app.run, daemon=True)
    runner.start()
    deadline = time.monotonic() + 110
    while app.pool.count_decoded_windows < 3 and time.monotonic() < deadline:
        time.sleep(0.2)
    app._terminate = True
    runner.join(timeout=30)
    assert not runner.is_alive()

    # windows close on their own UTC boundaries
    ft4_jobs = sorted(j for j in jobs if j[0] == "FT4")
    js8_jobs = [j for j in jobs if j[0] == "JS8"]
    assert [j[2:] for j in ft4_jobs] == [("cpu", (1, 90_000))] * 2
    assert [j[2:] for j in js8_jobs] == [("cpu", (1, 180_000))]
    e0 = js8_jobs[0][1]
    assert e0 % 15 == 0
    assert [j[1] for j in ft4_jobs] == [e0, e0 + 7.5]

    got = {s.message: s for s in spots}
    assert sorted(got) == sorted(s.message for s in want)
    assert got["KN4CRD: HB EN50"].callsign == "KN4CRD"
    assert got["KN4CRD: HB EN50"].locator == "EN50"
    for s in want:
        g = got[s.message]
        assert (g.callsign, g.base_freq_hz, g.mode.value) == \
            (s.callsign, s.base_freq_hz, s.mode.value)
        assert abs(g.freq_hz - s.freq_hz) <= 2
        assert abs(g.snr_db - s.snr_db) <= 1
