"""The port's App on seeded file replays against a JAX reference decode of
the same windows: FT4 and JS8 lines, then JT65 and Q65-30 lines.

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

The JT65/Q65-30 replay is seeded noise from the App's anchor to the next
UTC minute, then 61 s of 48 kHz IQ: one JT65 window and two Q65-30
windows with a burst each, decoded by the App's decoders
(``highestdecodefreq`` 3000 Hz as ``fmax_hz``: JT65 on its rfft branch,
Q65-30 on its DFT branch) and by the reference's.

Last, the App's ``printjt9output`` echo of a decode against the
reference App's.
"""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest
import torch

from cwsl_digi_tpu.dsp.channelizer import BatchChannelizer as JaxChannelizer
from cwsl_digi_tpu.modes import ft4 as jft4
from cwsl_digi_tpu.modes import js8 as jjs8
from cwsl_digi_tpu.modes import jt65 as jjt65
from cwsl_digi_tpu.modes import q65 as jq65
from cwsl_digi_tpu.modes.gfsk import gfsk_modulate_iq
from cwsl_digi_tpu.report.spot import extract_spot
from cwsl_digi_tpu_torch.config import load_config
from cwsl_digi_tpu_torch.constants import Mode
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


# JT65 and Q65-30 on one receiver
JT65_DIAL, Q65_DIAL = 14_076_000, 14_079_500
# (mode module, dial, message, audio Hz, amplitude, start s after the
# minute) against the 0.01-per-component noise: about -10 to -16 dB
APP_BURSTS = [(jjt65, JT65_DIAL, "K1ABC W9XYZ EN37", 1270.5, 0.0008, 1.0),
              (jq65, Q65_DIAL, "CQ W2AXR FN13", 1000.0, 0.0005, 0.5),
              (jq65, Q65_DIAL, "W2AXR K1ABC -11", 1500.0, 0.0004, 30.5)]


def _weak_iq(lead_s: float) -> np.ndarray:
    """``lead_s`` s of seeded noise up to a UTC minute, then 61 s with the
    bursts (the same samples whatever the lead-in)."""
    def noise(n, seed):
        rng = np.random.default_rng(seed)
        return 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))

    iq = noise(FS * 61, 6530)
    for mod, dial, text, f0, amp, start in APP_BURSTS:
        b = amp * gfsk_modulate_iq(mod.encode_message(text), dial + f0 - LO,
                                   mod.SPS * FS // 12_000, FS,
                                   mod.TONE_SPACING, bt=2.0)
        s = int(start * FS)
        iq[s : s + len(b)] += b
    return np.concatenate([noise(int(round(lead_s * FS)), 6531),
                           iq]).astype(np.complex64)


def _weak_reference(iq: np.ndarray, lead_s: float) -> list:
    """The JAX package's spots of the windows after the minute, its
    decoders built as its App builds them (``highestdecodefreq`` as
    ``fmax_hz``)."""
    audio = np.array(JaxChannelizer(
        FS, [JT65_DIAL - LO, Q65_DIAL - LO]).process_window(iq))
    a0 = int(round(lead_s * 12_000))
    results = [(r, JT65_DIAL) for r in jjt65.JT65Decoder(fmax_hz=FMAX).decode(
        audio[:1, a0 : a0 + 720_000])[0]]
    results += [(r, Q65_DIAL) for w in jq65.Q65Decoder(fmax_hz=FMAX).decode(
        audio[1, a0 : a0 + 720_000].reshape(2, -1)) for r in w]
    return [s for s in (extract_spot(r, dial) for r, dial in results)
            if s is not None]


def test_app_jt65_q65_replay_matches_jax(tmp_path):
    """The App takes its own anchor (the next UTC 15 s boundary); the
    replay is written for it: noise to the next minute, where JT65's
    window and the bursts begin.  JT65 and Q65-30 windows close on their
    own boundaries from the anchor on, and the spots are the reference's
    (noise-only windows of the lead-in give none)."""
    iq_path = tmp_path / "band.npy"
    ini = tmp_path / "app.ini"
    ini.write_text(f"""
[radio]
source=file:{iq_path}?sr={FS}&lo={LO}
[operator]
callsign=W2AXR
gridsquare=FN13
[decoders]
decoder={JT65_DIAL} JT65
decoder={Q65_DIAL} Q65-30
[wsjtx]
highestdecodefreq={int(FMAX)}
[logging]
loglevel=2
logimmediately=true
""")
    app = App(load_config(ini), max_runtime_s=150, device="cpu")
    spots, jobs, state = [], [], {}
    orig_handle, orig_push = app.spots.handle, app.pool.push
    orig_setup = app.setup_receivers

    def capture(res, **kw):
        s = orig_handle(res, **kw)
        if s:
            spots.append(s)
        return s

    def push(job):
        jobs.append((job.mode.value, job.epoch_time, job.audio.device.type,
                     tuple(job.audio.shape)))
        orig_push(job)

    def setup(utc_anchor):
        if not state:
            state["anchor"] = utc_anchor
            state["lead"] = lead = -utc_anchor % 60.0
            state["iq"] = _weak_iq(lead)
            # one JT65 window; Q65-30's from its first boundary on
            state["n"] = 1 + int((lead + 61 - lead % 30) // 30)
            np.save(iq_path, state["iq"])
        orig_setup(utc_anchor)

    app.spots.handle = capture
    app.pool.push = push
    app.setup_receivers = setup
    runner = threading.Thread(target=app.run, daemon=True)
    runner.start()
    deadline = time.monotonic() + 140
    while app.pool.count_decoded_windows < state.get("n", 1 << 30) \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    app._terminate = True
    runner.join(timeout=30)
    assert not runner.is_alive()
    assert app.pool.count_decoded_windows == state["n"]

    # the App built the decoders as the reference's App does
    assert app.pool._decoder_factory(Mode.JT65).spectrogram_branch == "rfft"
    assert app.pool._decoder_factory(Mode.Q65_30).spec.fmax_hz == FMAX
    # windows close on their own UTC boundaries
    anchor, lead = state["anchor"], state["lead"]
    q65_jobs = sorted(j for j in jobs if j[0] == "Q65-30")
    jt65_jobs = [j for j in jobs if j[0] == "JT65"]
    assert [j[1:] for j in jt65_jobs] == [(anchor + lead, "cpu",
                                           (1, 720_000))]
    assert [j[1] for j in q65_jobs] == [anchor + lead % 30 + 30 * k
                                        for k in range(state["n"] - 1)]
    assert {j[2:] for j in q65_jobs} == {("cpu", (1, 360_000))}

    want = _weak_reference(state["iq"], lead)
    assert sorted(s.message for s in want) == sorted(b[2] for b in APP_BURSTS)
    got = {s.message: s for s in spots}
    assert sorted(got) == sorted(s.message for s in want)
    for s in want:
        g = got[s.message]
        assert (g.callsign, g.base_freq_hz, g.mode.value) == \
            (s.callsign, s.base_freq_hz, s.mode.value)
        assert abs(g.freq_hz - s.freq_hz) <= 2
        assert abs(g.snr_db - s.snr_db) <= 1


@pytest.mark.parametrize("mode,message,drift", [
    ("WSPR", "K1ABC FN42 37", -1.6), ("WSPR", "L8TUM RD32 30", 2.5),
    ("JT65", "K1ABC W9XYZ EN37", 0.0)])
def test_app_prints_decodes_as_the_reference(mode, message, drift):
    """With ``printjt9output`` the App echoes each decode as the
    reference's App does: WSPR in wsprd's format (dial frequency, drift
    rounded to Hz), other modes in jt9's; the spot handler gets the same
    arguments."""
    from cwsl_digi_tpu import constants as jconstants
    from cwsl_digi_tpu.modes.base import DecodeResult as JaxResult
    from cwsl_digi_tpu.runtime.app import App as JaxApp
    from cwsl_digi_tpu_torch.modes.base import DecodeResult

    dial = 14_095_600
    cfg = load_config(None, [f"decoders.decoder={dial} {mode}",
                             "logging.printjt9output=true"])
    fields = dict(message=message, snr_db=-24.0, dt_s=0.7, freq_hz=1512.5,
                  score=3.0, drift_hz=drift)
    job = types.SimpleNamespace(epoch_time=1_700_000_040.0,
                                base_freqs=[dial], decoder_indices=[0],
                                wspr_callsigns=["N0CALL"])

    def record(app):
        lines, spots = [], []
        app.printer = types.SimpleNamespace(info=lines.append)
        app.spots = types.SimpleNamespace(
            handle=lambda r, **kw: spots.append(kw))
        return lines, spots

    app = App(cfg, device="cpu")
    lines, spots = record(app)
    app._on_result(job, 0, DecodeResult(mode=Mode(mode), **fields))
    # the reference's method on a stand-in App with the same config
    ref = types.SimpleNamespace(cfg=cfg)
    want = record(ref)
    JaxApp._on_result(ref, job, 0,
                      JaxResult(mode=jconstants.Mode(mode), **fields))
    assert (lines, spots) == want
    assert len(lines) == 1 and lines[0].endswith(message)
    if mode == "WSPR":
        assert f" {round(drift):2d} " in lines[0]
        assert "14.097112" in lines[0]
