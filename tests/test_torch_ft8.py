"""FT8 decode lists of the port against the JAX package on the same seeded
windows at a reduced top_k, and the committed FT8 fixtures through the
port.  The full-SPEC decode list is held against the reference in
``test_torch_app.py``, which shares one reference decode with the App test.

Decode lists are compared within the tolerances of ``test_torch_parity.py``:
the same messages per window, SNR within 0.5 dB, frequency within one bin
(1.5625 Hz), dt within one hop (20 ms)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cwsl_digi_tpu.modes import ft8 as jft8
from cwsl_digi_tpu.modes.gfsk import add_noise_at_snr
from cwsl_digi_tpu.utils.wav import read_wav
from cwsl_digi_tpu_torch.modes import ft8
from cwsl_digi_tpu_torch.modes.base import get_decoder, warmup_window
from test_torch_parity import assert_same_batch_decodes

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
MANIFEST = [e for e in json.loads((FIXTURES / "manifest.json").read_text())
            if e["mode"] == "FT8"]


def _window(signals, snr_db: float, seed: int) -> np.ndarray:
    """One 15 s window: (text, f0, amplitude, start_s) bursts in noise."""
    clean = sum(ft8.synthesize(t, f, amplitude=a, start_s=s)
                for t, f, a, s in signals)
    return add_noise_at_snr(clean, snr_db, 12_000,
                            np.random.default_rng(seed))


def test_reduced_decode_lists_match_jax():
    """Three windows with several signals each, top_k 64 / 25 BP
    iterations (the reference's own test setting), depth 2."""
    wins = np.stack([
        _window([("CQ W2AXR FN13", 600.0, 1.0, 0.5),
                 ("K1ABC W9XYZ -15", 1400.0, 0.5, 0.7),
                 ("CQ DX VE3XYZ EN93", 2200.0, 0.25, 0.3)], -2.0, 1),
        _window([("G4ABC K1ABC RR73", 900.0, 1.0, 1.1),
                 ("CQ DL7ACA JO40", 1900.0, 0.7, 0.5)], -8.0, 2),
        _window([("K1ABC W9XYZ EN37", 1250.0, 1.0, 0.0)], -14.0, 3),
    ])
    ref = jft8.FT8Decoder(top_k=64, bp_iters=25)
    ref.max_device_batch = len(wins)    # unpadded, as in test_torch_app.py
    want = ref.decode(wins)
    got = ft8.FT8Decoder(top_k=64, bp_iters=25, device="cpu").decode(wins)
    assert sum(len(w) for w in want) >= 5
    assert_same_batch_decodes(got, want)


@pytest.fixture(scope="module")
def default_decoder():
    return get_decoder("FT8", device="cpu")


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_fixture_decodes(default_decoder, entry):
    audio, sr = read_wav(FIXTURES / entry["file"])
    assert sr == 12_000
    results = default_decoder.decode(np.asarray(audio, np.float32)[None])[0]
    msgs = [r.message for r in results]
    assert entry["message"] in msgs, msgs
    r = next(r for r in results if r.message == entry["message"])
    assert abs(r.freq_hz - entry["f0_hz"]) < 3.0
    assert abs(r.snr_db - entry["snr_db"]) < 4.0


def test_tensor_audio_is_not_rescaled(default_decoder):
    """Device-fed (tensor) windows skip the host int16 peak scaling, as
    the reference's device-resident path does; decodes are scale-free."""
    w = warmup_window("FT8").astype(np.float32)
    host = default_decoder.decode(w[None])[0]
    dev = default_decoder.decode(torch.from_numpy(0.01 * w[None]))[0]
    assert [r.message for r in dev] == [r.message for r in host] \
        == ["K1ABC W9XYZ EN37"]
    # every mode has a decoder now, WSPR among them
    assert get_decoder("WSPR", device="cpu").mode.value == "WSPR"
