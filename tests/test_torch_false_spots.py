"""Live FT8 windows that gave false spots of other forms than the AP one,
held against the JAX package.

``tests/torch_fixtures/false_spots/`` holds two float32 channel-windows
saved by ``tools/torch_soak.py --keep-false`` from the App live on the
card (512 FT8 dials as 8 receivers x 64, AP hypotheses from the operator
call W2AXR, decodedepth 3): one with a CQ-form false spot and one with
neither CQ nor the operator's call, each alone in its window.  Decoded
alone as device arrays (neither peak-scaled), the port on the CPU, the
JAX package live and the JAX list stored beside each window must agree
message for message, the false message included: these spots are the
reference's behaviour, as the operator-call ones of
``test_torch_ap_fixtures.py`` are.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

from cwsl_digi_tpu.modes import ft8 as jft8  # noqa: E402
from torch_ap_false import decode_window, fixtures  # noqa: E402

torch.set_num_threads(1)

FALSE_SPOTS = REPO / "tests" / "torch_fixtures" / "false_spots"
FOUND = fixtures(FALSE_SPOTS)


def test_fixtures_are_live_windows_with_cq_and_no_ap_false_spots():
    assert len(FOUND) == 2
    assert sum(p.stat().st_size for p, _ in FOUND) <= 1_500_000
    false = []
    for path, side in FOUND:
        audio = np.load(path)
        assert audio.dtype == np.float32 and audio.shape == (180_000,)
        assert side["mode"] == "FT8" and side["decoder"] == {
            "my_call": "W2AXR", "depth": 3, "fmax_hz": 3000.0}
        assert side["false"] == side["messages"]       # nothing injected
        false += side["false"]
    assert sorted(false) == ["804KVK JV1SCO R KQ17", "CQ B95TKD R DH43"]


@pytest.fixture(scope="module")
def jax_decoder():
    return jft8.FT8Decoder(my_call="W2AXR", depth=3, fmax_hz=3000.0)


@pytest.mark.parametrize("path,side", FOUND, ids=[p.stem for p, _ in FOUND])
def test_port_and_jax_decode_the_same_false_spot(path, side, jax_decoder):
    audio = np.load(path)
    port = decode_window(audio, side, torch.device("cpu"))
    live_jax = sorted(r.message for r in jax_decoder.decode(
        jnp.asarray(audio)[None])[0])
    assert port == side["jax"] == side["false"]
    assert live_jax == side["jax"]
