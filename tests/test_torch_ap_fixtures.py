"""Live FT8 windows that gave false AP spots, held against the JAX package.

``tests/torch_fixtures/ap_false/`` holds float32 channel-windows saved by
``tools/torch_soak.py --keep-false`` from the App live on the card (512
FT8 dials on one 192 kHz receiver, AP hypotheses from the operator call
W2AXR, decodedepth 3), each with a sidecar: the decoder's construction
kwargs, the live decode's messages and the JAX package's list.  Decoded
alone, as device arrays (a tensor and a ``jnp`` array, so that neither
is peak-scaled), the port on the CPU, the JAX package live and the
stored JAX list must agree message for message, the false AP message
included: the false spot is the reference's behaviour.
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

AP_FIXTURES = REPO / "tests" / "torch_fixtures" / "ap_false"
FOUND = fixtures(AP_FIXTURES)


def test_fixtures_are_small_live_ft8_windows_with_a_false_ap_spot():
    assert 1 <= len(FOUND) <= 4
    assert sum(p.stat().st_size for p, _ in FOUND) <= 3_000_000
    for path, side in FOUND:
        audio = np.load(path)
        assert audio.dtype == np.float32 and audio.shape == (180_000,)
        assert side["mode"] == "FT8" and side["decoder"] == {
            "my_call": "W2AXR", "depth": 3, "fmax_hz": 3000.0}
        assert side["false"] and set(side["false"]) <= set(side["messages"])
        assert all(m.startswith("W2AXR ") for m in side["false"])


@pytest.fixture(scope="module")
def jax_decoder():
    return jft8.FT8Decoder(my_call="W2AXR", depth=3, fmax_hz=3000.0)


@pytest.mark.parametrize("path,side", FOUND, ids=[p.stem for p, _ in FOUND])
def test_port_and_jax_decode_the_same_list(path, side, jax_decoder):
    audio = np.load(path)
    port = decode_window(audio, side, torch.device("cpu"))
    live_jax = sorted(r.message for r in jax_decoder.decode(
        jnp.asarray(audio)[None])[0])
    assert port == side["jax"]
    assert live_jax == side["jax"]
    assert set(side["false"]) <= set(port)
