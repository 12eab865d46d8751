"""Tests of the port that need the card: the CUDA channelizer kernel against
its plain version, and the FT8, FT4, JS8, FST4-60, WSPR, JT65 and Q65-30
decoders on CUDA tensors against the same decoders on CPU tensors.

This file imports no JAX (the machine with the card has none), so it runs
there without the suite's JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Elsewhere every test skips.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cwsl_digi_tpu_torch.dsp import _kernels
from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer
from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes import fst4, ft4, ft8, js8, jt65, q65, wspr
from cwsl_digi_tpu_torch.modes.gfsk import add_noise_at_snr
from test_torch_parity import WSPRTolerance, assert_same_batch_decodes

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _iq(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


@pytest.mark.parametrize("fs,usb", [(48_000, True), (96_000, True),
                                    (192_000, False)])
def test_cuda_kernel_matches_plain_on_card(dev, fs, usb):
    """The kernel against the plain version on the same CUDA inputs, 40
    channels (a partial channel tile), in the receiver's 12-sub-block
    chunks and one ragged window: atol 1e-4 (split-bf16 products, ~16
    bits, against float32 FIR sums of FO taps; output rms ~0.2)."""
    freqs = np.linspace(-0.45 * fs + 6000 * (not usb),
                        0.45 * fs - 6000 * usb, 40)
    kern = BatchChannelizer(fs, freqs, is_usb=usb, device=dev)
    plain = BatchChannelizer(fs, freqs, is_usb=usb, device=dev)
    g = 12 * kern._sub
    iq = torch.from_numpy(_iq(3 * g, seed=fs)).to(dev)
    before = _kernels.launches["channelize"]
    for i in range(3):
        x = iq[i * g : (i + 1) * g]
        torch.testing.assert_close(kern.process(x), plain.process_plain(x),
                                   rtol=0, atol=1e-4)
    n = 2 * g + 7 * kern.spec.block_size
    plain.reset()
    ref = plain.process_plain(torch.nn.functional.pad(iq[:n], (0, 3 * g - n)))
    torch.testing.assert_close(kern.process_window(iq[:n]),
                               ref[:, : n // kern.spec.block_size],
                               rtol=0, atol=1e-4)
    torch.cuda.synchronize()
    assert _kernels.launches["channelize"] == before + 4


def test_ft8_decoder_on_card_matches_cpu(dev):
    """The same windows through the port's decoder on CUDA and on CPU
    tensors: the same messages, SNR within 0.5 dB, frequency within one
    bin, dt within one hop (bf16 sync ties may order candidates
    differently on the two devices)."""
    rng = np.random.default_rng(5)
    wins = np.zeros((2, 180_000), np.float32)
    for w, sigs in enumerate([[("CQ W2AXR FN13", 700.0, 1.0, 0.5),
                               ("K1ABC W9XYZ -15", 1500.0, 0.4, 0.9)],
                              [("G4ABC K1ABC RR73", 2100.0, 0.3, 0.2)]]):
        for text, f0, amp, start in sigs:
            wins[w] += ft8.synthesize(text, f0, amplitude=amp, start_s=start)
        wins[w] += 0.3 * rng.standard_normal(180_000).astype(np.float32)
    kw = dict(my_call="W2AXR", depth=3)
    got = ft8.FT8Decoder(device=dev, **kw).decode(
        torch.from_numpy(wins).to(dev))
    want = ft8.FT8Decoder(device="cpu", **kw).decode(torch.from_numpy(wins))
    assert sum(len(w) for w in want) >= 3
    assert_same_batch_decodes(got, want)


def test_gfsk_modes_on_card_match_cpu(dev):
    """FT4 (refine branch), JS8 (its own LDPC(174,87)) and FST4-60 (fused
    DFT branch, coh4, sync-pair correction) on CUDA and on CPU tensors:
    the same decode lists within the tolerances above."""
    rng = np.random.default_rng(9)
    cases = [
        (lambda d: ft4.FT4Decoder(depth=3, device=d),
         ft4.synthesize("CQ W2AXR FN13", 900.0)
         + 0.5 * ft4.synthesize("K1ABC W9XYZ EN37", 1800.0, start_s=0.8),
         -12.0),
        (lambda d: js8.JS8Decoder(device=d),
         js8.synthesize("KN4CRD: HB EN50", 1100.0)
         + 0.6 * js8.synthesize("HELLO WORLD", 2000.0, start_s=1.0), -14.0),
        (lambda d: fst4.FST4Decoder(Mode.FST4_60, device=d),
         fst4.synthesize("K1ABC W9XYZ -15", Mode.FST4_60, 1000.0), -18.0),
    ]
    for make, clean, snr in cases:
        wins = np.stack([add_noise_at_snr(clean, snr, 12_000, rng)
                         for _ in range(2)]).astype(np.float32)
        card, host = make(dev), make("cpu")
        got = card.decode(torch.from_numpy(wins).to(dev))
        want = host.decode(torch.from_numpy(wins))
        assert sum(len(w) for w in want) >= 2, card.spec.name
        assert_same_batch_decodes(got, want, card.spec)


def test_weak_modes_on_card_match_cpu(dev):
    """WSPR (beam search, DD passes, OSD), JT65 (rfft branch and DFT
    branch, RS Chase with the reference's random patterns) and Q65-30
    (GF(64) message passing) on CUDA and on CPU tensors: the same decode
    lists within the tolerances above."""
    rng = np.random.default_rng(65)
    cases = [
        (lambda d: wspr.WSPRDecoder(device=d),
         wspr.synthesize("K1ABC", "FN42", 37, 1460.0)
         + wspr.synthesize("W2AXR", "FN13", 30, 1540.0), -24.0,
         WSPRTolerance),
        (lambda d: jt65.JT65Decoder(device=d),
         jt65.synthesize("K1ABC W9XYZ EN37", 1270.5)
         + jt65.synthesize("CQ W2AXR FN13", 800.0, start_s=1.5), -18.0,
         jt65.SPEC),
        (lambda d: jt65.JT65Decoder(fmax_hz=3000.0, device=d),
         jt65.synthesize("CQ W2AXR FN13", 2400.0), -18.0, jt65.SPEC),
        (lambda d: q65.Q65Decoder(device=d),
         q65.synthesize("CQ W2AXR FN13", 1200.0), -20.0, q65.SPEC),
    ]
    for make, clean, snr, tol in cases:
        wins = np.stack([add_noise_at_snr(clean, snr, 12_000, rng)
                         for _ in range(2)]).astype(np.float32)
        card, host = make(dev), make("cpu")
        got = card.decode(torch.from_numpy(wins).to(dev))
        want = host.decode(torch.from_numpy(wins))
        assert sum(len(w) for w in want) >= 2, type(card).__name__
        assert_same_batch_decodes(got, want, tol)
