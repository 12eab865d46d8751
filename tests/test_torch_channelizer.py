"""The port's channelizer (plain PyTorch version on CPU tensors) against the
JAX package's XLA channelizer, its Pallas kernel in interpret mode and the
float64 oracle.  The CUDA kernel is held against the plain version on the
card in ``test_torch_cuda.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cwsl_digi_tpu.dsp.channelizer import BatchChannelizer as JaxChannelizer
from cwsl_digi_tpu.dsp.pallas_channelizer import TILE_C, PallasChannelizer
from cwsl_digi_tpu.dsp.ssbd import SSBD
from cwsl_digi_tpu_torch.dsp.channelizer import BatchChannelizer

torch.set_num_threads(1)


def _iq(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def _freqs(fs: int, n: int, usb: bool = True) -> np.ndarray:
    """n channel offsets whose 6 kHz passbands lie inside the band."""
    lo, hi = -0.45 * fs, 0.45 * fs
    return np.linspace(lo, hi - 6000, n) if usb else \
        np.linspace(lo + 6000, hi, n)


@pytest.mark.parametrize("fs", [48_000, 192_000])
@pytest.mark.parametrize("usb", [True, False])
def test_plain_matches_jax_channelizer(fs, usb):
    """Same IQ, streamed in two blocks: atol 1e-4 (float32 sums of FO
    taps in another order and another NCO factorization; output rms
    ~0.2)."""
    freqs = _freqs(fs, 5, usb)
    jb = JaxChannelizer(fs, freqs, is_usb=usb)
    tb = BatchChannelizer(fs, freqs, is_usb=usb)
    iq = _iq(3 * tb._sub, seed=fs + usb)
    for blk in (iq[: 2 * tb._sub], iq[2 * tb._sub:]):
        a = np.asarray(jb.process(blk))
        b = tb.process(blk).numpy()
        assert b.shape == a.shape and b.dtype == np.float32
        np.testing.assert_allclose(b, a, atol=1e-4)


@pytest.mark.parametrize("fs,usb", [(48_000, True), (192_000, False)])
def test_plain_matches_float64_oracle(fs, usb):
    """Against the float64 SSBD oracle: atol 2e-3, the reference's own
    tolerance for its channelizers (tests/test_pallas_channelizer.py)."""
    freqs = _freqs(fs, 4, usb)
    tb = BatchChannelizer(fs, freqs, is_usb=usb)
    iq = _iq(tb._sub * 2 + 8 * tb.spec.block_size, seed=7)
    audio = tb.process_window(iq).numpy()
    assert audio.shape == (4, len(iq) // tb.spec.block_size)
    for i in (0, 3):
        gold = SSBD(fs, 6000, float(freqs[i]), is_usb=usb).process(
            iq.astype(np.complex128))
        np.testing.assert_allclose(audio[i], gold, atol=2e-3)


def test_plain_matches_pallas_interpret():
    """One 8-channel Pallas tile (interpret mode), 192 kHz: atol 1e-4."""
    fs = 192_000
    freqs = np.linspace(-80_000, 80_000, TILE_C)
    pc = PallasChannelizer(fs, freqs)
    tb = BatchChannelizer(fs, freqs)
    iq = _iq(pc.tile_t * 3, seed=11)
    a = np.asarray(pc.process_window(iq))
    b = tb.process_window(iq).numpy()
    np.testing.assert_allclose(b, a, atol=1e-4)


@pytest.mark.parametrize("fs", [48_000, 192_000])
def test_streaming_matches_whole_window(fs):
    """Chunked streaming equals one whole window: atol 1e-4."""
    tb = BatchChannelizer(fs, _freqs(fs, 3))
    iq = _iq(6 * tb._sub, seed=5)
    whole = tb.process_window(iq).numpy()
    tb.reset()
    parts = np.concatenate([tb.process(iq[i : i + tb._sub]).numpy()
                            for i in range(0, len(iq), tb._sub)], axis=1)
    np.testing.assert_allclose(parts, whole, atol=1e-4)


def test_state_save_restore_and_api():
    tb = BatchChannelizer(48_000, _freqs(48_000, 2))
    iq = _iq(2 * tb._sub, seed=9)
    first = tb.process(iq[: tb._sub])
    saved = tb.state
    second = tb.process(iq[tb._sub:])
    tb.process(np.zeros(tb._sub, np.complex64))      # receiver warm()
    tb.state = saved
    again = tb.process(iq[tb._sub:])
    torch.testing.assert_close(again, second, rtol=0, atol=0)
    assert first.shape == (2, tb._sub // tb.spec.block_size)
    with pytest.raises(ValueError):
        tb.process(iq[:100])
    with pytest.raises(ValueError):
        tb.process_window(iq[:101])
    with pytest.raises(ValueError):
        BatchChannelizer(48_000, [30_000.0])          # outside the band
    re_im = tb.process_window((iq.real, iq.imag))
    pairs = tb.process_window(np.stack([iq.real, iq.imag], axis=1))
    torch.testing.assert_close(re_im, pairs, rtol=0, atol=0)
