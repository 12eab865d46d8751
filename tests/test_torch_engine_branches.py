"""The GFSK engine's FST4 branches against the JAX package on the same
seeded inputs: the 4-symbol coherent LLRs, the fused-DFT and the rfft
spectrograms, and the sync-pair frequency correction.

The JAX package runs its spectrograms and its frequency correction inside
one jitted ``decode_program``, so the JAX side of those two stages is the
reference's own expressions (``gfsk_engine.py:411-433`` and ``:566-578``)
evaluated with ``jnp`` on the JAX decoder's tables; the whole program is
held to the reference at the decode list in ``test_torch_gfsk_modes.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cwsl_digi_tpu.modes import fst4 as jfst4
from cwsl_digi_tpu.modes import gfsk_engine as jeng
from cwsl_digi_tpu_torch.constants import Mode
from cwsl_digi_tpu_torch.modes import fst4, gfsk_engine
from test_torch_gfsk_modes import _JaxRfft, _Rfft

torch.set_num_threads(1)


def _csym(spec, m: int, seed: int) -> np.ndarray:
    """[m, n_sym, n_tones] complex64: unit noise plus a tone per symbol
    (sync tones where known) at amplitudes 0.2-3, random phases."""
    rng = np.random.default_rng(seed)
    t = spec.n_tones
    tones = rng.integers(0, t, size=(m, spec.n_sym))
    for s, tone in spec.sync_cells:
        tones[:, s] = tone
    amp = np.linspace(0.2, 3.0, m)[:, None, None]
    c = (rng.standard_normal((m, spec.n_sym, t))
         + 1j * rng.standard_normal((m, spec.n_sym, t)))
    c += amp * np.exp(1j * rng.uniform(0, 2 * np.pi, (m, spec.n_sym, 1))) \
        * (np.arange(t) == tones[:, :, None])
    return c.astype(np.complex64)


def test_coh4_llrs_match_jax():
    """FST4 (4-FSK, coh4): same csym/rot, LLRs within atol 1e-3 after the
    std-3 scaling (float32 max-log sums in another order)."""
    spec = fst4.make_spec(Mode.FST4_60)
    assert spec.coh4 and spec.n_tones == 4
    m = 40
    csym = _csym(spec, m, seed=31)
    rng = np.random.default_rng(32)
    rot = np.exp(-1j * rng.uniform(-np.pi, np.pi, m)).astype(np.complex64)
    bitmaps = spec.bitmaps()
    want = np.asarray(jeng._multisym_llrs(
        jfst4.make_spec(jfst4.Mode.FST4_60), jnp.asarray(csym),
        jnp.asarray(rot), jnp.asarray(bitmaps)))
    got = gfsk_engine._multisym_llrs(spec, torch.from_numpy(csym),
                                     torch.from_numpy(rot),
                                     torch.from_numpy(bitmaps)).numpy()
    assert got.shape == (m, spec.n_bits)
    np.testing.assert_allclose(got, want, atol=1e-3)
    # the 4-symbol windows move the LLRs: coh4 off gives other values
    spec3 = gfsk_engine.dataclasses.replace(spec, coh4=False)
    got3 = gfsk_engine._multisym_llrs(spec3, torch.from_numpy(csym),
                                      torch.from_numpy(rot),
                                      torch.from_numpy(bitmaps)).numpy()
    assert np.abs(got3 - got).max() > 0.1


def _jax_spectrograms(spec, audio: np.ndarray, dft_mat, window):
    """The reference's fused-DFT / rfft spectrogram expressions
    (gfsk_engine.py:367-368, 411-433) on the JAX decoder's tables."""
    b, n_samples = audio.shape
    sps, hop = spec.sps, spec.hop
    n_hops = (n_samples - sps) // hop + 1
    fmin_bin = int(spec.fmin_hz / spec.bin_hz)
    fmax_bin = int(np.ceil(spec.fmax_hz / spec.bin_hz)) + 1
    n_bins = fmax_bin - fmin_bin + spec.os_f * spec.n_tones
    audio = jnp.asarray(audio)
    idx = jnp.arange(n_hops)[:, None] * hop + jnp.arange(sps)[None, :]
    frames = audio[:, idx]
    pad = ((0, 0), (spec.pad_hops, spec.pad_hops), (0, 0))
    if dft_mat is not None:
        four = jnp.einsum(
            "is,sj->ij",
            frames.reshape(b * n_hops, sps).astype(jnp.bfloat16),
            jnp.asarray(dft_mat).astype(jnp.bfloat16),
            preferred_element_type=jnp.float32)
        four = four.reshape(b, n_hops, 4, n_bins)
        power_sync = jnp.pad(four[:, :, 2] ** 2 + four[:, :, 3] ** 2,
                             pad).astype(jnp.bfloat16)
        stft = jnp.pad(jax.lax.complex(four[:, :, 0], four[:, :, 1]), pad)
        return power_sync, stft

    def spectrogram(w, keep_complex=False):
        x = jnp.fft.rfft(frames * w[None, None, :], n=spec.nfft, axis=-1)
        x = x[:, :, fmin_bin : fmin_bin + n_bins]
        x = jnp.pad(x, pad)
        return x if keep_complex else (jnp.abs(x) ** 2).astype(jnp.bfloat16)

    return (spectrogram(jnp.asarray(window)),
            spectrogram(jnp.ones((sps,), jnp.float32), keep_complex=True))


@pytest.mark.parametrize("branch", ["dft", "rfft"])
def test_spectrograms_match_jax(branch):
    """FST4-60 on 2 seeded windows of 120 hops (a tone burst in noise):
    the bf16 sync power within one bf16 rounding step (2^-7 relative) plus
    1e-5 of its peak, the complex boxcar spectrogram within 1e-5 of its
    peak (float32 sums of bf16-rounded products, or float32 FFTs, in
    another order)."""
    jcls, pcls = ((jfst4.FST4Decoder, fst4.FST4Decoder) if branch == "dft"
                  else (_JaxRfft, _Rfft))
    jd = jcls(jfst4.Mode.FST4_60, top_k=8)
    pd = pcls(Mode.FST4_60, top_k=8, device="cpu")
    assert pd.spectrogram_branch == branch
    assert (jd._dft_mat is None) == (branch == "rfft")
    spec = pd.spec
    n = spec.sps + 119 * spec.hop
    rng = np.random.default_rng(60)
    t = np.arange(n) / 12_000
    audio = (1000.0 * rng.standard_normal((2, n))
             + 3000.0 * np.sin(2 * np.pi * 1000.3 * t)).astype(np.float32)
    want_p, want_s = (np.asarray(x, np.complex64 if x.dtype.kind == "c"
                                 else np.float32)
                      for x in _jax_spectrograms(jd.spec, audio, jd._dft_mat,
                                                 jd._window))
    power, demod, refine = gfsk_engine.spectrograms(
        spec, torch.from_numpy(audio), pd._tabs)
    assert not refine
    assert power.dtype == torch.bfloat16
    got_p = power.to(torch.float32).numpy()
    got_s = demod.numpy()
    assert got_p.shape == want_p.shape and got_s.shape == want_s.shape
    assert np.all(np.abs(got_p - want_p)
                  <= 2.0 ** -7 * np.abs(want_p) + 1e-5 * want_p.max())
    np.testing.assert_allclose(got_s, want_s, rtol=0,
                               atol=1e-5 * np.abs(want_s).max())


def test_sync_pair_rotation_matches_jax():
    """The refine_freq correction on FST4 symbols: rotations within 1e-5,
    including an all-zero candidate, whose z is a signed zero: its angle
    (0 or pi) follows the sign of the zero's parts as in the reference,
    and its LLRs are zero whatever the rotation."""
    spec = fst4.make_spec(Mode.FST4W_120)
    b, k = 2, 12
    csym = _csym(spec, b * k, seed=33).reshape(b, k, spec.n_sym,
                                               spec.n_tones)
    csym[1, 3] = 0.0
    rng = np.random.default_rng(34)
    f0 = rng.integers(0, 500, (b, k))
    rot = np.exp(-2j * np.pi * (f0 + 3826.0) / spec.os_f).astype(np.complex64)
    # the reference's expressions (gfsk_engine.py:566-578)
    ss = np.asarray([s for s, _ in spec.sync_cells])
    st = np.asarray([t for _, t in spec.sync_cells])
    by_sym = {int(s): int(t) for s, t in zip(ss, st)}
    pairs = [(s, by_sym[s + 1], by_sym[s])
             for s in sorted(by_sym) if s + 1 in by_sym]
    p_sym = jnp.asarray([p[0] for p in pairs], jnp.int32)
    p_tn = jnp.asarray([p[2] for p in pairs], jnp.int32)
    p_tn1 = jnp.asarray([p[1] for p in pairs], jnp.int32)
    jc = jnp.asarray(csym)
    z = jnp.sum(jnp.conj(jc[:, :, p_sym, p_tn]) * jc[:, :, p_sym + 1, p_tn1],
                axis=-1) * jnp.asarray(rot)
    want = np.asarray(jnp.asarray(rot) * jnp.exp(-1j * jnp.angle(z)))
    got = gfsk_engine.sync_pair_rotation(
        spec, torch.from_numpy(csym), torch.from_numpy(rot)).numpy()
    assert len(pairs) == 35
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.abs(got), 1.0, rtol=0, atol=1e-6)
    zero = gfsk_engine._multisym_llrs(
        spec, torch.from_numpy(csym[1, 3:4]), torch.from_numpy(got[1, 3:4]),
        torch.from_numpy(spec.bitmaps()))
    assert torch.count_nonzero(zero) == 0
